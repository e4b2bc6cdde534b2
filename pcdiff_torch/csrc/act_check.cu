// A check, not a kernel of the port's path: the epilogue activations of ln_dense_fwd.cuh with
// the fast division (DivFast, which K5 uses) against the same activations with __fdiv_rn
// (DivRn, which K3 uses and the plain version's IEEE division matches), bit for bit, over
// every finite fp32 input. Where DivFast reports its operands in range, the two must agree;
// chip_smoke.py runs it for the three activations that divide and fails on any mismatch.

#include <cuda_runtime.h>

#include "ln_dense_fwd.cuh"

namespace {

template <int ACT>
__global__ void act_check_kernel(unsigned long long* counts) {
  unsigned long long mismatches = 0, slow = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float v = __uint_as_float((unsigned)i);
    if (!isfinite(v)) continue;
    const float ref = pcdiff_ln::apply_act<ACT>(v, pcdiff_ln::DivRn());
    bool ok = true;
    const float got = pcdiff_ln::apply_act<ACT>(v, pcdiff_ln::DivFast{ok});
    if (!ok)
      ++slow;
    else if (__float_as_uint(got) != __float_as_uint(ref))
      ++mismatches;
  }
  atomicAdd(&counts[0], mismatches);
  atomicAdd(&counts[1], slow);
}

}  // namespace

// counts: a device array of 2 zeroed uint64 (fast-path mismatches, inputs DivFast sends to
// __fdiv_rn). act: 1 gelu, 2 gelu_tanh, 3 quick_gelu. Launches on `stream`, no sync; returns
// the cudaError_t of the launch.
extern "C" int pcdiff_act_check(int act, unsigned long long* counts, int blocks, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (act) {
    case pcdiff_ln::ACT_GELU:
      act_check_kernel<pcdiff_ln::ACT_GELU><<<blocks, 256, 0, s>>>(counts);
      break;
    case pcdiff_ln::ACT_GELU_TANH:
      act_check_kernel<pcdiff_ln::ACT_GELU_TANH><<<blocks, 256, 0, s>>>(counts);
      break;
    case pcdiff_ln::ACT_QUICK_GELU:
      act_check_kernel<pcdiff_ln::ACT_QUICK_GELU><<<blocks, 256, 0, s>>>(counts);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
