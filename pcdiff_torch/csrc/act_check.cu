// A check, not a kernel of the port's path: the epilogue activations of ln_dense_fwd.cuh and
// their derivatives with the fast division (DivFast, which K5's activations and K4's fp32
// derivatives use) against the same with __fdiv_rn (DivRn, which K3 uses and the plain
// version's IEEE division matches), bit for bit, over every finite fp32 input. Where DivFast
// reports its operands in range, the two must agree; chip_smoke.py runs it for the three
// activations that divide, and their derivatives, and fails on any mismatch.

#include <cuda_runtime.h>

#include "ln_dense_fwd.cuh"

namespace {

template <int ACT, bool GRAD>
__device__ __forceinline__ float act_or_grad(float v, bool& ok, bool fast) {
  if (fast)
    return GRAD ? pcdiff_ln::act_grad<ACT>(v, pcdiff_ln::DivFast{ok})
                : pcdiff_ln::apply_act<ACT>(v, pcdiff_ln::DivFast{ok});
  return GRAD ? pcdiff_ln::act_grad<ACT>(v, pcdiff_ln::DivRn())
              : pcdiff_ln::apply_act<ACT>(v, pcdiff_ln::DivRn());
}

template <int ACT, bool GRAD>
__global__ void act_check_kernel(unsigned long long* counts) {
  unsigned long long mismatches = 0, slow = 0;
  const unsigned long long step = (unsigned long long)gridDim.x * blockDim.x;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x;
       i < (1ull << 32); i += step) {
    const float v = __uint_as_float((unsigned)i);
    if (!isfinite(v)) continue;
    bool ok = true;
    const float ref = act_or_grad<ACT, GRAD>(v, ok, false);
    const float got = act_or_grad<ACT, GRAD>(v, ok, true);
    if (!ok)
      ++slow;
    else if (__float_as_uint(got) != __float_as_uint(ref))
      ++mismatches;
  }
  atomicAdd(&counts[0], mismatches);
  atomicAdd(&counts[1], slow);
}

template <bool GRAD>
int launch(int act, unsigned long long* counts, int blocks, cudaStream_t s) {
  switch (act) {
    case pcdiff_ln::ACT_GELU:
      act_check_kernel<pcdiff_ln::ACT_GELU, GRAD><<<blocks, 256, 0, s>>>(counts);
      break;
    case pcdiff_ln::ACT_GELU_TANH:
      act_check_kernel<pcdiff_ln::ACT_GELU_TANH, GRAD><<<blocks, 256, 0, s>>>(counts);
      break;
    case pcdiff_ln::ACT_QUICK_GELU:
      act_check_kernel<pcdiff_ln::ACT_QUICK_GELU, GRAD><<<blocks, 256, 0, s>>>(counts);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// counts: a device array of 2 zeroed uint64 (fast-path mismatches, inputs DivFast sends to
// __fdiv_rn). act: 1 gelu, 2 gelu_tanh, 3 quick_gelu; grad: 0 the activation, 1 its
// derivative. Launches on `stream`, no sync; returns the cudaError_t of the launch.
extern "C" int pcdiff_act_check(int act, int grad, unsigned long long* counts, int blocks,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return grad ? launch<true>(act, counts, blocks, s) : launch<false>(act, counts, blocks, s);
}
