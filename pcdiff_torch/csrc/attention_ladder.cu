// The multi-head attention kernel cut off after one stage, for Hopper (sm_90a): a profiling
// ladder. q [B, Nq, H*D], k and v [B, Nk, H*D], o [B, Nq, H*D], bf16, row-major, D = 32.
//
// Replaces the TPU kernel scripts/attn_profile.py::_ladder_kernel (launched by its
// _make_pallas), the stage-by-stage ablation of pcdiff/ops/flash_attention.py::_mh_kernel.
// Each rung is the loop of K1 itself, attention_fwd.cuh (the FULL mode that
// attention_mh.cu launches), with the later stages removed at compile time, and writes
// what the TPU rung writes into each head's D columns:
//     qk      the first D key columns of S = Q K^T
//     qk_max  rowmax(S), broadcast
//     qk_exp  exp(S[:, :D] - rowmax(S)): the first tile's panel exp(S - m0), kept in
//             registers and scaled by exp(m0 - m_final) at the end
//     qk_sum  rowsum(exp(S - rowmax(S))), broadcast
//     nomax   (exp(S) V) / rowsum(exp(S)): the full kernel without the max and the rescales
// Every rung consumes all its scores, so no product is dead code: qk folds them into the
// row max (the statistic qk_max writes), qk_exp its exponentials into the row sum (the one
// qk_sum writes). So qk and qk_max do the same work, as do qk_exp and qk_sum; only nomax
// and K1 stage V. Every rung runs at K1's occupancy (below). The time between two rungs is
// the cost of the stage the later one adds.
//
// What bounds it on the H100, per rung: the products on the tensor cores, the exponentials
// on the SFUs (16 a clock per SM), the other softmax operations on the fp32 lanes, or q, k,
// v and o once through device memory (pcdiff_torch/scripts/attn_profile.py prints each).
// Its design is K1's, by construction: it is a measuring instrument for that kernel.

#include <cstdint>
#include <initializer_list>

#include "attention_fwd.cuh"

namespace {

using pcdiff_attn::bf16;
using pcdiff_attn::Layout;
using pcdiff_attn::Panel;

constexpr int D = 32;  // head dim, K1's

template <int RUNG>
__global__ void __launch_bounds__(pcdiff_attn::THREADS, 2)
attention_ladder_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        int nq, int nk, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long hd = (long long)heads * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qo = (long long)b * nq * hd + h * D, kv = (long long)b * nk * hd + h * D;
  const Panel<bf16> p{q + qo, k + kv, v + kv, o + qo, hd, hd, hd, hd,
                      nq, nk, (int)blockIdx.x * pcdiff_attn::BQ};
  pcdiff_attn::attention_block<RUNG, D>(p, smem);
}

// Every rung runs at K1's occupancy, two blocks a SM (K1's 106-110 registers a thread leave
// room for no third): a rung that needs fewer registers would fit three blocks and run its
// stages faster than K1 does. The shared-memory request pins it: three blocks' requests
// exceed the SM's 228 KB, two fit.
constexpr int PINNED_SMEM = 80 * 1024;
static_assert(Layout<D>::SMEM <= PINNED_SMEM && 3 * (PINNED_SMEM + 1024) > 228 * 1024 &&
              2 * (PINNED_SMEM + 1024) <= 228 * 1024, "two blocks a SM, not three");

template <int RUNG>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch, int nq, int nk,
           int heads, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_ladder_kernel<RUNG>, cudaFuncAttributeMaxDynamicSharedMemorySize, PINNED_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid((nq + pcdiff_attn::BQ - 1) / pcdiff_attn::BQ, heads, batch);
  attention_ladder_kernel<RUNG><<<grid, pcdiff_attn::THREADS, PINNED_SMEM, s>>>(
      q, k, v, o, nq, nk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 device pointers, 16-byte aligned. rung: 0 qk, 1 qk_max, 2 qk_exp,
// 3 qk_sum, 4 nomax. Requires nk >= head_dim (qk and qk_exp write the first D key columns).
// Returns the cudaError_t of the launch (0 on success). Launches on `stream` and does not
// synchronise.
extern "C" int pcdiff_attention_ladder(const void* q, const void* k, const void* v, void* o,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       int rung, void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk < D || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case 0: return launch<pcdiff_attn::QK>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case 1: return launch<pcdiff_attn::QK_MAX>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case 2: return launch<pcdiff_attn::QK_EXP>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case 3: return launch<pcdiff_attn::QK_SUM>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case 4: return launch<pcdiff_attn::NOMAX>(qp, kp, vp, op, batch, nq, nk, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
