// Fused multi-head attention, forward, for Hopper (sm_90a). Heads are folded in the feature
// axis: q [B, Nq, H*D], k and v [B, Nk, H*D], o [B, Nq, H*D], all row-major.
//
// Replaces the TPU kernel pcdiff/ops/flash_attention.py::_mh_kernel (launched by
// _pallas_attention_mh, reached through fused_attention_mh). For every batch row b and
// head h it computes
//     o[b, :, hD:(h+1)D] = (P V_h) * (1 / rowsum(P)),  P = exp(S - rowmax(S)),  S = Q_h K_h^T
// with q already scaled by 1/sqrt(D), in the TPU kernel's numerics class: q, k and v are
// rounded to bf16 (fp32 inputs too), both products accumulate in fp32, the softmax runs in
// fp32, the unnormalised P is rounded to bf16 for the PV product, and the division by the
// fp32 row sum comes after PV.
//
// What bounds it on the H100: at D = 32 both products are thin (32 deep for Q K^T, 32 wide
// for P V), so the softmax, one exponential a score on the SFUs, is the floor, not the
// tensor cores. Device memory is not the limit: each block reads its query tile once and
// the K/V panel of its (row, head), which the other query tiles read again from L2.
// What the design does about it: the loop is attention_fwd.cuh's FULL mode (shared with
// the head-split kernel K7 and the profiling ladder K8): one block per (128 queries, head,
// batch row), 8 warps; K/V tiles of 64 keys in a 3-stage cp.async ring (fp32 inputs are
// rounded to bf16 through registers as they are staged); S, P and the output accumulator
// in mma.sync fragments, the online max and sum in registers, exp2 of log2e-scaled scores.
// Under the bf16 exp switch (bf16_exp = 1) each weight takes the TPU kernel's
// softmax_dtype=bfloat16 roundings against the final row max: t = bf16(s - m),
// p = bf16(exp2(t log2e)), the fp32 sum of the rounded p, PV and the division after it. A
// panel of at most EXP_MAX_KEYS keys (every panel of the sampler and the train step) runs
// it in one pass (attention_fwd.cuh's exp_block): one block of up to 16 warps a (batch
// row, head) panel, K and V resident in shared memory, row groups of warps splitting the
// keys, each warp holding its scores in registers, the final max and the partial outputs
// traded in shared memory. The wrapper plans (splits, slice) and this entry checks the
// plan. A longer panel (splits = 0) keeps the loop's two-sweep BF16_EXP mode: a first sweep
// over K for the final max, then the second, at the cost of a second pass of Q K^T.
// The TPU kernel's design of one whole K/V panel per batch row, sized for 128 MB of VMEM,
// is carried over only by the one-pass mode, whose panels fit the SM's shared memory.
// Ragged edges (643, 1025, 257, 255, 127 are multiples of no tile) are masked in the loop.
//
// Head dim 32 (the flagship's 256 / 8) only: head dim 64 (Point-E's and CLIP's: 512 / 8,
// 256 / 4, 1024 / 16, 768 / 12) is attention_mh64.cu's, both modes. The loop streams K and V,
// so a panel's length has no limit here (the TPU kernel holds the whole panel in VMEM).

#include <cstdint>
#include <initializer_list>

#include "attention_fwd.cuh"

namespace {

using pcdiff_attn::bf16;
using pcdiff_attn::EXP_MAX_KEYS;
using pcdiff_attn::EXP_SLICE;
using pcdiff_attn::EXP_WARPS;
using pcdiff_attn::ExpLayout;
using pcdiff_attn::Layout;
using pcdiff_attn::Panel;

constexpr int D = 32;  // the head dim

template <int MODE, typename T>
__global__ void __launch_bounds__(pcdiff_attn::THREADS, 2)
attention_mh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    int nq, int nk, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long hd = (long long)heads * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qo = (long long)b * nq * hd + h * D, kv = (long long)b * nk * hd + h * D;
  const Panel<T> p{q + qo, k + kv, v + kv, o + qo, hd, hd, hd, hd,
                   nq, nk, (int)blockIdx.x * pcdiff_attn::BQ};
  pcdiff_attn::attention_block<MODE, D>(p, smem);
}

template <int MODE, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int batch, int nq, int nk,
           int heads, cudaStream_t s) {
  constexpr int smem = Layout<D>::SMEM;
  static_assert(smem <= 48 * 1024, "the loop's shared memory needs no attribute at D = 32");
  const dim3 grid((nq + pcdiff_attn::BQ - 1) / pcdiff_attn::BQ, heads, batch);
  attention_mh_kernel<MODE, T><<<grid, pcdiff_attn::THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nq, nk, heads);
  return (int)cudaGetLastError();
}

// The bf16 exp mode in one pass: one block a (batch row, head) panel.
template <typename T>
__global__ void __launch_bounds__(pcdiff_attn::EXP_THREADS, 1)
attention_mh_exp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        int nq, int nk, int heads, int splits, int slice) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long hd = (long long)heads * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qo = (long long)b * nq * hd + h * D, kv = (long long)b * nk * hd + h * D;
  const Panel<T> p{q + qo, k + kv, v + kv, o + qo, hd, hd, hd, hd, nq, nk, 0};
  pcdiff_attn::exp_block<D>(p, splits, slice, smem);
}

template <typename T>
int launch_exp(const void* q, const void* k, const void* v, void* o, int batch, int nq,
               int nk, int heads, int splits, int slice, cudaStream_t s) {
  static bool configured = false;  // dynamic shared memory above 48 KB needs the attribute
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(attention_mh_exp_kernel<T>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               pcdiff_attn::EXP_MAX_SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int groups = pcdiff_attn::exp_groups(splits, nq), warps = splits * groups;
  const dim3 grid(1, heads, batch);
  attention_mh_exp_kernel<T><<<grid, 32 * warps, ExpLayout<D>::smem(nk, warps, groups), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), nq, nk, heads, splits, slice);
  return (int)cudaGetLastError();
}

// The one-pass mode's plan: row groups of `splits` warps (1 to EXP_WARPS) of `slice` keys
// each (a multiple of 16, at most EXP_SLICE), the last one the rest, none of them empty, in
// a panel of at most EXP_MAX_KEYS keys.
bool valid_plan(int nk, int splits, int slice) {
  return splits >= 1 && splits <= EXP_WARPS && slice >= 16 && slice % 16 == 0 &&
         slice <= EXP_SLICE && nk <= EXP_MAX_KEYS && (long long)(splits - 1) * slice < nk &&
         nk <= (long long)splits * slice;
}

}  // namespace

// q, k, v, o: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32), 16-byte aligned;
// head_dim is 32 (64 is attention_mh64.cu's); bf16_exp = 1 selects the bf16 exp mode, in one
// pass with `splits` warps of `slice` keys (the wrapper's plan, refused unless it covers nk
// with no slice empty), or with splits = 0 in two sweeps; the default mode takes
// splits = slice = 0. Returns the cudaError_t of the launch (0 on success). Launches on
// `stream` and does not synchronise.
extern "C" int pcdiff_attention_mh_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       int is_bf16, int bf16_exp, int splits, int slice,
                                       void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  if ((splits || slice) && !(bf16_exp && valid_plan(nk, splits, slice)))
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o)})
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16_exp && splits)
    return is_bf16 ? launch_exp<bf16>(q, k, v, o, batch, nq, nk, heads, splits, slice, s)
                   : launch_exp<float>(q, k, v, o, batch, nq, nk, heads, splits, slice, s);
  constexpr int FULL = pcdiff_attn::FULL, EXP = pcdiff_attn::BF16_EXP;
  if (bf16_exp)
    return is_bf16 ? launch<EXP, bf16>(q, k, v, o, batch, nq, nk, heads, s)
                   : launch<EXP, float>(q, k, v, o, batch, nq, nk, heads, s);
  return is_bf16 ? launch<FULL, bf16>(q, k, v, o, batch, nq, nk, heads, s)
                 : launch<FULL, float>(q, k, v, o, batch, nq, nk, heads, s);
}
