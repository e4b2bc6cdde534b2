// Attention in the head-split layout, forward, for Hopper (sm_90a). q [B, H, Nq, D], k and v
// [B, H, Nk, D], o [B, H, Nq, D], each given by its batch, head and row strides in elements
// with the D elements of a row contiguous: the [B, N, H, D] buffer that the caller views as
// [B, H, N, D] (reshape, then transpose of the N and H axes) is read and written in place,
// with no copies.
//
// Replaces the TPU kernel pcdiff/ops/flash_attention.py::_attn_kernel (launched by
// _pallas_attention, reached through fused_attention: the model's attention_fn hook). For
// every (b, h) it computes
//     o = round_v(P / rowsum(P)) V,  P = exp(S - rowmax(S)),  S = Q K^T
// with q already scaled, in the TPU kernel's numerics: S in fp32; keys past Nk excluded from
// the max and the sum; the weights normalised by the fp32 row sum BEFORE the PV product and
// rounded to v's dtype; PV accumulated in fp32 and cast to q's dtype. Unlike the
// multi-head kernel (attention_mh.cu) nothing is rounded to bf16 that is not bf16 already:
// bf16 inputs go to the tensor cores (mma.sync, fp32 accumulation), fp32 inputs to fp32 FMA
// on the CUDA cores (no TF32).
//
// What bounds it on the H100: the multi-head kernel's work (two products 32 or 64 deep and
// wide, a softmax over every score) plus Q K^T and the exponentials a second time: the
// normalise-then-round order needs the final row max and sum before the first weight is
// rounded, and a row's scores over all keys do not fit on chip for a tile of queries, so the
// keys are swept twice. At D = 32 the exponentials on the SFUs are the floor, not the
// tensor cores; device memory is not the limit.
// What the design does about it:
//   bf16: attention_fwd.cuh's NORMALISED mode, the loop K1 runs: one block per (128
//     queries, b * h), 8 warps, K/V tiles of 64 keys in a cp.async ring, S, P and the output
//     in mma.sync fragments. The first sweep stages K alone and keeps the online row max and
//     sum; the second computes exp2(s log2e - (m log2e + log2 l)), one exponential and no
//     division a weight, rounds it to bf16 and multiplies by V.
//   fp32: one block per (64 queries, b * h), four warps, the same two sweeps over tiles of
//     64 staged in shared memory, 8 x 4 scores and a 4 x D/8 output tile a thread in FMA.
// Ragged edges: query rows past Nq are computed on zeros and not stored; keys past Nk are
// zero-filled and weigh 0.

#include <cstdint>
#include <initializer_list>

#include "attention_fwd.cuh"

namespace {

using pcdiff_attn::bf16;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, nq, nk;
  long long q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n, o_b, o_h, o_n;  // strides, elements
};

// ---- bf16: the shared loop ------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(pcdiff_attn::THREADS, D == 32 ? 2 : 1)
head_split_attention_bf16_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const pcdiff_attn::Panel<bf16> p{
      static_cast<const bf16*>(a.q) + b * a.q_b + h * a.q_h,
      static_cast<const bf16*>(a.k) + b * a.k_b + h * a.k_h,
      static_cast<const bf16*>(a.v) + b * a.v_b + h * a.v_h,
      static_cast<bf16*>(a.o) + b * a.o_b + h * a.o_h,
      a.q_n, a.k_n, a.v_n, a.o_n, a.nq, a.nk, (int)blockIdx.y * pcdiff_attn::BQ};
  pcdiff_attn::attention_block<pcdiff_attn::NORMALISED, D>(p, smem);
}

// ---- fp32: FMA on the CUDA cores ----------------------------------------------------------

constexpr int BQ = 64;           // queries per block
constexpr int BK = 64;           // keys per K/V tile
constexpr int THREADS = 128;

template <int D>
struct Cfg {
  // Row pitches, odd against bank conflicts.
  static constexpr int LD = D + 1;       // Q, K, V tiles
  static constexpr int LD_S = BK + 1;    // fp32 scores, then the weights
  static constexpr int TILE_BYTES = (BQ * LD * 4 + 127) / 128 * 128;
  static constexpr int S_BYTES = (BQ * LD_S * 4 + 127) / 128 * 128;
  static constexpr int SMEM = 3 * TILE_BYTES + S_BYTES;
};

// rows [n0, n0 + 64) of one (b, h) panel into a [64, LD] tile; rows past n are zeros
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src, long long stride,
                                          int n0, int n) {
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = n0 + r;
    dst[r * LD + c] = row < n ? src[(long long)row * stride + c] : 0.f;
  }
}

// S = Q K^T for the staged tiles into s ([64, LD_S]): thread (ty, tx) forms rows
// 8ty..8ty+7 at columns tx + 16j, FMA in the order of d.
template <int D>
__device__ __forceinline__ void scores(float* s, const float* sq, const float* sk) {
  using C = Cfg<D>;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][4] = {};
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float a[8], b[4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i] = sq[(ty * 8 + i) * C::LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = sk[(tx + 16 * j) * C::LD + d];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[(ty * 8 + i) * C::LD_S + tx + 16 * j] = acc[i][j];
}

template <int D>
__global__ void __launch_bounds__(THREADS)
head_split_attention_fp32_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sq = reinterpret_cast<float*>(smem);
  float* sk = reinterpret_cast<float*>(smem + C::TILE_BYTES);
  float* sv = reinterpret_cast<float*>(smem + 2 * C::TILE_BYTES);
  float* ss = reinterpret_cast<float*>(smem + 3 * C::TILE_BYTES);

  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * BQ;
  const int nq = a.nq, nk = a.nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const float* qb = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_b + h * a.k_h;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_b + h * a.v_h;
  float* ob = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;

  load_tile<D, C::LD>(sq, qb, a.q_n, q0, nq);
  __syncthreads();

  // The lane pair (2r, 2r + 1) of warp w owns row 16w + r of the tile: each lane half its
  // columns, both lanes the row's statistics.
  const int r_own = warp * 16 + lane / 2;
  const int half = lane % 2;
  const float* srow = ss + r_own * C::LD_S + half * (BK / 2);

  // sweep 1: the row max and the row sum of exp(S - max), online
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<D, C::LD>(sk, kb, a.k_n, k0, nk);
    __syncthreads();
    scores<D>(ss, sq, sk);
    __syncthreads();
    const int cbase = k0 + half * (BK / 2);
    float tmax = -INFINITY;
    for (int c = 0; c < BK / 2; ++c)
      if (cbase + c < nk) tmax = fmaxf(tmax, srow[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds at least one key
    float psum = 0.f;
    for (int c = 0; c < BK / 2; ++c)
      if (cbase + c < nk) psum += expf(srow[c] - m_new);
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * expf(m_run - m_new) + psum;  // the factor is 0 on the first tile
    m_run = m_new;
  }

  // sweep 2: the normalised weights times V
  constexpr int OJ = D / 8;  // thread (ty, tx) owns rows 4ty..4ty+3, columns tx + 8j
  float o32[4][OJ] = {};
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<D, C::LD>(sk, kb, a.k_n, k0, nk);
    load_tile<D, C::LD>(sv, vb, a.v_n, k0, nk);
    __syncthreads();
    scores<D>(ss, sq, sk);
    __syncthreads();
    const int cbase = k0 + half * (BK / 2);
    float* prow = ss + r_own * C::LD_S + half * (BK / 2);  // in place: fp32 weights
    for (int c = 0; c < BK / 2; ++c)
      prow[c] = cbase + c < nk ? expf(prow[c] - m_run) / l_run : 0.f;
    __syncthreads();
    const int tx = tid % 8, ty = tid / 8;
    for (int c = 0; c < BK; ++c) {
      float p[4], vv[OJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ss[(ty * 4 + i) * C::LD_S + c];
#pragma unroll
      for (int j = 0; j < OJ; ++j) vv[j] = sv[c * C::LD + tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < OJ; ++j) o32[i][j] = fmaf(p[i], vv[j], o32[i][j]);
    }
  }

  const int tx = tid % 8, ty = tid / 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row < nq) {
#pragma unroll
      for (int j = 0; j < OJ; ++j) ob[(long long)row * a.o_n + tx + 8 * j] = o32[i][j];
    }
  }
}

template <int D>
int launch_fp32(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Cfg<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_split_attention_fp32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(batch * a.heads, (a.nq + BQ - 1) / BQ);
  head_split_attention_fp32_kernel<D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_bf16(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = pcdiff_attn::Layout<D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_split_attention_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  // 16-byte copies of rows and bf16 pairs on output: every base and stride a multiple of 8
  for (const void* ptr : {a.q, a.k, a.v, static_cast<const void*>(a.o)})
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  for (long long st : {a.q_b, a.q_h, a.q_n, a.k_b, a.k_h, a.k_n, a.v_b, a.v_h, a.v_n, a.o_b,
                       a.o_h, a.o_n})
    if (st % 8) return (int)cudaErrorMisalignedAddress;
  const dim3 grid(batch * a.heads, (a.nq + pcdiff_attn::BQ - 1) / pcdiff_attn::BQ);
  head_split_attention_bf16_kernel<D><<<grid, pcdiff_attn::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32), each with batch,
// head and row strides in elements and unit stride along D (bf16: 16-byte aligned pointers
// and strides that are multiples of 8). head_dim is 32 or 64. Returns the cudaError_t of the
// launch (0 on success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int batch, int heads, int nq,
    int nk, int head_dim, int is_bf16, long long q_b, long long q_h, long long q_n,
    long long k_b, long long k_h, long long k_n, long long v_b, long long v_h, long long v_n,
    long long o_b, long long o_h, long long o_n, void* stream) {
  if (batch <= 0 || heads <= 0 || nq <= 0 || nk <= 0 ||
      (long long)batch * heads > 0x7fffffffLL || (nq + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, heads, nq, nk, q_b, q_h, q_n, k_b, k_h, k_n,
               v_b, v_h, v_n, o_b, o_h, o_n};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 32) return is_bf16 ? launch_bf16<32>(a, batch, s) : launch_fp32<32>(a, batch, s);
  if (head_dim == 64) return is_bf16 ? launch_bf16<64>(a, batch, s) : launch_fp32<64>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
