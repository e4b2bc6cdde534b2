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
// bf16 inputs go to the tensor cores (WMMA, fp32 accumulation), fp32 inputs to fp32 FMA on
// the CUDA cores (no TF32).
//
// What bounds it on the H100: the same work as the multi-head kernel (two products 32 or 64
// deep and wide, a softmax over every score), plus Q K^T a second time: 64 queries x 64 keys
// per tile at D = 32 leave the products thin, so the softmax and the tile staging cost about
// as much as the tensor-core work. Device memory is not the limit.
// What the design does about it: the normalise-then-round order needs the final row max and
// sum before the first weight is rounded, and a row's scores over all keys (1024 x 4 bytes a
// query) do not fit in shared memory for a 64-query tile. So one block per (64 queries,
// b * h), four warps, sweeps the keys twice in tiles of 64 staged in shared memory: first
// Q K^T with an online row max and sum, then Q K^T again with the final statistics, the
// normalised weights rounded into shared memory and multiplied by the V tile. The output
// accumulators stay in registers across the second sweep (WMMA fragments for bf16, a 4 x
// D/8 tile a thread for fp32). Ragged edges are masked here: query rows past Nq are computed
// on zeros and not stored; keys past Nk are zero-filled and weigh 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;           // queries per block
constexpr int BK = 64;           // keys per K/V tile
constexpr int WARPS = BQ / 16;   // bf16: one warp per 16 query rows
constexpr int THREADS = WARPS * 32;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int heads, nq, nk;
  long long q_b, q_h, q_n, k_b, k_h, k_n, v_b, v_h, v_n, o_b, o_h, o_n;  // strides, elements
};

template <typename T, int D>
struct Cfg {
  static constexpr bool BF16 = std::is_same<T, bf16>::value;
  // Row pitches, padded against bank conflicts; with WMMA (bf16) 16-row and 16-column
  // offsets stay 32-byte aligned.
  static constexpr int LD = BF16 ? D + 8 : D + 1;      // Q, K, V tiles, in T
  static constexpr int LD_S = BF16 ? BK + 4 : BK + 1;  // fp32 scores (fp32: the weights too)
  static constexpr int LD_P = BK + 8;                  // bf16 weights (bf16 path)
  static constexpr int TILE_BYTES = (BQ * LD * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int S_BYTES = (BQ * LD_S * 4 + 127) / 128 * 128;
  static constexpr int P_BYTES = BF16 ? BQ * LD_P * 2 : 0;
  static constexpr int SMEM = 3 * TILE_BYTES + S_BYTES + P_BYTES;
};

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// rows [n0, n0 + 64) of one (b, h) panel into a [64, LD] tile; rows past n are zeros
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long stride, int n0,
                                          int n) {
  for (int i = threadIdx.x; i < BK * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = n0 + r;
    dst[r * LD + c] = row < n ? src[(long long)row * stride + c] : from_f32<T>(0.f);
  }
}

// S = Q K^T for the staged tiles into s (fp32, [64, LD_S]). bf16: warp w forms rows
// 16w..16w+15 from its Q fragments; fp32: thread (ty, tx) forms rows 8ty..8ty+7 at columns
// tx + 16j, FMA in the order of d.
template <typename T, int D>
__device__ __forceinline__ void scores(
    float* s, const T* sq, const T* sk,
    const wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>* qa) {
  using C = Cfg<T, D>;
  if constexpr (C::BF16) {
    const int warp = threadIdx.x / 32;
    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sk + n * 16 * C::LD + kk * 16, C::LD);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(s + warp * 16 * C::LD_S + n * 16, acc, C::LD_S,
                              wmma::mem_row_major);
    }
  } else {
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
}

// The scores' writers and the softmax's readers: a warp's own rows (bf16), any rows (fp32).
template <bool BF16>
__device__ __forceinline__ void scores_ready() {
  if constexpr (BF16) __syncwarp(); else __syncthreads();
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
head_split_attention_kernel(const Args a) {
  using C = Cfg<T, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = reinterpret_cast<T*>(smem);
  T* sk = reinterpret_cast<T*>(smem + C::TILE_BYTES);
  T* sv = reinterpret_cast<T*>(smem + 2 * C::TILE_BYTES);
  float* ss = reinterpret_cast<float*>(smem + 3 * C::TILE_BYTES);
  bf16* sp = reinterpret_cast<bf16*>(smem + 3 * C::TILE_BYTES + C::S_BYTES);

  const int bh = blockIdx.x;
  const int b = bh / a.heads, h = bh % a.heads;
  const int q0 = blockIdx.y * BQ;
  const int nq = a.nq, nk = a.nk;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const T* qb = static_cast<const T*>(a.q) + b * a.q_b + h * a.q_h;
  const T* kb = static_cast<const T*>(a.k) + b * a.k_b + h * a.k_h;
  const T* vb = static_cast<const T*>(a.v) + b * a.v_b + h * a.v_h;
  T* ob = static_cast<T*>(a.o) + b * a.o_b + h * a.o_h;

  load_tile<T, D, C::LD>(sq, qb, a.q_n, q0, nq);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
  if constexpr (C::BF16) {
    for (int kk = 0; kk < D / 16; ++kk)
      wmma::load_matrix_sync(qa[kk], reinterpret_cast<const bf16*>(sq) + warp * 16 * C::LD +
                             kk * 16, C::LD);
  }

  // The lane pair (2r, 2r + 1) of warp w owns row 16w + r of the tile: each lane half its
  // columns, both lanes the row's statistics.
  const int r_own = warp * 16 + lane / 2;
  const int half = lane % 2;
  const float* srow = ss + r_own * C::LD_S + half * (BK / 2);

  // sweep 1: the row max and the row sum of exp(S - max), online
  float m_run = -INFINITY, l_run = 0.f;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // every thread is done with the previous tile
    load_tile<T, D, C::LD>(sk, kb, a.k_n, k0, nk);
    __syncthreads();
    scores<T, D>(ss, sq, sk, qa);
    scores_ready<C::BF16>();
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

  // sweep 2: the normalised weights, rounded to v's dtype, times V
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> oacc[D / 16];
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(oacc[n], 0.f);
  constexpr int OJ = D / 8;  // fp32: thread (ty, tx) owns rows 4ty..4ty+3, columns tx + 8j
  float o32[4][OJ] = {};
  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();
    load_tile<T, D, C::LD>(sk, kb, a.k_n, k0, nk);
    load_tile<T, D, C::LD>(sv, vb, a.v_n, k0, nk);
    __syncthreads();
    scores<T, D>(ss, sq, sk, qa);
    scores_ready<C::BF16>();
    const int cbase = k0 + half * (BK / 2);
    if constexpr (C::BF16) {
      bf16* prow = sp + r_own * C::LD_P + half * (BK / 2);
      for (int c = 0; c < BK / 2; ++c)
        prow[c] = __float2bfloat16(cbase + c < nk ? expf(srow[c] - m_run) / l_run : 0.f);
      __syncwarp();
      for (int n = 0; n < D / 16; ++n) {
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
          wmma::load_matrix_sync(pf, sp + warp * 16 * C::LD_P + kk * 16, C::LD_P);
          wmma::load_matrix_sync(vf, reinterpret_cast<const bf16*>(sv) + kk * 16 * C::LD +
                                 n * 16, C::LD);
          wmma::mma_sync(oacc[n], pf, vf, oacc[n]);
        }
      }
    } else {
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
  }

  if constexpr (C::BF16) {
    // the warp's own rows of the score buffer hold its output tile for the cast
    float* so = ss + warp * 16 * C::LD_S;
    __syncwarp();
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(so + n * 16, oacc[n], C::LD_S, wmma::mem_row_major);
    __syncwarp();
    const int row = q0 + r_own;
    if (row < nq) {
      const float* orow = ss + r_own * C::LD_S + half * (D / 2);
      T* dst = ob + (long long)row * a.o_n + half * (D / 2);
      for (int c = 0; c < D / 2; ++c) dst[c] = from_f32<T>(orow[c]);
    }
  } else {
    const int tx = tid % 8, ty = tid / 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      if (row < nq) {
#pragma unroll
        for (int j = 0; j < OJ; ++j)
          ob[(long long)row * a.o_n + tx + 8 * j] = from_f32<T>(o32[i][j]);
      }
    }
  }
}

template <typename T, int D>
int launch(const Args& a, int batch, cudaStream_t stream) {
  constexpr int smem = Cfg<T, D>::SMEM;
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        head_split_attention_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const dim3 grid(batch * a.heads, (a.nq + BQ - 1) / BQ);
  head_split_attention_kernel<T, D><<<grid, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32), each with batch,
// head and row strides in elements and unit stride along D. head_dim is 32 or 64. Returns
// the cudaError_t of the launch (0 on success). Launches on `stream` and does not synchronise.
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
  if (head_dim == 32) return is_bf16 ? launch<bf16, 32>(a, batch, s) : launch<float, 32>(a, batch, s);
  if (head_dim == 64) return is_bf16 ? launch<bf16, 64>(a, batch, s) : launch<float, 64>(a, batch, s);
  return (int)cudaErrorInvalidValue;
}
