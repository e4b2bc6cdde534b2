// Fused multi-head attention, backward, for Hopper (sm_90a). Heads are folded in the feature
// axis: q and the output gradient g [B, Nq, H*D], k and v [B, Nk, H*D], all row-major; the
// gradients dq, dk, dv have the shapes and the dtype of q, k, v.
//
// Replaces the TPU kernel pcdiff/ops/flash_attention.py::_mh_bwd_kernel (launched by
// _pallas_attention_mh_bwd, the backward of fused_attention_mh). For every batch row b and
// head h, with S = Q_h K_h^T (q already scaled by 1/sqrt(D)):
//     P = exp(S - rowmax(S)) * (1 / rowsum(exp(S - rowmax(S))))      (fp32)
//     dv = P^T g_h,  dp = g_h V_h^T,  ds = P (dp - rowsum(dp P)),  dq = ds K_h,  dk = ds^T Q_h
// in the TPU kernel's numerics class: q, k, v and g rounded to bf16 (fp32 inputs too),
// every product accumulated in fp32, P and ds rounded to bf16 before their products, the
// outputs written in the input dtype. rowsum(dp P) is taken with the fp32 P, as the JAX
// kernel does; it is not FA2's rowsum(dO O), which differs here because the forward
// rounds the unnormalised P to bf16.
//
// What bounds it on the H100: about 10 Nq Nk D FLOPs per (row, head) in thin products
// (D = 32 deep or wide) on the tensor cores, beside an elementwise pass over every
// [Nq, Nk] panel that costs about as much; device memory is not the limit (each input is
// read by a few blocks, from L2 after the first).
// What the design does about it: the TPU kernel holds a row's whole K/V panel and every
// [Nq, Nk] fp32 panel in VMEM, which no 227 KB block can. Here two launches, both with
// deterministic sums and no atomics:
//   (a) dq: one block per (64 queries, head, row), four warps of 16 query rows. A first
//       sweep over the key tiles recomputes S and dp and keeps the running row max m, the
//       running sum l of exp(S - m) and the running sum of dp exp(S - m), rescaled as m
//       grows; D = that sum / l is rowsum(dp P). It writes (m, 1/l, D) per query row to a
//       small fp32 scratch buffer. A second sweep recomputes S and dp, forms P and ds and
//       accumulates dq = ds K in WMMA accumulator fragments.
//   (b) dk, dv: one block per (64 keys, head, row), four warps of 16 key rows. It sweeps
//       the query tiles, recomputes S^T and dp^T from its K and V, forms P^T and ds^T with
//       the saved (m, 1/l, D) of each query, and accumulates dv = P^T g and dk = ds^T q.
// All panels stay in shared memory, tiles of 64 x 64; the products run through WMMA (bf16
// in, fp32 accumulate). Ragged edges (643, 1025, 257, 255, 127 are multiples of no tile)
// are masked: keys past Nk are zero-filled and get P = 0, queries past Nq are zero-filled,
// get P = 0 and are not stored.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 32;          // head dim
constexpr int BT = 64;         // rows of the block's own tile (queries in (a), keys in (b))
constexpr int BS = 64;         // rows of a swept tile (keys in (a), queries in (b))
constexpr int WARPS = BT / 16;
constexpr int THREADS = WARPS * 32;
// Row pitches, padded against bank conflicts; 16-row and 16-column offsets stay 32-byte
// aligned as WMMA requires.
constexpr int LD_T = D + 8;    // bf16 [rows][D] tiles
constexpr int LD_F = BS + 4;   // fp32 [16][64] panels
constexpr int LD_H = BS + 8;   // bf16 [16][64] panels

constexpr int TILE_BYTES = BS * LD_T * 2;         // one bf16 [64][D] tile
constexpr int PANEL_F = WARPS * 16 * LD_F * 4;    // one fp32 [16][64] panel per warp
constexpr int PANEL_H = WARPS * 16 * LD_H * 2;    // one bf16 [16][64] panel per warp
// (a): K, V tiles; S, dp panels; ds panel. (b): Q, G tiles; S^T, dp^T; P^T, ds^T; stats.
constexpr int SMEM_A = 2 * TILE_BYTES + 2 * PANEL_F + PANEL_H;
constexpr int SMEM_B = 2 * TILE_BYTES + 2 * PANEL_F + 2 * PANEL_H + 3 * BS * 4;
static_assert(2 * BT * LD_T * 2 <= 2 * PANEL_F, "own-tile staging must fit in the panels");

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Stage rows [r0, r0 + n) of one head of src ([*, H*D] rows, pitch hd) as bf16 into dst
// ([n][LD_T]); rows at or past `limit` are zero.
template <typename T>
__device__ __forceinline__ void stage(bf16* dst, const T* src, int r0, int n, int limit,
                                      int hd) {
  const bf16 zero = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < n * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = r0 + r;
    dst[r * LD_T + c] = row < limit ? to_bf16(src[(size_t)row * hd + c]) : zero;
  }
}

// out[16][64] (fp32, pitch LD_F) = A[16][D] B^T, A as two fragments, B rows [64][D] (LD_T).
__device__ __forceinline__ void product_nt(float* out, const FragA (&a)[D / 16],
                                           const bf16* b) {
  for (int n = 0; n < BS / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < D / 16; ++kk) {
      FragBt bf;
      wmma::load_matrix_sync(bf, b + n * 16 * LD_T + kk * 16, LD_T);
      wmma::mma_sync(acc, a[kk], bf, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LD_F, wmma::mem_row_major);
  }
}

// acc[16][D] += A[16][64] (bf16, pitch LD_H) B[64][D] (bf16, pitch LD_T).
__device__ __forceinline__ void product_nn(FragC (&acc)[D / 16], const bf16* a,
                                           const bf16* b) {
  for (int kk = 0; kk < BS / 16; ++kk) {
    FragA af;
    wmma::load_matrix_sync(af, a + kk * 16, LD_H);
    for (int n = 0; n < D / 16; ++n) {
      FragB bf;
      wmma::load_matrix_sync(bf, b + kk * 16 * LD_T + n * 16, LD_T);
      wmma::mma_sync(acc[n], af, bf, acc[n]);
    }
  }
}

// Write a warp's [16][D] fp32 accumulator to rows [row0, row0 + 16) of dst (pitch hd), the
// rows below `limit`, through the scratch panel `tmp` (pitch LD_F).
template <typename T>
__device__ __forceinline__ void write_rows(T* dst, FragC (&acc)[D / 16], float* tmp,
                                           int row0, int limit, int hd) {
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(tmp + n * 16, acc[n], LD_F, wmma::mem_row_major);
  __syncwarp();
  const int lane = threadIdx.x % 32;
  const int r = lane / 2, half = lane % 2;
  if (row0 + r < limit) {
    T* out = dst + (size_t)(row0 + r) * hd + half * (D / 2);
    const float* src = tmp + r * LD_F + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) store_out(out + c, src[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_mh_bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dq,
                    float* __restrict__ stats, int nq, int nk, int heads, int batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  float* s_all = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);
  float* dp_all = reinterpret_cast<float*>(smem + 2 * TILE_BYTES + PANEL_F);
  bf16* ds_all = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES + 2 * PANEL_F);
  // the Q and G tiles are staged in the S/dp panels until their fragments are loaded
  bf16* sq = reinterpret_cast<bf16*>(s_all);
  bf16* sg = sq + BT * LD_T;

  const int hd = heads * D;
  const int q0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qoff = (size_t)b * nq * hd + h * D;
  const size_t koff = (size_t)b * nk * hd + h * D;

  stage(sq, q + qoff, q0, BT, nq, hd);
  stage(sg, g + qoff, q0, BT, nq, hd);
  __syncthreads();
  FragA qa[D / 16], ga[D / 16];
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(qa[kk], sq + warp * 16 * LD_T + kk * 16, LD_T);
    wmma::load_matrix_sync(ga[kk], sg + warp * 16 * LD_T + kk * 16, LD_T);
  }

  float* ss = s_all + warp * 16 * LD_F;
  float* sdp = dp_all + warp * 16 * LD_F;
  bf16* sds = ds_all + warp * 16 * LD_H;
  // The lane pair (2r, 2r + 1) owns row r of the warp's 16: each lane holds half its
  // columns, both lanes hold the row's statistics.
  const int r_own = lane / 2;
  const int half = lane % 2;
  float m_run = -INFINITY, l_run = 0.f, d_run = 0.f;

  // Sweep 1: row max, row sum and rowsum(dp exp(S - m)), online.
  for (int k0 = 0; k0 < nk; k0 += BS) {
    __syncthreads();  // every warp is done with the previous K/V tile (and with sq, sg)
    stage(sk, k + koff, k0, BS, nk, hd);
    stage(sv, v + koff, k0, BS, nk, hd);
    __syncthreads();
    product_nt(ss, qa, sk);
    product_nt(sdp, ga, sv);
    __syncwarp();
    const float* srow = ss + r_own * LD_F + half * (BS / 2);
    const float* dprow = sdp + r_own * LD_F + half * (BS / 2);
    const int cbase = k0 + half * (BS / 2);
    float tmax = -INFINITY;
    for (int c = 0; c < BS / 2; ++c)
      if (cbase + c < nk) tmax = fmaxf(tmax, srow[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds at least one key
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f, dsum = 0.f;
    for (int c = 0; c < BS / 2; ++c) {
      if (cbase + c < nk) {
        const float p = expf(srow[c] - m_new);
        psum += p;
        dsum += dprow[c] * p;
      }
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);
    l_run = l_run * alpha + psum;
    d_run = d_run * alpha + dsum;
    m_run = m_new;
    __syncwarp();
  }
  const float recip = 1.f / l_run;
  const float drow = d_run * recip;
  const int qrow = q0 + warp * 16 + r_own;
  if (half == 0 && qrow < nq) {
    const size_t plane = (size_t)batch * heads * nq;
    const size_t idx = ((size_t)b * heads + h) * nq + qrow;
    stats[idx] = m_run;
    stats[plane + idx] = recip;
    stats[2 * plane + idx] = drow;
  }

  // Sweep 2: ds = P (dp - D), dq += ds K.
  FragC acc[D / 16];
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.f);
  for (int k0 = 0; k0 < nk; k0 += BS) {
    __syncthreads();
    stage(sk, k + koff, k0, BS, nk, hd);
    stage(sv, v + koff, k0, BS, nk, hd);
    __syncthreads();
    product_nt(ss, qa, sk);
    product_nt(sdp, ga, sv);
    __syncwarp();
    const float* srow = ss + r_own * LD_F + half * (BS / 2);
    const float* dprow = sdp + r_own * LD_F + half * (BS / 2);
    bf16* dsrow = sds + r_own * LD_H + half * (BS / 2);
    const int cbase = k0 + half * (BS / 2);
    for (int c = 0; c < BS / 2; ++c) {
      const float p = cbase + c < nk ? expf(srow[c] - m_run) * recip : 0.f;
      dsrow[c] = __float2bfloat16(p * (dprow[c] - drow));
    }
    __syncwarp();
    product_nn(acc, sds, sk);
    __syncwarp();
  }
  write_rows(dq + qoff, acc, ss, q0 + warp * 16, nq, hd);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_mh_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ g, T* __restrict__ dk,
                      T* __restrict__ dv, const float* __restrict__ stats, int nq, int nk,
                      int heads, int batch) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = reinterpret_cast<bf16*>(smem + TILE_BYTES);
  float* st_all = reinterpret_cast<float*>(smem + 2 * TILE_BYTES);
  float* dpt_all = reinterpret_cast<float*>(smem + 2 * TILE_BYTES + PANEL_F);
  bf16* pt_all = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES + 2 * PANEL_F);
  bf16* dst_all = reinterpret_cast<bf16*>(smem + 2 * TILE_BYTES + 2 * PANEL_F + PANEL_H);
  float* sm = reinterpret_cast<float*>(smem + 2 * TILE_BYTES + 2 * PANEL_F + 2 * PANEL_H);
  float* srecip = sm + BS;
  float* sd = sm + 2 * BS;
  // the K and V tiles are staged in the S^T/dp^T panels until their fragments are loaded
  bf16* sk = reinterpret_cast<bf16*>(st_all);
  bf16* sv = sk + BT * LD_T;

  const int hd = heads * D;
  const int k0 = blockIdx.x * BT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t qoff = (size_t)b * nq * hd + h * D;
  const size_t koff = (size_t)b * nk * hd + h * D;
  const size_t plane = (size_t)batch * heads * nq;
  const float* st_m = stats + ((size_t)b * heads + h) * nq;

  stage(sk, k + koff, k0, BT, nk, hd);
  stage(sv, v + koff, k0, BT, nk, hd);
  __syncthreads();
  FragA ka[D / 16], va[D / 16];
  for (int kk = 0; kk < D / 16; ++kk) {
    wmma::load_matrix_sync(ka[kk], sk + warp * 16 * LD_T + kk * 16, LD_T);
    wmma::load_matrix_sync(va[kk], sv + warp * 16 * LD_T + kk * 16, LD_T);
  }

  float* sst = st_all + warp * 16 * LD_F;
  float* sdpt = dpt_all + warp * 16 * LD_F;
  bf16* spt = pt_all + warp * 16 * LD_H;
  bf16* sdst = dst_all + warp * 16 * LD_H;
  const int r_own = lane / 2;
  const int half = lane % 2;
  FragC acc_dv[D / 16], acc_dk[D / 16];
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dv[n], 0.f);
    wmma::fill_fragment(acc_dk[n], 0.f);
  }

  for (int q0 = 0; q0 < nq; q0 += BS) {
    __syncthreads();  // every warp is done with the previous Q/G tile (and with sk, sv)
    stage(sq, q + qoff, q0, BS, nq, hd);
    stage(sg, g + qoff, q0, BS, nq, hd);
    for (int i = threadIdx.x; i < BS; i += THREADS) {
      const bool ok = q0 + i < nq;
      sm[i] = ok ? st_m[q0 + i] : 0.f;
      srecip[i] = ok ? st_m[plane + q0 + i] : 0.f;
      sd[i] = ok ? st_m[2 * plane + q0 + i] : 0.f;
    }
    __syncthreads();
    product_nt(sst, ka, sq);   // S^T[key][query]
    product_nt(sdpt, va, sg);  // dp^T[key][query]
    __syncwarp();
    const float* srow = sst + r_own * LD_F + half * (BS / 2);
    const float* dprow = sdpt + r_own * LD_F + half * (BS / 2);
    bf16* prow = spt + r_own * LD_H + half * (BS / 2);
    bf16* dsrow = sdst + r_own * LD_H + half * (BS / 2);
    const int cb = half * (BS / 2);
    for (int c = 0; c < BS / 2; ++c) {
      const int j = cb + c;
      const float p = q0 + j < nq ? expf(srow[c] - sm[j]) * srecip[j] : 0.f;
      prow[c] = __float2bfloat16(p);
      dsrow[c] = __float2bfloat16(p * (dprow[c] - sd[j]));
    }
    __syncwarp();
    product_nn(acc_dv, spt, sg);
    product_nn(acc_dk, sdst, sq);
    __syncwarp();
  }
  write_rows(dv + koff, acc_dv, sst, k0 + warp * 16, nk, hd);
  __syncwarp();
  write_rows(dk + koff, acc_dk, sst, k0 + warp * 16, nk, hd);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* g, void* dq, void* dk,
           void* dv, float* stats, int batch, int nq, int nk, int heads, cudaStream_t s) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_mh_bwd_dq<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_A);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(attention_mh_bwd_dkdv<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tg = static_cast<const T*>(g);
  attention_mh_bwd_dq<T><<<dim3((nq + BT - 1) / BT, heads, batch), THREADS, SMEM_A, s>>>(
      tq, tk, tv, tg, static_cast<T*>(dq), stats, nq, nk, heads, batch);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_mh_bwd_dkdv<T><<<dim3((nk + BT - 1) / BT, heads, batch), THREADS, SMEM_B, s>>>(
      tq, tk, tv, tg, static_cast<T*>(dk), static_cast<T*>(dv), stats, nq, nk, heads, batch);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32);
// stats: fp32 scratch of 3 * batch * heads * nq floats. Returns the cudaError_t of the
// launches (0 on success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_mh_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv,
                                       void* stats, int batch, int nq, int nk, int heads,
                                       int head_dim, int is_bf16, void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* st = static_cast<float*>(stats);
  if (is_bf16) return launch<bf16>(q, k, v, g, dq, dk, dv, st, batch, nq, nk, heads, s);
  return launch<float>(q, k, v, g, dq, dk, dv, st, batch, nq, nk, heads, s);
}
