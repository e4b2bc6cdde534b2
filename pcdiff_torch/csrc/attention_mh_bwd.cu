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
// (D = 32 deep or wide) on the tensor cores, beside an elementwise pass over every score
// (an exponential on the SFUs, a handful of fp32 operations) that costs more at D = 32;
// device memory is not the limit (each input is read by a few blocks, from L2 after the
// first).
// What the design does about it: it runs on the idioms of the forward loop
// (attention_fwd.cuh, whose staging it shares): S, dp, P and ds live in mma.sync C
// fragments and never touch shared memory; P and ds are rounded in place into bf16 A
// fragments (two n8 C tiles are one k16 A tile); the swept tiles come through a 3-stage
// cp.async ring; exponentials are one FFMA and one ex2.approx of log2e-scaled scores. fp32
// inputs are first rounded to bf16 copies in the scratch by a streaming launch, so that
// every tile is staged asynchronously (rounded through registers as they are staged, as the
// forward does, they cost the train step's shapes 12% more than that extra pass on an H100,
// by chip_smoke.py's K2 times). Two
// launches, 8 warps of 16 rows a block, every sum in a fixed order and no atomics:
//   (a) statistics and dq: one block per (128 queries, head, row); Q's and G's A fragments
//       are loaded once (ldmatrix). Sweep 1 over 64-key K/V tiles computes S = Q K^T and
//       dp = G V^T and keeps, per query row, the online max m, the sum l of exp(S - m) and
//       the sum of dp exp(S - m), rescaled as m grows, across the quad by shuffles; it
//       writes (m log2e, 1/l, D = that sum / l = rowsum(dp P)) per query row to the fp32
//       scratch `stats`, one 16-byte record a row. Sweep 2 recomputes S and dp per 16-key
//       chunk, forms P = exp2(s log2e - m log2e) (1/l) and ds = P (dp - D) in registers,
//       and accumulates dq += ds K with K's B fragments by ldmatrix.trans.
//   (b) dk and dv: one block per (128 keys, head, row); K's and V's A fragments are loaded
//       once. It sweeps 64-query Q/G tiles, each with its 64 stats records (cp.async into
//       the same ring stage), and per 16-query chunk computes S^T = K Q^T and dp^T = V G^T,
//       P^T and ds^T with each column's record, and accumulates dv += P^T G and
//       dk += ds^T Q with G's and Q's B fragments by ldmatrix.trans.
// Ragged edges (643, 1025, 257, 255, 127 are multiples of no tile): keys past Nk are
// zero-filled and their scores set to -inf, so P = 0 there; queries past Nq are zero-filled,
// their records zero (1/l = 0, so P = 0), and their rows are not stored; a warp whose 16
// rows all lie past the end skips the arithmetic.

#include <cstdint>
#include <initializer_list>

#include "attention_fwd.cuh"

namespace {

using namespace pcdiff_ptx;  // cp.async, ldmatrix, mma.sync, ex2, bf16 packing
using pcdiff_attn::LOG2E;
using pcdiff_attn::row_sum;
using pcdiff_attn::stage_rows;
using pcdiff_attn::store_pair;

constexpr int D = 32;                               // head dim
constexpr int LD = pcdiff_attn::Layout<D>::LD;      // bf16 row pitch of every tile
constexpr int BT = 128;                             // rows of the block's own tile
constexpr int BS = pcdiff_attn::BK;                 // rows of a swept tile (64)
constexpr int WARPS = BT / 16;                      // one warp per 16 own rows
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;                           // swept tiles in the ring
constexpr int OWN = BT * LD;                        // elements of an own tile
constexpr int TILE = BS * LD;                       // elements of a swept tile
static_assert(THREADS == pcdiff_attn::THREADS, "stage_rows strides by the loop's threads");
// (a): the Q and G tiles, then a ring of K/V tile pairs
constexpr int SMEM_A = (2 * OWN + STAGES * 2 * TILE) * 2;
// (b): the K and V tiles, then a ring of Q/G tile pairs, each with its 64 stats records
constexpr int STAGE_B = 2 * TILE * 2 + BS * 16;     // bytes
constexpr int SMEM_B = 2 * OWN * 2 + STAGES * STAGE_B;

// One sweep over `ntiles` tiles through the ring: load(t, stage) issues tile t's copies,
// body(t, stage) computes on it once they have landed. The caller has issued its own
// tiles' copies as an older group; `ready` loads their fragments once that group has
// landed (the same schedule as attention_fwd.cuh's sweep).
template <typename Load, typename Ready, typename Body>
__device__ __forceinline__ void ring_sweep(int ntiles, Load load, Ready ready, Body body) {
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load(t, t);
    cp_async_commit();  // one group a tile, empty past the end, so the counts stay uniform
  }
  ready();
  int stage = 0;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();  // this thread's copies of tile t have landed
    __syncthreads();              // everyone's have, and everyone is done with tile t - 1
    const int tn = t + STAGES - 1;
    if (tn < ntiles) load(tn, stage == 0 ? STAGES - 1 : stage - 1);
    cp_async_commit();
    body(t, stage);
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next sweep
}

// The warp's A fragments of its 16 rows of an own tile ([BT][LD]), for k = 0..15, 16..31.
__device__ __forceinline__ void load_a(unsigned (&a)[D / 16][4], const bf16* tile) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // ldmatrix.x4 lane addresses: rows (lane & 15), columns 16kc + 8 (lane / 16)
  const bf16* p = tile + (16 * warp + (lane & 15)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) ldmatrix_x4(a[kc], p + 16 * kc);
}

// c = A B^T for the warp's 16 rows against rows 16ch .. 16ch + 15 of a swept tile
// ([BS][LD]): two n8 C tiles, columns 16ch + 8j + 2 (lane % 4) + {0, 1} in tile j.
__device__ __forceinline__ void chunk_nt(float (&c)[2][4], const unsigned (&a)[D / 16][4],
                                         const bf16* tile, int ch) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < 2; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
  // ldmatrix.x4 lane addresses: rows 16ch + (lane & 7) + 8 (lane / 16), columns
  // 16kc + 8 ((lane / 8) & 1); matrices 0/1 are tile 0's B fragment, 2/3 tile 1's
  const bf16* p = tile + (16 * ch + (lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    unsigned b[4];
    ldmatrix_x4(b, p + 16 * kc);
    mma_bf16(c[0], a[kc], b[0], b[1]);
    mma_bf16(c[1], a[kc], b[2], b[3]);
  }
}

// acc += X B for the warp's 16 rows: X the 16 x 16 chunk ch of a C-fragment panel (x, two
// n8 tiles) rounded to bf16 in place into an A fragment, B rows 16ch .. 16ch + 15 of a swept
// tile ([BS][LD]) by ldmatrix.trans.
__device__ __forceinline__ void chunk_nn(float (&acc)[D / 8][4], const float (&x)[2][4],
                                         const bf16* tile, int ch) {
  const int lane = threadIdx.x % 32;
  const unsigned a[4] = {pack_bf16(x[0][0], x[0][1]), pack_bf16(x[0][2], x[0][3]),
                         pack_bf16(x[1][0], x[1][1]), pack_bf16(x[1][2], x[1][3])};
  // ldmatrix.x4.trans lane addresses: rows 16ch + (lane & 7) + 8 ((lane / 8) & 1), columns
  // 16dp + 8 (lane / 16); matrices 0/1 are d tile 2dp's B fragment, 2/3 tile 2dp + 1's
  const bf16* p = tile + (16 * ch + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    unsigned b[4];
    ldmatrix_x4_trans(b, p + 16 * dp);
    mma_bf16(acc[2 * dp], a, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
  }
}

// Rows row0 + lane / 4 (+ 8) of a warp's [16][D] accumulator to dst (row stride hd), the
// rows below n.
template <typename T>
__device__ __forceinline__ void store_rows(T* dst, const float (&acc)[D / 8][4], int row0,
                                           int n, long long hd) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + (lane >> 2) + 8 * r;
    if (row < n) {
      T* d = dst + (long long)row * hd + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) store_pair(d + 8 * j, acc[j][2 * r], acc[j][2 * r + 1]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attention_mh_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                           const bf16* __restrict__ v, const bf16* __restrict__ g,
                           T* __restrict__ dq, float4* __restrict__ stats, int nq, int nk,
                           int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* sg = sq + OWN;
  bf16* ring = sg + OWN;
  const long long hd = (long long)heads * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BT;
  const long long qo = (long long)b * nq * hd + h * D, ko = (long long)b * nk * hd + h * D;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  const int row0 = q0 + 16 * warp;  // the warp's first query row
  const bool active = row0 < nq;
  const int ntiles = (nk + BS - 1) / BS;

  stage_rows<BT, D>(sq, q + qo, hd, q0, nq);
  stage_rows<BT, D>(sg, g + qo, hd, q0, nq);
  cp_async_commit();
  unsigned qf[D / 16][4], gf[D / 16][4];
  auto ready = [&] {
    cp_async_wait<STAGES - 1>();  // the Q/G group, older than the ring's first groups
    __syncthreads();
    load_a(qf, sq);
    load_a(gf, sg);
  };
  auto load = [&](int t, int stage) {
    bf16* sk = ring + stage * 2 * TILE;
    stage_rows<BS, D>(sk, k + ko, hd, t * BS, nk);
    stage_rows<BS, D>(sk + TILE, v + ko, hd, t * BS, nk);
  };
  // keys past nk weigh nothing: their scores are -inf
  auto mask = [&](float (&s)[2][4], int key0) {
    if (key0 + 16 > nk) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (key0 + 8 * j + 2 * tig + (e & 1) >= nk) s[j][e] = -INFINITY;
    }
  };

  // Sweep 1: per query row the online max m, sum l of exp(s - m) and sum of dp exp(s - m),
  // each lane over its own columns (the max across the quad).
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};
  ring_sweep(ntiles, load, ready, [&](int t, int stage) {
    if (!active) return;
    const bf16* sk = ring + stage * 2 * TILE;
    float s[BS / 16][2][4];
#pragma unroll
    for (int ch = 0; ch < BS / 16; ++ch) {
      chunk_nt(s[ch], qf, sk, ch);
      mask(s[ch], t * BS + 16 * ch);
    }
    float off[2], alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = -INFINITY;
#pragma unroll
      for (int ch = 0; ch < BS / 16; ++ch)
#pragma unroll
        for (int j = 0; j < 2; ++j) x = fmaxf(x, fmaxf(s[ch][j][2 * r], s[ch][j][2 * r + 1]));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      const float m_new = fmaxf(m[r], x);  // finite: every tile holds at least one key
      alpha[r] = ex2((m[r] - m_new) * LOG2E);  // 0 on the first tile
      off[r] = m_new * LOG2E;
      m[r] = m_new;
    }
    float ps[2] = {0.f, 0.f}, ds[2] = {0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < BS / 16; ++ch) {
      float dp[2][4];
      chunk_nt(dp, gf, sk + TILE, ch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(fmaf(s[ch][j][e], LOG2E, -off[e >> 1]));
          ps[e >> 1] += p;
          ds[e >> 1] = fmaf(dp[j][e], p, ds[e >> 1]);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + ps[r];
      dl[r] = dl[r] * alpha[r] + ds[r];
    }
  });

  // The rows' records: (m log2e, 1/l, rowsum(dp P)).
  float ml[2], recip[2], drow[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    recip[r] = 1.f / row_sum(l[r]);
    drow[r] = row_sum(dl[r]) * recip[r];
    ml[r] = m[r] * LOG2E;
    const int row = row0 + (lane >> 2) + 8 * r;
    if (active && tig == 0 && row < nq)
      stats[((long long)b * heads + h) * nq + row] = make_float4(ml[r], recip[r], drow[r], 0.f);
  }

  // Sweep 2: per 16-key chunk S and dp again, P and ds = P (dp - D) in registers,
  // dq += ds K.
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  ring_sweep(ntiles, load, [] {}, [&](int t, int stage) {
    if (!active) return;
    const bf16* sk = ring + stage * 2 * TILE;
#pragma unroll
    for (int ch = 0; ch < BS / 16; ++ch) {
      float s[2][4], dp[2][4];
      chunk_nt(s, qf, sk, ch);
      chunk_nt(dp, gf, sk + TILE, ch);
      mask(s, t * BS + 16 * ch);
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p = ex2(fmaf(s[j][e], LOG2E, -ml[r])) * recip[r];
          s[j][e] = p * (dp[j][e] - drow[r]);
        }
      chunk_nn(acc, s, sk, ch);
    }
  });
  if (active) store_rows(dq + qo, acc, row0, nq, hd);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
attention_mh_bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                             const bf16* __restrict__ v, const bf16* __restrict__ g,
                             T* __restrict__ dk, T* __restrict__ dv,
                             const float4* __restrict__ stats, int nq, int nk, int heads) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + OWN;
  unsigned char* ring = smem + 2 * OWN * 2;
  const long long hd = (long long)heads * D;
  const int h = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * BT;
  const long long qo = (long long)b * nq * hd + h * D, ko = (long long)b * nk * hd + h * D;
  const float4* st = stats + ((long long)b * heads + h) * nq;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  const int row0 = k0 + 16 * warp;  // the warp's first key row
  const bool active = row0 < nk;

  stage_rows<BT, D>(sk, k + ko, hd, k0, nk);
  stage_rows<BT, D>(sv, v + ko, hd, k0, nk);
  cp_async_commit();
  unsigned kf[D / 16][4], vf[D / 16][4];
  auto ready = [&] {
    cp_async_wait<STAGES - 1>();  // the K/V group, older than the ring's first groups
    __syncthreads();
    load_a(kf, sk);
    load_a(vf, sv);
  };
  auto load = [&](int t, int stage) {
    bf16* sq = reinterpret_cast<bf16*>(ring + stage * STAGE_B);
    stage_rows<BS, D>(sq, q + qo, hd, t * BS, nq);
    stage_rows<BS, D>(sq + TILE, g + qo, hd, t * BS, nq);
    if (threadIdx.x < BS) {  // the tile's records; zeros past nq, so P = 0 there
      const int row = t * BS + threadIdx.x;
      const bool ok = row < nq;
      float4* dst = reinterpret_cast<float4*>(sq + 2 * TILE) + threadIdx.x;
      cp_async_16(dst, st + (ok ? row : 0), ok ? 16 : 0);
    }
  };

  float acc_dv[D / 8][4], acc_dk[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dv[j][e] = acc_dk[j][e] = 0.f;
  ring_sweep((nq + BS - 1) / BS, load, ready, [&](int, int stage) {
    if (!active) return;
    const bf16* sq = reinterpret_cast<const bf16*>(ring + stage * STAGE_B);
    const bf16* sg = sq + TILE;
    const float4* rec = reinterpret_cast<const float4*>(sq + 2 * TILE);
#pragma unroll 1  // unrolled, it sits at the 128-register cap and runs no faster
    for (int ch = 0; ch < BS / 16; ++ch) {
      float s[2][4], dp[2][4];
      chunk_nt(s, kf, sq, ch);   // S^T[key][query]
      chunk_nt(dp, vf, sg, ch);  // dp^T[key][query]
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {  // the column's record: (m log2e, 1/l, D)
          const float4 x = rec[16 * ch + 8 * j + 2 * tig + c];
#pragma unroll
          for (int e = c; e < 4; e += 2) {
            const float p = ex2(fmaf(s[j][e], LOG2E, -x.x)) * x.y;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - x.z);
          }
        }
      chunk_nn(acc_dv, s, sg, ch);   // dv += P^T G
      chunk_nn(acc_dk, dp, sq, ch);  // dk += ds^T Q
    }
  });
  if (active) {
    store_rows(dv + ko, acc_dv, row0, nk, hd);
    store_rows(dk + ko, acc_dk, row0, nk, hd);
  }
}

// fp32 inputs: dst[i] = bf16(src[i]) for four arrays of n[i] elements (multiples of 8), 16
// bytes a store, so that both launches stage every tile by cp.async. A grid-stride loop over
// ROUND_BLOCKS blocks of 256 threads, about one wave of the card (on the H100 it ran faster
// than one chunk a thread over a grid sized to the arrays).
constexpr int ROUND_BLOCKS = 1024;
struct Copies {
  const float* src[4];
  bf16* dst[4];
  long long n[4];
};

__global__ void __launch_bounds__(256) round_to_bf16_kernel(const Copies c) {
  const long long step = (long long)gridDim.x * blockDim.x;
#pragma unroll 1
  for (int a = 0; a < 4; ++a) {
    const float4* src = reinterpret_cast<const float4*>(c.src[a]);
    uint4* dst = reinterpret_cast<uint4*>(c.dst[a]);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < c.n[a] / 8;
         i += step) {
      const float4 x = src[2 * i], y = src[2 * i + 1];
      dst[i] = make_uint4(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w), pack_bf16(y.x, y.y),
                          pack_bf16(y.z, y.w));
    }
  }
}

template <typename T>
int launch(const bf16* q, const bf16* k, const bf16* v, const bf16* g, void* dq, void* dk,
           void* dv, float4* stats, int batch, int nq, int nk, int heads, cudaStream_t s) {
  static bool configured = false;  // both kernels take more than the default 48 KB
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(attention_mh_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_A);
    if (e != cudaSuccess) return (int)e;
    e = cudaFuncSetAttribute(attention_mh_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_B);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  attention_mh_bwd_dq_kernel<T><<<dim3((nq + BT - 1) / BT, heads, batch), THREADS, SMEM_A, s>>>(
      q, k, v, g, static_cast<T*>(dq), stats, nq, nk, heads);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  attention_mh_bwd_dkdv_kernel<T>
      <<<dim3((nk + BT - 1) / BT, heads, batch), THREADS, SMEM_B, s>>>(
          q, k, v, g, static_cast<T*>(dk), static_cast<T*>(dv), stats, nq, nk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, g, dq, dk, dv: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32),
// 16-byte aligned; stats: 16-byte aligned scratch of 4 * batch * heads * nq floats (one
// record a query row), and for fp32 inputs batch * (nq + nk) * heads * head_dim floats more
// (the bf16 copies of q, g, k and v). Returns the cudaError_t of the launches (0 on
// success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_mh_bwd(const void* q, const void* k, const void* v,
                                       const void* g, void* dq, void* dk, void* dv,
                                       void* stats, int batch, int nq, int nk, int heads,
                                       int head_dim, int is_bf16, void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, g, static_cast<const void*>(dq),
                          static_cast<const void*>(dk), static_cast<const void*>(dv),
                          static_cast<const void*>(stats)})
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float4* st = static_cast<float4*>(stats);
  if (is_bf16)
    return launch<bf16>(static_cast<const bf16*>(q), static_cast<const bf16*>(k),
                        static_cast<const bf16*>(v), static_cast<const bf16*>(g), dq, dk, dv,
                        st, batch, nq, nk, heads, s);
  const long long nq_el = (long long)batch * nq * heads * D;
  const long long nk_el = (long long)batch * nk * heads * D;
  bf16* qc = reinterpret_cast<bf16*>(st + (long long)batch * heads * nq);
  bf16* gc = qc + nq_el;
  bf16* kc = gc + nq_el;
  bf16* vc = kc + nk_el;
  const Copies c{{static_cast<const float*>(q), static_cast<const float*>(g),
                  static_cast<const float*>(k), static_cast<const float*>(v)},
                 {qc, gc, kc, vc},
                 {nq_el, nq_el, nk_el, nk_el}};
  round_to_bf16_kernel<<<ROUND_BLOCKS, 256, 0, s>>>(c);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return launch<float>(qc, kc, vc, gc, dq, dk, dv, st, batch, nq, nk, heads, s);
}
