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
// bf16 inputs go to the tensor cores as they are (mma.sync, fp32 accumulation), fp32 inputs
// as 3xTF32 (each operand split into two TF32 parts, three products), about fp32's accuracy.
//
// What bounds it on the H100: the two products 32 or 64 deep and wide, and a softmax over
// every score (at D = 32 one exponential a score on the SFUs weighs as much as the bf16
// products); device memory is not the limit.
//   bf16: the normalise-then-round order needs the final row max and sum before the first
//     weight is rounded, and a row's scores over all keys do not fit on chip for a tile of
//     queries, so the keys are swept twice: Q K^T and the exponentials a second time.
//   fp32: the rounding to v's dtype does nothing, so normalising before PV or after it
//     differs only in the fp32 order, and one sweep with an online max and sum suffices.
//     Each product is three TF32 tensor-core products (lo hi + hi lo + hi hi): at the TF32
//     peak (495 TFLOP/s) a third of it, 2.5x fp32 FMA's. Splitting the operands into their
//     TF32 parts is CUDA-core work beside them; cut at compile time (scripts/k7_cuts.py),
//     the products' small terms take about half the time and the K/V splits a fifth, the
//     exponentials nothing that does not overlap.
// What the design does about it:
//   bf16: attention_fwd.cuh's NORMALISED mode, the loop K1 runs: one block per (128
//     queries, b * h), 8 warps, K/V tiles of 64 keys in a cp.async ring, S, P and the output
//     in mma.sync fragments. The first sweep stages K alone and keeps the online row max and
//     sum; the second computes exp2(s log2e - (m log2e + log2 l)), one exponential and no
//     division a weight, rounds it to bf16 and multiplies by V.
//   fp32: one block per (64 queries, b * h), four warps of 16 rows, three blocks an SM at
//     D = 32 (at four, 128 registers spilled and ran slower), one sweep over K/V tiles of 64
//     keys in a 2-stage cp.async ring (row pitch D + 4 words: conflict-free fragment reads).
//     Q is split once into shared memory, its A fragments read each tile (held in registers
//     they took D of them a thread and the loop spilled). Per tile and warp: S = Q K^T by
//     m16n8k8 TF32 mma.sync in 3xTF32, the k8 step outer so that consecutive products go to
//     different score tiles (Q's and K's fragments by ldmatrix of 32-bit rows); the online
//     row max and sum on S's accumulators (one ex2.approx of a log2e-scaled score a weight, O
//     rescaled by ex2 of the max's change); O += P V in 3xTF32, P's A fragments split from
//     S's accumulators in place (the k8 step's keys numbered 2c, 2c + 1, so no shuffle). Each
//     warp splits the K and V fragments it reads, two integer operations a rounding (ptxas
//     gives cvt.rna.tf32.f32 four): a split once a tile by the block into shared memory
//     measured slower (its pass and second barrier stall every warp of the block, and it
//     reads twice the fragments). O is divided by the fp32 row sum once an element at the end.
// Ragged edges: query rows past Nq are computed on zeros and not stored (a warp whose rows
// all lie past Nq skips the arithmetic); keys past Nk are zero-filled and weigh 0.

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

// ---- fp32: 3xTF32 on the tensor cores -------------------------------------------------------

constexpr int BQ = 64;            // queries per block: four warps of 16 rows
constexpr int BK = 64;            // keys per K/V tile
constexpr int THREADS = BQ / 16 * 32;
constexpr int STAGES = 2;         // K/V tiles in the ring
constexpr int NT = BK / 8;        // n8 score tiles a key tile, and k8 steps of its PV product

template <int D>
struct Cfg {
  // Row pitch in words: D + 4 puts the 8 rows of a fragment read 4 banks apart (K: key g,
  // dims t and t + 4; V: keys 2t and 2t + 1, dim g), and keeps each row 16-byte aligned
  static constexpr int LD = D + 4;
  static constexpr int TILE = BK * LD;  // floats: a K or V tile, or Q's hi or lo parts
  // the ring's stages of K and V, then the block's Q split into its hi and lo parts
  static constexpr int SMEM = (STAGES + 1) * 2 * TILE * 4;  // bytes
};

// x = hi + lo, both TF32: hi = rna(x), lo = rna(x - hi)
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = pcdiff_ptx::round_tf32(x);
  lo = pcdiff_ptx::round_tf32(x - __uint_as_float(hi));
}

// d += a b in 3xTF32: the two small products first, then the large one, into one fp32
// accumulator (CUTLASS's OpMultiplyAddFastF32 order)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const unsigned (&a_hi)[4],
                                           const unsigned (&a_lo)[4], const unsigned (&b_hi)[2],
                                           const unsigned (&b_lo)[2]) {
  pcdiff_ptx::mma_tf32(d, a_lo, b_hi[0], b_hi[1]);
  pcdiff_ptx::mma_tf32(d, a_hi, b_lo[0], b_lo[1]);
  pcdiff_ptx::mma_tf32(d, a_hi, b_hi[0], b_hi[1]);
}

// Rows [r0, r0 + BK) of a panel into a [BK, LD] tile by cp.async; rows past n are zeros.
// `vec`: the panel's base and row stride are 16-byte aligned (16-byte copies), else 4-byte ones.
template <int D>
__device__ __forceinline__ void stage_tile(float* dst, const float* src, long long stride,
                                           int r0, int n, bool vec) {
  constexpr int LD = Cfg<D>::LD;
  constexpr int CH = D / 4;  // 16-byte chunks a row
  if (vec) {
    for (int c = threadIdx.x; c < BK * CH; c += THREADS) {
      const int r = c / CH, col = (c % CH) * 4;
      const bool ok = r0 + r < n;
      const float* from = src + (long long)(ok ? r0 + r : 0) * stride + col;
      pcdiff_ptx::cp_async_16(dst + r * LD + col, from, ok ? 16 : 0);
    }
  } else {
    for (int c = threadIdx.x; c < BK * D; c += THREADS) {
      const int r = c / D, col = c % D;
      const bool ok = r0 + r < n;
      const float* from = src + (long long)(ok ? r0 + r : 0) * stride + col;
      pcdiff_ptx::cp_async_4(dst + r * LD + col, from, ok ? 4 : 0);
    }
  }
}

// One key tile through one warp's 16 query rows: S = Q K^T in 3xTF32, the online softmax on
// S's accumulators, O = O alpha + P V in 3xTF32. Lane (g, t) = (lane / 4, lane % 4) holds rows
// g and g + 8 at columns 8j + 2t, +1 of every n8 tile j (index e of s[j], o[j]: row + 8 (e / 2),
// column + e % 2). m: the running row max; l: the running row sum of this lane's columns. q:
// the warp's 16 rows of Q's hi parts (lo at q + TILE); kv: the staged tile, K and then V at
// kv + TILE, split into TF32 parts as the fragments are read.
template <int D>
__device__ __forceinline__ void tile_fp32(float (&o)[D / 8][4], float (&m)[2], float (&l)[2],
                                          const float* q, const float* kv, int k0, int nk) {
  using C = Cfg<D>;
  constexpr int LD = C::LD;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // k8 step kc outer, so each step's products go to the eight score tiles in turn. Q's A
  // fragment by one ldmatrix.x4 of 32-bit rows a part (matrix i: rows 8 (i % 2), +7 at dims
  // 8kc + 4 (i / 2), +3); K's B fragments b0 = K[8j + g][8kc + t], b1 = K[8j + g][8kc + t + 4]
  // of two tiles j = 2jp, 2jp + 1 by another (matrix i: keys 16jp + 8 (i / 2), +7 at dims
  // 8kc + 4 (i % 2), +3)
  const float* q_lane = q + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 4 * (lane >> 4);
  const float* k_lane = kv + ((lane & 7) + 8 * (lane >> 4)) * LD + 4 * ((lane >> 3) & 1);
#pragma unroll
  for (int kc = 0; kc < D / 8; ++kc) {
    unsigned a_hi[4], a_lo[4];
    pcdiff_ptx::ldmatrix_x4(a_hi, q_lane + 8 * kc);
    pcdiff_ptx::ldmatrix_x4(a_lo, q_lane + C::TILE + 8 * kc);
#pragma unroll
    for (int jp = 0; jp < NT / 2; ++jp) {
      unsigned raw[4];
      pcdiff_ptx::ldmatrix_x4(raw, k_lane + 16 * jp * LD + 8 * kc);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        unsigned b_hi[2], b_lo[2];
        split_tf32(__uint_as_float(raw[2 * h]), b_hi[0], b_lo[0]);
        split_tf32(__uint_as_float(raw[2 * h + 1]), b_hi[1], b_lo[1]);
        mma_3xtf32(s[2 * jp + h], a_hi, a_lo, b_hi, b_lo);
      }
    }
  }

  if (k0 + BK > nk) {  // the panel's last tile, partial: keys past nk weigh nothing
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * t + (e & 1) >= nk) s[j][e] = -INFINITY;
  }

  float off[2], alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = -INFINITY;
#pragma unroll
    for (int j = 0; j < NT; ++j) x = fmaxf(x, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_new = fmaxf(m[r], x);  // finite: every tile holds at least one key
    alpha[r] = pcdiff_ptx::ex2((m[r] - m_new) * pcdiff_attn::LOG2E);  // 0 on the first tile
    off[r] = m_new * pcdiff_attn::LOG2E;
    m[r] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[j][e] = pcdiff_ptx::ex2(fmaf(s[j][e], pcdiff_attn::LOG2E, -off[e >> 1]));
      psum[e >> 1] += s[j][e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e >> 1];

  // PV, k8 step j over keys 8j..8j+7 taken in the order 8j + 2c (column c of A) and
  // 8j + 2c + 1 (column c + 4): P's A fragment is then S's accumulator (c0, c2, c1, c3) with
  // no shuffle, and V's B fragment reads keys 8j + 2t and 8j + 2t + 1 at dim 8n + g
  const int v_lane = C::TILE + 2 * t * LD + g;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    unsigned a_hi[4], a_lo[4];
    split_tf32(s[j][0], a_hi[0], a_lo[0]);
    split_tf32(s[j][2], a_hi[1], a_lo[1]);
    split_tf32(s[j][1], a_hi[2], a_lo[2]);
    split_tf32(s[j][3], a_hi[3], a_lo[3]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int i0 = v_lane + 8 * j * LD + 8 * n;
      unsigned b_hi[2], b_lo[2];
      split_tf32(kv[i0], b_hi[0], b_lo[0]);
      split_tf32(kv[i0 + LD], b_hi[1], b_lo[1]);
      mma_3xtf32(o[n], a_hi, a_lo, b_hi, b_lo);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, D == 32 ? 3 : 2)
head_split_attention_fp32_kernel(const Args a) {
  using C = Cfg<D>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int b = blockIdx.x / a.heads, h = blockIdx.x % a.heads;
  const int nq = a.nq, nk = a.nk;
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.y * BQ + 16 * (threadIdx.x / 32);  // the warp's first query row
  const bool active = row0 < nq;  // a warp whose 16 rows all lie past nq skips the arithmetic
  const float* qb = static_cast<const float*>(a.q) + b * a.q_b + h * a.q_h;
  const float* kb = static_cast<const float*>(a.k) + b * a.k_b + h * a.k_h;
  const float* vb = static_cast<const float*>(a.v) + b * a.v_b + h * a.v_h;
  float* ob = static_cast<float*>(a.o) + b * a.o_b + h * a.o_h;
  const std::uintptr_t kv =
      reinterpret_cast<std::uintptr_t>(kb) | reinterpret_cast<std::uintptr_t>(vb);
  const bool vec = kv % 16 == 0 && a.k_n % 4 == 0 && a.v_n % 4 == 0;  // 16-byte copies

  const int ntiles = (nk + BK - 1) / BK;
  auto load = [&](int tile, int stage) {
    float* sk = ring + stage * 2 * C::TILE;
    stage_tile<D>(sk, kb, a.k_n, tile * BK, nk, vec);
    stage_tile<D>(sk + C::TILE, vb, a.v_n, tile * BK, nk, vec);
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ntiles) load(st, st);
    pcdiff_ptx::cp_async_commit();  // one group a tile, empty past the end: uniform counts
  }

  // Q's 64 rows split once into their TF32 parts (rows past nq zeros), hi and lo in two
  // tiles past the ring's stages; the first tile's barrier makes them visible
  float* q_parts = ring + STAGES * 2 * C::TILE;
  for (int c = threadIdx.x; c < BQ * D; c += THREADS) {
    const int r = c / D, col = c % D, row = blockIdx.y * BQ + r;
    unsigned hi, lo;
    split_tf32(row < nq ? qb[(long long)row * a.q_n + col] : 0.f, hi, lo);
    q_parts[r * C::LD + col] = __uint_as_float(hi);
    q_parts[C::TILE + r * C::LD + col] = __uint_as_float(lo);
  }

  const float* q_warp = q_parts + 16 * (threadIdx.x / 32) * C::LD;
  float o[D / 8][4], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  int stage = 0;
  for (int k0 = 0; k0 < nk; k0 += BK) {
    pcdiff_ptx::cp_async_wait<STAGES - 2>();  // this thread's copies of this tile have landed
    __syncthreads();  // everyone's, and every warp is done with the last tile
    const int next = k0 / BK + STAGES - 1;
    if (next < ntiles) load(next, stage == 0 ? STAGES - 1 : stage - 1);
    pcdiff_ptx::cp_async_commit();
    if (active) tile_fp32<D>(o, m, l, q_warp, ring + stage * 2 * C::TILE, k0, nk);
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }
  pcdiff_ptx::cp_async_wait<0>();

  // one division by the fp32 row sum an output element; rows past nq are not stored
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l_row = pcdiff_attn::row_sum(l[r]);
    const int row = row0 + g + 8 * r;
    if (active && row < nq) {
      float* dst = ob + (long long)row * a.o_n + 2 * t;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        dst[8 * n] = o[n][2 * r] / l_row;
        dst[8 * n + 1] = o[n][2 * r + 1] / l_row;
      }
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
