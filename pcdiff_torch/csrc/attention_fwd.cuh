// The bf16 attention forward loop for Hopper (sm_90a), shared by the multi-head kernel K1
// (attention_mh.cu), the head-split kernel K7 (attention.cu) and the profiling ladder K8
// (attention_ladder.cu), so that the ladder measures the loop that K1 and K7 run.
//
// One block takes 128 queries of one (batch row, head) panel: 8 warps of 16 query rows. It
// walks the panel's keys in tiles of 64. Per tile and warp:
//   S = Q K^T        mma.sync m16n8k16 (bf16 in, fp32 accumulate); Q's A fragments are
//                    loaded once (ldmatrix), K's B fragments per tile (ldmatrix);
//   softmax          on the C fragments in registers: each row's max and sum across the 4
//                    lanes that share it (shuffles 1 and 2), exponentials as one FFMA
//                    (s log2e - m log2e) and one ex2.approx;
//   O += P V         P converted in place to bf16 A fragments (two n8 C tiles are one k16 A
//                    tile), V's B fragments by ldmatrix.trans; O stays in registers.
// Only K and V pass through shared memory: a ring of STAGES tiles filled by cp.async.cg
// 16-byte copies (zero-filled past the panel's end), the next tiles loading while the
// current one is computed; fp32 inputs (K1's train step) are converted through registers
// instead, 16 bytes a load.
//
// What bounds it on the H100: at D = 32 the products are a few percent of the time; one
// exponential a score on the SFUs (16 a clock per SM) is the floor, then the fp32 softmax
// work (an FFMA, a max, an add and half a conversion a score). The design keeps that work
// off shared memory and keeps K/V staging asynchronous, so it overlaps with them.
//
// Modes, each a compile-time cut of the same loop:
//   QK, QK_MAX, QK_EXP, QK_SUM, NOMAX    the ladder's rungs (attention_ladder.cu);
//   FULL                                 K1: online max and sum, unnormalised P rounded to
//                                        bf16, O divided by the fp32 row sum after PV;
//   NORMALISED                           K7: a first sweep for the row max and sum (K only,
//                                        the QK_SUM cut), a second for
//                                        exp2(s log2e - (m log2e + log2 l)) rounded to bf16
//                                        and multiplied by V: the weights normalised before
//                                        they are rounded, as the TPU kernel rounds;
//   BF16_EXP                             K1 under the bf16 exp switch at a panel longer than
//                                        EXP_MAX_KEYS (none on the port's paths): a first
//                                        sweep for the final row max (K only, the QK_MAX
//                                        cut), then t = bf16(s - m), p = bf16(exp2(t log2e)),
//                                        the sum of the rounded p and PV, O divided by the
//                                        fp32 sum after PV: the TPU kernel's roundings, which
//                                        take the final max, in its order.
// K1 under the bf16 exp switch at a panel of at most EXP_MAX_KEYS keys (every panel of the
// sampler and the train step) runs the same roundings in one pass instead: exp_block, at
// the end of this file, whose warps split the keys and trade their row maxes.
// Ragged edges: query rows past nq are computed on zeros and not stored (a warp whose 16
// rows all lie past nq skips the arithmetic); keys past nk are zero-filled and their scores
// set to -inf, so they weigh 0 in the max, the sum and PV.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <type_traits>

#include "ptx.cuh"

namespace pcdiff_attn {

using namespace pcdiff_ptx;  // cp.async, ldmatrix, mma.sync, ex2, bf16 packing
using pcdiff_ptx::bf16;

constexpr int BQ = 128;            // queries per block
constexpr int BK = 64;             // keys per K/V tile
constexpr int WARPS = BQ / 16;     // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int STAGES = 3;          // K/V tiles in the ring
constexpr int NT = BK / 8;         // n8 score tiles per key tile
constexpr float LOG2E = 1.4426950408889634f;

enum Mode {
  QK = 0, QK_MAX = 1, QK_EXP = 2, QK_SUM = 3, NOMAX = 4, FULL = 5, NORMALISED = 6, BF16_EXP = 7
};

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // bf16 row pitch: 16-byte rows hit distinct bank groups
  static constexpr int TILE = BK * LD;
  static constexpr int Q_ELEMS = BQ * LD;
  static constexpr int SMEM = (Q_ELEMS + STAGES * 2 * TILE) * 2;  // bytes
};

// One (batch row, head) panel: row 0 of q, k, v and o, their row strides in elements, and
// the panel's lengths. q0 is the block's first query.
template <typename T>
struct Panel {
  const T* q;
  const T* k;
  const T* v;
  T* o;
  long long q_n, k_n, v_n, o_n;
  int nq, nk, q0;
};

// Rows [r0, r0 + rows) of a panel (row stride `stride`, D contiguous elements) into a
// [rows, LD] bf16 tile, by threads tid, tid + nthreads, ...; rows past n are zeros. bf16:
// cp.async, 16 bytes a copy; fp32: two 16-byte loads, rounded to bf16, one 16-byte store.
template <int D, typename T>
__device__ __forceinline__ void stage_rows_by(bf16* dst, const T* src, long long stride,
                                              int r0, int n, int rows, int tid, int nthreads) {
  constexpr int CH = D / 8;  // 16-byte bf16 chunks a row
  for (int c = tid; c < rows * CH; c += nthreads) {
    const int r = c / CH, col = (c % CH) * 8;
    const int row = r0 + r;
    const bool ok = row < n;
    bf16* d = dst + r * Layout<D>::LD + col;
    const T* s = src + (long long)(ok ? row : 0) * stride + col;
    if constexpr (std::is_same<T, bf16>::value) {
      cp_async_16(d, s, ok ? 16 : 0);
    } else {
      uint4 packed = make_uint4(0u, 0u, 0u, 0u);
      if (ok) {
        const float4 a = *reinterpret_cast<const float4*>(s);
        const float4 b = *reinterpret_cast<const float4*>(s + 4);
        packed = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                            pack_bf16(b.z, b.w));
      }
      *reinterpret_cast<uint4*>(d) = packed;
    }
  }
}

// Rows [r0, r0 + ROWS) of a panel into a [ROWS, LD] tile by the block's THREADS threads.
template <int ROWS, int D, typename T>
__device__ __forceinline__ void stage_rows(bf16* dst, const T* src, long long stride, int r0,
                                           int n) {
  stage_rows_by<D>(dst, src, stride, r0, n, ROWS, (int)threadIdx.x, THREADS);
}

// Per-thread state of a warp's 16 query rows. Lane l holds rows g = l / 4 (index 0) and
// g + 8 (index 1) of the warp's 16, at columns 8j + 2(l % 4) + {0, 1} of every n8 tile j.
template <int D>
struct RowState {
  unsigned qf[D / 16][4];  // Q's A fragments
  float o[D / 8][4];       // the output accumulator (C fragments)
  float m[2];              // running row max
  float l[2];              // running row sum, this lane's columns only
  float first[D / 8][4];   // the ladder's qk / qk_exp panel of the first key tile
  float m_first[2];
  float c[2];              // NORMALISED: m log2e + log2 l, the exponent's offset
};

template <int MODE>
struct Cut {  // what each mode runs of the loop (the two-sweep modes: their second sweep)
  static constexpr bool MAX = MODE != NOMAX && MODE != NORMALISED && MODE != BF16_EXP;
  static constexpr bool EXP = MODE >= QK_EXP;
  static constexpr bool SUM = MODE >= QK_EXP && MODE != NORMALISED;
  static constexpr bool PV = MODE >= NOMAX;
  static constexpr bool RESCALE = MODE == FULL;  // the output accumulator by alpha
};

// O (* alpha) += P V for one key tile: P from the exponentials in s, rounded to bf16 in
// place into A fragments (two n8 C tiles are one k16 A tile), V's B fragments by
// ldmatrix.trans.
template <bool RESCALE, int D>
__device__ __forceinline__ void pv_step(RowState<D>& st, const float (&s)[NT][4],
                                        const bf16* sv, const float (&alpha)[2]) {
  constexpr int LD = Layout<D>::LD;
  const int lane = threadIdx.x % 32;
  if constexpr (RESCALE) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.o[j][e] *= alpha[e >> 1];
  }
  // ldmatrix.x4.trans lane addresses: V rows (keys) 16kc + (lane & 7) + 8 ((lane / 8) & 1),
  // columns 16dp + 8 (lane / 16); matrices 0/1 are d tile 2dp's B fragment, 2/3 tile 2dp + 1's.
  const bf16* v_lane = sv + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const unsigned a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                           pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                           pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                           pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      unsigned b[4];
      ldmatrix_x4_trans(b, v_lane + 16 * kc * LD + 16 * dp);
      mma_bf16(st.o[2 * dp], a, b[0], b[1]);
      mma_bf16(st.o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// One key tile through one warp: S, the mode's softmax stage, and PV where the mode has it.
template <int MODE, int D>
__device__ __forceinline__ void tile_step(RowState<D>& st, const bf16* sk, const bf16* sv,
                                          int k0, int nk, bool first_tile) {
  using Cu = Cut<MODE>;
  constexpr int LD = Layout<D>::LD;
  const int lane = threadIdx.x % 32;

  float s[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  // ldmatrix.x4 lane addresses: K rows (keys) 16p + (lane & 7) + 8 (lane / 16), columns
  // 16kc + 8 ((lane / 8) & 1); matrices 0/1 are tile 2p's B fragment, 2/3 tile 2p + 1's.
  const bf16* k_lane = sk + ((lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
  for (int p = 0; p < NT / 2; ++p) {
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
      unsigned b[4];
      ldmatrix_x4(b, k_lane + 16 * p * LD + 16 * kc);
      mma_bf16(s[2 * p], st.qf[kc], b[0], b[1]);
      mma_bf16(s[2 * p + 1], st.qf[kc], b[2], b[3]);
    }
  }

  const int tig = lane & 3;
  if (k0 + BK > nk) {  // the panel's last tile, partial: keys past nk weigh nothing
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * tig + (e & 1) >= nk) s[j][e] = -INFINITY;
  }

  if (MODE == QK && first_tile) {
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) st.first[j][e] = s[j][e];
  }

  float m_new[2], alpha[2] = {1.f, 1.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_new[r] = st.m[r];
    if constexpr (Cu::MAX) {
      float t = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j) t = fmaxf(t, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 1));
      t = fmaxf(t, __shfl_xor_sync(0xffffffffu, t, 2));
      m_new[r] = fmaxf(st.m[r], t);  // finite: every tile holds at least one key
      if constexpr (Cu::SUM) alpha[r] = ex2((st.m[r] - m_new[r]) * LOG2E);  // 0 at first
    }
  }
  if constexpr (!Cu::EXP) {
    st.m[0] = m_new[0];
    st.m[1] = m_new[1];
  } else {
    // the exponent's offset: the running max (online modes), none (NOMAX), or the final
    // max and log2 of the final sum (NORMALISED); BF16_EXP subtracts the final max before
    // it rounds and scales
    float off[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      off[r] = MODE == NOMAX ? 0.f : MODE == NORMALISED ? st.c[r] : m_new[r] * LOG2E;
    float psum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if constexpr (MODE == BF16_EXP)
          s[j][e] = round_bf16(ex2(round_bf16(s[j][e] - st.m[e >> 1]) * LOG2E));
        else
          s[j][e] = ex2(fmaf(s[j][e], LOG2E, -off[e >> 1]));
        psum[e >> 1] += s[j][e];
      }
    if (MODE == QK_EXP && first_tile) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st.first[j][e] = s[j][e];
      st.m_first[0] = m_new[0];
      st.m_first[1] = m_new[1];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if constexpr (Cu::SUM) st.l[r] = st.l[r] * alpha[r] + psum[r];
      st.m[r] = m_new[r];
    }
    if constexpr (Cu::PV) pv_step<Cu::RESCALE, D>(st, s, sv, alpha);
  }
}

// One sweep over the panel's keys through the K/V ring. The caller has issued the Q tile's
// copies (as an older group) or finished with Q; `ready` loads Q's fragments once the first
// groups have landed.
template <int MODE, int D, typename T, typename Ready>
__device__ __forceinline__ void sweep(const Panel<T>& p, RowState<D>& st, bf16* ring,
                                      bool active, Ready ready) {
  constexpr bool WITH_V = Cut<MODE>::PV;
  constexpr int TILE = Layout<D>::TILE;
  const int ntiles = (p.nk + BK - 1) / BK;
  auto load = [&](int t, int stage) {
    bf16* sk = ring + stage * 2 * TILE;
    stage_rows<BK, D>(sk, p.k, p.k_n, t * BK, p.nk);
    if constexpr (WITH_V) stage_rows<BK, D>(sk + TILE, p.v, p.v_n, t * BK, p.nk);
  };
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
    if (active) {
      const bf16* sk = ring + stage * 2 * TILE;
      tile_step<MODE, D>(st, sk, sk + TILE, t * BK, p.nk, t == 0);
    }
    stage = stage == STAGES - 1 ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free for the next sweep
}

__device__ __forceinline__ float row_sum(float v) {  // across the 4 lanes of a row
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  if constexpr (std::is_same<T, bf16>::value)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// The block's part of one panel in mode MODE: `smem` holds Layout<D>::SMEM bytes. Writes o
// (T) for the block's query rows below nq: the mode's output (see the head of this file).
template <int MODE, int D, typename T>
__device__ __forceinline__ void attention_block(const Panel<T>& p, unsigned char* smem) {
  constexpr int LD = Layout<D>::LD;
  bf16* sq = reinterpret_cast<bf16*>(smem);
  bf16* ring = sq + Layout<D>::Q_ELEMS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row0 = p.q0 + 16 * warp;  // the warp's first query row
  const bool active = row0 < p.nq;

  RowState<D> st;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    st.m[r] = MODE == NOMAX ? 0.f : -INFINITY;
    st.l[r] = 0.f;
    st.m_first[r] = 0.f;
    st.c[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) st.o[j][e] = st.first[j][e] = 0.f;

  stage_rows<BQ, D>(sq, p.q, p.q_n, p.q0, p.nq);
  cp_async_commit();
  auto load_q = [&]() {
    cp_async_wait<STAGES - 1>();  // the Q group, older than the ring's first groups
    __syncthreads();
    // ldmatrix.x4 lane addresses: rows (lane & 15), columns 16kc + 8 (lane / 16)
    const bf16* q_lane = sq + (16 * warp + (lane & 15)) * LD + 8 * (lane >> 4);
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) ldmatrix_x4(st.qf[kc], q_lane + 16 * kc);
  };
  if constexpr (MODE == NORMALISED) {
    sweep<QK_SUM, D>(p, st, ring, active, load_q);
#pragma unroll
    for (int r = 0; r < 2; ++r) st.c[r] = st.m[r] * LOG2E + log2f(row_sum(st.l[r]));
    sweep<NORMALISED, D>(p, st, ring, active, [] {});
  } else if constexpr (MODE == BF16_EXP) {
    sweep<QK_MAX, D>(p, st, ring, active, load_q);
    sweep<BF16_EXP, D>(p, st, ring, active, [] {});
  } else {
    sweep<MODE, D>(p, st, ring, active, load_q);
  }

  const int g = lane >> 2, tig = lane & 3;
  float val[D / 8][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float l = row_sum(st.l[r]);
    const float m = st.m[r];
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
#pragma unroll
      for (int e = 2 * r; e < 2 * r + 2; ++e) {
        float x;
        if constexpr (MODE == QK)  // + (m - m): the max keeps every score, so every product, live
          x = st.first[j][e] + (m - m);
        else if constexpr (MODE == QK_MAX)
          x = m;
        else if constexpr (MODE == QK_EXP)  // + (l - l): the sum keeps every exponential live
          x = st.first[j][e] * ex2((st.m_first[r] - m) * LOG2E) + (l - l);
        else if constexpr (MODE == QK_SUM)
          x = l;
        else if constexpr (MODE == NORMALISED)
          x = st.o[j][e];
        else  // FULL, NOMAX, BF16_EXP: the division by the fp32 row sum after PV
          x = st.o[j][e] * (1.f / l);
        val[j][e] = x;
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row < p.nq) {
      T* dst = p.o + (long long)row * p.o_n + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) store_pair(dst + 8 * j, val[j][2 * r], val[j][2 * r + 1]);
    }
  }
}

// ---- K1's bf16 exp mode in one pass over the keys: the warps of a block split them ----
//
// One block takes one (batch row, head) panel: its K and V, staged once into shared memory,
// and every query of it. Its warps form row groups of `splits` warps, as many groups as fit
// in EXP_WARPS (and the panel has 16-row query tiles); warp w of a group holds keys
// [w slice, min((w + 1) slice, nk)), at most EXP_SLICE of them. A group walks 16-row query
// tiles (group g takes tiles g, g + groups, ...; the next one's Q loads while this one is
// computed). Per tile each warp computes S for its keys once and keeps all of it in
// registers (EXP_SLICE / 2 floats a thread); the warps trade their row maxes through shared
// memory, so each takes the exact final max (a max does not depend on order: it is the
// two-sweep mode's m bit for bit). From the registers: t = bf16(s - m),
// p = bf16(exp2(t log2e)) (two at a time: the packed p is PV's A fragment), the partial
// sum of the rounded p and the partial O = P V, with no online max and no rescale. The
// partials go to shared memory, and the group adds them in warp (key) order
// (deterministic), divides by the fp32 sum after PV and stores. Two barriers a tile and
// group (named, or the warp's own for a group of one warp), after the maxes and after the
// partials.
//
// What bounds it: as the loop above, the exponentials (one a score on the SFUs) and the
// fp32 softmax work, now two roundings a score; K and V are read from device memory once a
// panel, not once a query tile. A thread-block cluster that split the keys over blocks and
// traded the maxes and partials through distributed shared memory, one cluster barrier a
// tile, ran slower than the two sweeps: waiting on the barrier across SMs cost more than the
// first sweep it saved, so the split stays inside the SM.

constexpr int EXP_WARPS = 16;                  // a block's warps at most
constexpr int EXP_THREADS = EXP_WARPS * 32;
constexpr int EXP_SLICE = 128;                 // keys a warp holds at most
constexpr int EXP_CHUNKS = EXP_SLICE / 16;     // its k16 key chunks
constexpr int EXP_MAX_SMEM = 232448;           // the H100's dynamic shared memory a block
constexpr int EXP_MAX_KEYS = 1152;             // the longest panel: its K and V fit beside the rest

template <int D>
struct ExpLayout {
  static constexpr int LD = Layout<D>::LD;  // bf16 row pitch of K, V and Q
  static constexpr int LDO = D + 8;         // fp32 row pitch of a partial O tile
  // K and V (nk rounded up to 16 rows) and two 16-row Q buffers a group in bf16; then a
  // warp's partial O tile, its rows' maxes and sums in fp32
  static constexpr int smem(int nk, int warps, int groups) {
    return ((nk + 15) / 16 * 16 * 2 + 32 * groups) * LD * 2 + warps * 16 * (LDO + 2) * 4;
  }
};
// every plan fits, at K1's head dim: K and V grow with the keys (at most 128 a warp of a
// group, EXP_MAX_KEYS in all) as the groups shrink, and the two largest cases are one group
// of 16 warps at EXP_MAX_KEYS keys and two groups of 8 at 1024
static_assert(ExpLayout<32>::smem(EXP_MAX_KEYS, EXP_WARPS, 1) <= EXP_MAX_SMEM &&
                  ExpLayout<32>::smem(1024, EXP_WARPS, 2) <= EXP_MAX_SMEM,
              "EXP_MAX_KEYS: K and V fit beside the rest");

// The block's row groups for a plan: as many groups of `splits` warps as EXP_WARPS holds,
// and no more than the panel's 16-row query tiles.
__host__ __device__ constexpr int exp_groups(int splits, int nq) {
  return EXP_WARPS / splits < (nq + 15) / 16 ? EXP_WARPS / splits : (nq + 15) / 16;
}

template <typename T>
__device__ __forceinline__ void store_quad(T* dst, float4 v) {
  if constexpr (std::is_same<T, bf16>::value)
    *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
  else
    *reinterpret_cast<float4*>(dst) = v;
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// One panel in the bf16 exp mode (p.q0 is ignored: the block walks every query tile), by
// exp_groups(splits, nq) groups of `splits` warps: `smem` holds ExpLayout<D>::smem bytes;
// the warps of a group hold `slice` keys each (the last one the rest), which cover nk.
template <int D, typename T>
__device__ __forceinline__ void exp_block(const Panel<T>& p, int splits, int slice,
                                          unsigned char* smem) {
  using L = ExpLayout<D>;
  constexpr int LD = L::LD, LDO = L::LDO;
  const int nkp = (p.nk + 15) / 16 * 16;
  bf16* sk = reinterpret_cast<bf16*>(smem);
  bf16* sv = sk + nkp * LD;
  const int groups = exp_groups(splits, p.nq), warps = splits * groups;
  bf16* sq = sv + nkp * LD;                                    // [groups][2][16][LD]
  float* so = reinterpret_cast<float*>(sq + groups * 32 * LD);  // [warps][16][LDO]
  float* smax = so + warps * 16 * LDO;                         // [warps][16]
  float* ssum = smax + warps * 16;                             // [warps][16]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int grp = warp / splits, ks = warp % splits;
  const int nthreads = 32 * splits, gt = threadIdx.x % nthreads;  // the group's threads
  auto group_sync = [&]() {  // the group's barrier: named, or the warp's own
    if (splits == 1)
      __syncwarp();
    else
      named_sync(1 + grp, nthreads);
  };
  const int k0 = ks * slice;
  const int len = min(slice, p.nk - k0);  // >= 1: the plan leaves no warp without keys
  const int chunks = (len + 15) / 16;
  const int tiles = (p.nq + 15) / 16;
  bf16* gq = sq + grp * 32 * LD;  // the group's two Q buffers
  auto stage_q = [&](int tile, int b) {
    stage_rows_by<D>(gq + b * 16 * LD, p.q, p.q_n, 16 * tile, p.nq, 16, gt, nthreads);
  };

  // K and the first Q tile, then V, then the second Q tile: V and every later Q tile land
  // under compute
  stage_rows_by<D>(sk, p.k, p.k_n, 0, p.nk, nkp, (int)threadIdx.x, 32 * warps);
  stage_q(grp, 0);  // every group has a first tile
  cp_async_commit();
  stage_rows_by<D>(sv, p.v, p.v_n, 0, p.nk, nkp, (int)threadIdx.x, 32 * warps);
  cp_async_commit();
  if (grp + groups < tiles) stage_q(grp + groups, 1);
  cp_async_commit();
  cp_async_wait<2>();
  __syncthreads();

  int it = 0;
  for (int tile = grp; tile < tiles; tile += groups, ++it) {
    const bf16* qt = gq + (it & 1) * 16 * LD;

    // S = Q K^T over the warp's keys: chunk c, n8 tile h holds keys k0 + 16c + 8h + 2 tig +
    // (e & 1) of rows g + 8 (e >> 1), as tile_step's s[2c + h]
    float s[EXP_CHUNKS][2][4];
    float m[2] = {-INFINITY, -INFINITY};
    {
      unsigned qf[D / 16][4];
      const bf16* q_lane = qt + (lane & 15) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) ldmatrix_x4(qf[kc], q_lane + 16 * kc);
      const bf16* k_lane = sk + (k0 + (lane & 7) + 8 * (lane >> 4)) * LD + 8 * ((lane >> 3) & 1);
#pragma unroll
      for (int c = 0; c < EXP_CHUNKS; ++c) {
        if (c >= chunks) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) s[c][h][0] = s[c][h][1] = s[c][h][2] = s[c][h][3] = 0.f;
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          unsigned b[4];
          ldmatrix_x4(b, k_lane + 16 * c * LD + 16 * kc);
          mma_bf16(s[c][0], qf[kc], b[0], b[1]);
          mma_bf16(s[c][1], qf[kc], b[2], b[3]);
        }
        if (16 * c + 16 > len) {  // the warp's last chunk, partial: keys past it weigh 0
#pragma unroll
          for (int h = 0; h < 2; ++h)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (16 * c + 8 * h + 2 * tig + (e & 1) >= len) s[c][h][e] = -INFINITY;
        }
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], s[c][h][e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
        m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
      }
    }
    if (tig == 0) {
      smax[warp * 16 + g] = m[0];
      smax[warp * 16 + g + 8] = m[1];
    }
    group_sync();  // the group's maxes are written
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the final max: lane tig reads warps tig, tig + 4, ...
      float x = -INFINITY;
#pragma unroll
      for (int j = tig; j < EXP_WARPS; j += 4)
        if (j < splits) x = fmaxf(x, smax[(grp * splits + j) * 16 + g + 8 * r]);
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      m[r] = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    }

    // the TPU kernel's roundings against the final max, two scores at a time, the sum of
    // the rounded weights, and O = P V with the packed weights as A fragments
    float l[2] = {0.f, 0.f};
    float o[D / 8][4];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
    if (it == 0) {  // V, once: every thread of the block staged it
      cp_async_wait<1>();
      named_sync(15, 32 * warps);
    }
    {
      const bf16* v_lane = sv + (k0 + (lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
      for (int c = 0; c < EXP_CHUNKS; ++c) {
        if (c >= chunks) break;
        unsigned a[4];  // a[2h + r]: n8 tile h, row g + 8r, keys 2 tig + {0, 1}
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const unsigned t = pack_bf16(s[c][h][2 * r] - m[r], s[c][h][2 * r + 1] - m[r]);
            const unsigned pp = pack_bf16(ex2(bf16_lo(t) * LOG2E), ex2(bf16_hi(t) * LOG2E));
            l[r] += bf16_lo(pp);
            l[r] += bf16_hi(pp);
            a[2 * h + r] = pp;
          }
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          unsigned b[4];
          ldmatrix_x4_trans(b, v_lane + 16 * c * LD + 16 * dp);
          mma_bf16(o[2 * dp], a, b[0], b[1]);
          mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the warp's partial O and sum into its slot
      const float lr = row_sum(l[r]);
      float* at = so + (warp * 16 + g + 8 * r) * LDO + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(at + 8 * j) = make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (tig == 0) ssum[warp * 16 + g + 8 * r] = lr;
    }
    cp_async_wait<0>();  // the next Q tile: this thread's copies
    group_sync();        // the partials and the next Q tile are in; S is done with Q

    // the tile's rows: the partials added in warp order, divided by the sum after PV
    for (int i = gt; i < 16 * (D / 4); i += nthreads) {
      const int row = i / (D / 4), col = 4 * (i % (D / 4));
      if (16 * tile + row >= p.nq) break;
      const float* at = so + (grp * splits * 16 + row) * LDO + col;
      const float* sums = ssum + grp * splits * 16 + row;
      float4 acc = *reinterpret_cast<const float4*>(at);
      float sum = sums[0];
#pragma unroll 4
      for (int j = 1; j < splits; ++j) {
        const float4 x = *reinterpret_cast<const float4*>(at + j * 16 * LDO);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
        sum += sums[j * 16];
      }
      const float inv = 1.f / sum;
      store_quad(p.o + (long long)(16 * tile + row) * p.o_n + col,
                 make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
    }
    if (tile + 2 * groups < tiles) stage_q(tile + 2 * groups, it & 1);  // into this tile's
    cp_async_commit();
  }
  cp_async_wait<0>();
}

}  // namespace pcdiff_attn
