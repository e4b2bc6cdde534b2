// The wide-row pieces shared by K3's wide kernel (ln_dense.cu, namespace wide) and the whole-MLP
// kernel's wide rows (ln_mlp.cu, namespace wide), for Hopper (sm_90a): a warp-specialised block
// of eight consumer warps and a producer warpgroup, the block's x rows in a resident panel of
// 128-byte-swizzled k blocks (the layout of the tensor memory accelerator's boxes, of wgmma's
// K-major operand and of the fp32 fragments), normalised there in place; the bf16 epilogue of a
// warpgroup's wgmma accumulator; the TF32 split of the fp32 products.
//
// Numerics of the normalisation: the statistics by the fast-variance formula, lane l of a warp
// summing the row's 8-element chunks l, l + 32, ... in order, then across the warp by an xor
// butterfly; the fp32 affine, (x - mean) rstd scale + bias; rounded once to the product dtype.

#pragma once

#include <type_traits>

#include "ln_dense_fwd.cuh"

namespace pcdiff_wide {

using namespace pcdiff_ptx;
using pcdiff_ln::Args;
using pcdiff_ln::bf16;
using pcdiff_ln::SMEM_ALIGN;

constexpr int MAX_C = 1024;                   // the widest row a panel takes
constexpr int WARPS = 8;                      // the consumer warps: they normalise, multiply
constexpr int CONSUMERS = 32 * WARPS;         // and store
constexpr int THREADS = CONSUMERS + 128;      // and a producer warpgroup (one thread works)
constexpr int PRODUCER_REGS = 40;             // registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;            // 128 x 40 + 256 x 232 of the SM's 65,536
constexpr int CHUNKS = MAX_C / 8 / 32;        // a row's 8-element chunks a lane: 4
constexpr int BOX_BYTES = 128;                // a k block of a row: one 128-byte swizzled row
constexpr int BAR_CONSUMERS = 1;              // named barrier of the consumer warps

template <typename TO>
struct Tile {
  static constexpr int BK = BOX_BYTES / (int)sizeof(TO);  // k a block: 64 bf16 or 32 fp32
};

template <typename TO>
__host__ __device__ constexpr int kext(int c) {  // C rounded up to whole k blocks
  return (c + Tile<TO>::BK - 1) / Tile<TO>::BK * Tile<TO>::BK;
}

// The LN affine at the lane's chunks (lane l: chunks l + 32 j), 16-byte loads, once a block.
struct Affine {
  float sc[CHUNKS][8], bi[CHUNKS][8];
};

__device__ __forceinline__ void load_affine(const Args& a, Affine& af) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int j = 0; j < CHUNKS; ++j) {
    const int col = 8 * (lane + 32 * j);
    float4 s0 = make_float4(0.f, 0.f, 0.f, 0.f), s1 = s0, b0 = s0, b1 = s0;
    if (col < a.c) {
      s0 = reinterpret_cast<const float4*>(a.ln_scale + col)[0];
      s1 = reinterpret_cast<const float4*>(a.ln_scale + col)[1];
      b0 = reinterpret_cast<const float4*>(a.ln_bias + col)[0];
      b1 = reinterpret_cast<const float4*>(a.ln_bias + col)[1];
    }
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      af.sc[j][e] = sv[e];
      af.bi[j][e] = bv[e];
    }
  }
}

// 8 elements (bf16 or fp32, 16-byte aligned) as fp32.
template <typename T>
__device__ __forceinline__ void load8(const T* src, float (&v)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 raw = *reinterpret_cast<const uint4*>(src);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
  } else {
    const float4 p0 = reinterpret_cast<const float4*>(src)[0];
    const float4 p1 = reinterpret_cast<const float4*>(src)[1];
    v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
    v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
  }
}

// (x - mean) rstd scale + bias of 8 elements, the fp32 affine.
__device__ __forceinline__ void affine8(float (&v)[8], float mean, float rstd, const float* sc,
                                        const float* bi) {
#pragma unroll
  for (int e = 0; e < 8; ++e)
    v[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], mean), rstd), sc[e]), bi[e]);
}

// The warp's ROWS rows normalised, GROUP at a time so that a group's loads, butterflies and
// divisions overlap (all of a warp's rows at once measured slower): pass 1 sums each row's x
// and x^2 in fp32, lane by lane over its chunks (lane l: chunks l, l + 32, ...) in order, then
// across the warp by an xor butterfly, and takes the fast-variance statistics; pass 2 reads
// the chunks again and writes (x - mean) rstd scale + bias. load(i, ch, v) gives chunk ch of
// the warp's row i (zeros where the row has no data), store(i, ch, y) writes it; chunks in
// [C / 8, chunks) are written as zeros.
constexpr int GROUP = 4;

template <int ROWS, typename Load, typename Store>
__device__ __forceinline__ void normalise_rows(const Args& a, int chunks, Load&& load,
                                               Store&& store) {
  static_assert(ROWS % GROUP == 0, "whole groups of rows");
  const int lane = threadIdx.x % 32, live = a.c / 8;
  Affine af;
  load_affine(a, af);
#pragma unroll 1
  for (int i0 = 0; i0 < ROWS; i0 += GROUP) {
    float mean[GROUP], rstd[GROUP];
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      mean[i] = rstd[i] = 0.f;  // the sums of x and x^2, then the statistics
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const int ch = lane + 32 * j;
        if (ch >= live) continue;
        float v[8];
        load(i0 + i, ch, v);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          mean[i] = __fadd_rn(mean[i], v[e]);
          rstd[i] = __fadd_rn(rstd[i], __fmul_rn(v[e], v[e]));
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        mean[i] = __fadd_rn(mean[i], __shfl_xor_sync(0xffffffffu, mean[i], off));
        rstd[i] = __fadd_rn(rstd[i], __shfl_xor_sync(0xffffffffu, rstd[i], off));
      }
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const float s2 = rstd[i];
      mean[i] = __fdiv_rn(mean[i], (float)a.c);
      const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)a.c), __fmul_rn(mean[i], mean[i])),
                              0.f);
      rstd[i] = rsqrtf(__fadd_rn(var, a.eps));
    }
#pragma unroll
    for (int i = 0; i < GROUP; ++i)
#pragma unroll
      for (int j = 0; j < CHUNKS; ++j) {
        const int ch = lane + 32 * j;
        if (ch >= chunks) continue;
        float y[8];
        if (ch < live) {
          load(i0 + i, ch, y);
          affine8(y, mean[i], rstd[i], af.sc[j], af.bi[j]);
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) y[e] = 0.f;
        }
        store(i0 + i, ch, y);
      }
  }
}

// The 16-byte chunk c (within its k block) of panel row r, k block kb: k blocks of [PR][BK] in
// the 128-byte swizzle (chunk c of a row at c ^ (row % 8)), the TMA box's layout and wgmma's
// K-major operand.
template <typename TO, int PR>
__device__ __forceinline__ TO* panel_at(TO* sa, int r, int kb, int c) {
  constexpr int BK = Tile<TO>::BK;
  return sa + kb * (PR * BK) + r * BK + ((c ^ (r & 7)) * (16 / (int)sizeof(TO)));
}

// Chunk ch (8 elements) of the warp's panel row i as fp32: the panel's own (x in the product
// dtype, brought by the producer's TMA boxes: rows past `rows` and columns past C zeros), or
// x's from device memory (x in the other dtype). bf16 panel: 16-byte chunk ch % 8 of k block
// ch / 8; fp32: 16-byte chunks 2 (ch % 4), + 1 of k block ch / 4.
template <typename TX, typename TO, int PR>
__device__ __forceinline__ void panel_load(const Args& a, int r0, const TO* sa, int row, int ch,
                                           float (&v)[8]) {
  if constexpr (std::is_same<TX, TO>::value) {
    if constexpr (std::is_same<TO, bf16>::value) {
      load8<bf16>(panel_at<TO, PR>(const_cast<TO*>(sa), row, ch >> 3, ch & 7), v);
    } else {
      const float4 p0 = *reinterpret_cast<const float4*>(
          panel_at<TO, PR>(const_cast<TO*>(sa), row, ch >> 2, 2 * (ch & 3)));
      const float4 p1 = *reinterpret_cast<const float4*>(
          panel_at<TO, PR>(const_cast<TO*>(sa), row, ch >> 2, 2 * (ch & 3) + 1));
      v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
      v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
    }
  } else if (r0 + row < a.rows) {
    load8<TX>(static_cast<const TX*>(a.x) + (size_t)(r0 + row) * a.c + 8 * ch, v);
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
  }
}

// The consumers' panel: rows [r0, r0 + PR) of LN(x) in the product dtype, normalised in
// place (or from x) by normalise_rows, zeros from C up to `kx` (whole k blocks). Warp w takes
// rows w PR / 8 .. ; `xbar` completes when the producer's x boxes have landed (x in the
// product dtype).
template <typename TX, typename TO, int PR>
__device__ __forceinline__ void panel(const Args& a, int r0, TO* sa, unsigned long long* xbar,
                                      int kx) {
  constexpr int ROWS = PR / WARPS;
  const int rw = (threadIdx.x / 32) * ROWS;
  if constexpr (std::is_same<TX, TO>::value) mbar_wait(xbar, 0);
  normalise_rows<ROWS>(
      a, kx / 8,
      [&](int i, int ch, float (&v)[8]) { panel_load<TX, TO, PR>(a, r0, sa, rw + i, ch, v); },
      [&](int i, int ch, const float (&y)[8]) {
        if constexpr (std::is_same<TO, bf16>::value) {
          *reinterpret_cast<uint4*>(panel_at<TO, PR>(sa, rw + i, ch >> 3, ch & 7)) =
              make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                         pack_bf16(y[6], y[7]));
        } else {
          *reinterpret_cast<float4*>(panel_at<TO, PR>(sa, rw + i, ch >> 2, 2 * (ch & 3))) =
              make_float4(y[0], y[1], y[2], y[3]);
          *reinterpret_cast<float4*>(panel_at<TO, PR>(sa, rw + i, ch >> 2, 2 * (ch & 3) + 1)) =
              make_float4(y[4], y[5], y[6], y[7]);
        }
      });
}

// The bias and activation of 32 columns (group q) of a warpgroup's accumulator, as bf16 pairs:
// v[h][i] holds rows + 8 h of n8 block 4 q + i.
template <int ACT, int N, typename Div>
__device__ __forceinline__ void pack_cols(const float (&acc)[N / 2], int q, const float2 (&b)[4],
                                          bool hb, unsigned (&v)[2][4], Div div) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * q + i;
      v[h][i] = pack_bf16(pcdiff_ln::bias_act<ACT>(acc[4 * j + 2 * h], hb, b[i].x, div),
                          pcdiff_ln::bias_act<ACT>(acc[4 * j + 2 * h + 1], hb, b[i].y, div));
    }
}

// The epilogue of a warpgroup's 64 x N share of a tile (columns n0 .. of output o, rows
// row_base ..): epilogue_bf16's stores (a 4 x 4 transpose across a quad's lanes, 16 bytes a
// lane), its activation's divisions on DivFast and, for a 32-column group with any operand
// outside the fast path's range, all again on DivRn. Columns at or past F are not stored.
template <int ACT, int N>
__device__ __forceinline__ void wide_epilogue_bf16(const Args& a, int o, int n0, int row_base,
                                                   const float (&acc)[N / 2]) {
  const int F = a.f[o];
  const float* bias = a.b[o];
  bf16* out = static_cast<bf16*>(a.out[o]);
  const bool hb = bias != nullptr;
  const int t = threadIdx.x % 128, lane = t % 32, tig = lane & 3;
  const bool odd = tig & 1, hi = tig & 2;
  const int row0 = row_base + 16 * (t / 32) + (lane >> 2);
#pragma unroll
  for (int q = 0; q < N / 32; ++q) {
    if (n0 + 32 * q >= F) break;  // F % 32 == 0: a tile's last columns may lie past F
    float2 b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      b[i] = hb ? *reinterpret_cast<const float2*>(bias + n0 + 8 * (4 * q + i) + 2 * tig)
                : make_float2(0.f, 0.f);
    unsigned v[2][4];
    bool ok = true;
    pack_cols<ACT, N>(acc, q, b, hb, v, pcdiff_ln::DivFast{ok});
    if (!ok) pack_cols<ACT, N>(acc, q, b, hb, v, pcdiff_ln::DivRn());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned s0 = odd ? v[h][0] : v[h][1], s1 = odd ? v[h][2] : v[h][3];
      unsigned g0 = __shfl_xor_sync(0xffffffffu, s0, 1), g1 = __shfl_xor_sync(0xffffffffu, s1, 1);
      if (odd) {
        v[h][0] = g0;
        v[h][2] = g1;
      } else {
        v[h][1] = g0;
        v[h][3] = g1;
      }
      s0 = hi ? v[h][0] : v[h][2];
      s1 = hi ? v[h][1] : v[h][3];
      g0 = __shfl_xor_sync(0xffffffffu, s0, 2);
      g1 = __shfl_xor_sync(0xffffffffu, s1, 2);
      if (hi) {
        v[h][0] = g0;
        v[h][1] = g1;
      } else {
        v[h][2] = g0;
        v[h][3] = g1;
      }
      const int row = row0 + 8 * h;
      if (row < a.rows)
        *reinterpret_cast<uint4*>(out + (size_t)row * F + n0 + 8 * (4 * q + tig)) =
            make_uint4(v[h][0], v[h][1], v[h][2], v[h][3]);
    }
  }
}

// x's parts in TF32: hi = rna(x), lo = rna(x - hi).
__device__ __forceinline__ void split_tf32(float x, unsigned& hi, unsigned& lo) {
  hi = round_tf32(x);
  lo = round_tf32(__fsub_rn(x, __uint_as_float(hi)));
}

// The m16n8k8 A fragment of 16 rows at k8 step kk of an fp32 k block ([rows][32] in the
// 128-byte swizzle; `row` points at its row r0 + g, column t), split into TF32 parts: a[0]
// row g column t, a[1] row g + 8, a[2] row g column t + 4, a[3] row g + 8 column t + 4. r0 % 8
// == 0, so rows g and g + 8 share one swizzle; each fragment's 32 loads fall on 32 banks.
__device__ __forceinline__ void a_frag_tf32(const float* row, int r, int kk, unsigned (&hi)[4],
                                            unsigned (&lo)[4]) {
  constexpr int BK = Tile<float>::BK;
  const int c0 = ((2 * kk) ^ (r & 7)) << 2, c1 = ((2 * kk + 1) ^ (r & 7)) << 2;
  const float x[4] = {row[c0], row[8 * BK + c0], row[c1], row[8 * BK + c1]};
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
}

// The B fragment of n8 tile row n at k8 step kk (rows t and t + 4 of the step, column g:
// `wrow` points at row n, column t), split into TF32 parts.
__device__ __forceinline__ void b_frag_tf32(const float* wrow, int n, int kk, unsigned (&hi)[2],
                                            unsigned (&lo)[2]) {
  split_tf32(wrow[((2 * kk) ^ (n & 7)) << 2], hi[0], lo[0]);
  split_tf32(wrow[((2 * kk + 1) ^ (n & 7)) << 2], hi[1], lo[1]);
}

// acc += a b in 3xTF32: lo hi, hi lo, hi hi into the fp32 accumulator, in that order.
__device__ __forceinline__ void mma_3xtf32(float (&acc)[4], const unsigned (&ahi)[4],
                                           const unsigned (&alo)[4], const unsigned (&bhi)[2],
                                           const unsigned (&blo)[2]) {
  mma_tf32(acc, alo, bhi[0], bhi[1]);
  mma_tf32(acc, ahi, blo[0], blo[1]);
  mma_tf32(acc, ahi, bhi[0], bhi[1]);
}

}  // namespace pcdiff_wide
