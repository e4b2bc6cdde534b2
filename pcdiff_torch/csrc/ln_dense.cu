// Fused LayerNorm -> 1 to 3 projections with a bias + activation epilogue, forward, for
// Hopper (sm_90a). x [rows, C] row-major; for each output i, W_i [F_i, C] (the nn.Linear
// layout) in the product dtype (bf16 for bf16 outputs, cast by the wrapper; fp32 for fp32
// outputs), an optional fp32 bias [F_i], and out_i [rows, F_i].
//
// Replaces the TPU kernel pcdiff/ops/ln_dense.py::_ln_denses_kernel (launched by
// _pallas_ln_denses, reached through fused_ln_denses). It computes
//     out_i = act_i(LN(x) W_i^T + b_i)
// with fp32 LayerNorm statistics by the fast-variance formula max(0, E[x^2] - E[x]^2) and
// the fp32 affine, the normalised rows cast to the product dtype, fp32 accumulation, bias
// and activation applied to the fp32 accumulator, and one cast out. The activations are
// those of _apply_act with the _erf_f32 rational: none, gelu (exact-erf form through the
// rational, clamped to [-4, 4]), gelu_tanh and quick_gelu (sigmoid forms with the exp
// argument clamped to +-30), with round-to-nearest intrinsics, op for op as the plain
// PyTorch version.
//
// What bounds it on the H100: at C = 256 the products are short (256 deep) and the outputs
// wide (up to 3 x 256 or 1024 columns a row), so the outputs' bytes bind (a 2B-row sampler
// call writes ~5.8 GB of bf16 outputs: ~1.7 ms of the card's 3.35 TB/s), with the tensor-core
// products (~1.5 ms) and the exact GELU epilogue (~1.7 G elements of __fdiv_rn and expf, the
// same order) beside it; the normalised tensor is the traffic this kernel exists to remove
// (it never reaches device memory). Every block reads W again, from L2.
// What the design does about it: the loop of ln_dense_fwd.cuh. 128 rows a block,
// normalised once into a resident shared-memory panel while the first W stages load; W in
// the product dtype through a cp.async ring, one barrier a stage; wgmma reading both
// operands from swizzled shared memory, with the accumulators and the epilogue in registers
// (bf16 path, two blocks an SM), or an 8 x 8 FMA register tile a thread fed by 16-byte shared
// loads (fp32 path, no TF32); outputs stored from registers. The outputs' column tiles are
// split into `groups` per 128-row tile (the wrapper picks the count that balances the waves
// on the card's SMs, from pcdiff_ln_denses_tiling), each block normalising its rows again:
// C = 256 makes that cheap against its share of the products.
//
// Wide rows, 256 < C <= 1024 (Point-E's 512, the CLIP text tower's 768, ViT-L/14's 1024):
// bound by the products at C = 512 (LN(x) W^T, ~2 rows C F operations against ~C + F bytes a
// row), by the bytes of x, W and the outputs at the towers' few rows. Beside the products,
// two costs are a block's own: bringing its x rows in and normalising them (once a block, not
// once a column tile), and streaming W, which every row tile reads again from L2.
// What the design does about it (ln_denses_wide_kernel, both output dtypes): K5's
// warp-specialised shape. A producer warpgroup gives its registers to two consumer warpgroups
// (setmaxnreg 40 / 232); its one thread loads the block's x rows into the resident panel by the
// TMA, in k blocks of 128-byte rows in the 128-byte swizzle (zero fill past C and the rows),
// then streams W's boxes of 128 rows x one k block through a 6-slot ring with full and empty
// mbarriers (tensor maps from cuTensorMapEncodeTiled, tma_host.cuh). The consumers normalise
// the panel in place, four of a warp's rows at a time (normalising each k block just before
// the first tile's products of it measured slower: a barrier a k block). The panel holds the most
// of 128, 64 or 32 rows whose k blocks take at most 128 KB, so with the ring one block an SM.
// bf16 outputs (the panel in bf16: 128 rows up to C = 512, 64 past it): wgmma from the panel
// and the W stage, m64n128k16 with each warpgroup 64 of the rows, or at 64 rows m64n64k16 with
// each warpgroup 64 of the stage's 128 columns; one wgmma group in flight (wgmma_wait<1>), a
// slot released as soon as its products are done; both warpgroups read every stage, so the
// exact GELU's epilogue (~45 instructions an element) runs on all eight warps at once
// (warpgroups on alternate tiles, taking turns on the tensor cores, measured faster at the qkv
// sites and slower at fc1, where one warpgroup's epilogue outlasts the other's products). fp32
// outputs (the panel in fp32: 64 rows up to C = 512, 32 past it): 3xTF32 on mma.sync m16n8k8
// (each operand split into TF32 parts hi = rna(x), lo = rna(x - hi); per 8-deep step lo hi, hi
// lo and hi hi into the fp32 accumulator, as K7's fp32 path), 8 warps of 16 or 32 rows by 32
// columns of a tile, the fragments read from the swizzled panel and stage on 32 banks. Both
// epilogues take the activation's divisions on DivFast, with the DivRn retake for a group of
// elements with an operand outside the fast path's range. x in the other dtype than the
// product's (off the path) is normalised from device memory instead.
// Numerics: the statistics by the fast-variance formula, lane l of a warp summing the row's
// 8-element chunks l, l + 32, ... in order, then across the warp by an xor butterfly; the
// fp32 affine, (x - mean) rstd scale + bias; rounded once to the product dtype.

#include <cstdint>
#include <type_traits>

#include "ln_dense_fwd.cuh"
#include "ln_wide.cuh"
#include "tma_host.cuh"

namespace {

using namespace pcdiff_ptx;
using pcdiff_ln::Args;
using pcdiff_ln::bf16;
using pcdiff_ln::Path;

template <typename TX, typename TO>
__global__ void __launch_bounds__(pcdiff_ln::THREADS, Path<TO>::MIN_BLOCKS)
ln_denses_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  pcdiff_ln::ln_dense_block<TX, TO>(a, smem);
}


// ---- wide rows (MAX_C < C <= MAX_C_WIDE): the normalised panel resident, W streamed ----

constexpr int MAX_C_WIDE = pcdiff_wide::MAX_C;

namespace wide {

using namespace pcdiff_wide;
constexpr int BN = 128;                       // output columns a tile
constexpr int STAGES = 6;                     // W boxes in the ring
constexpr int STAGE_BYTES = BN * BOX_BYTES;   // a W stage: BN rows of one k block, 16 KB
constexpr int PANEL_BYTES = 128 * 1024;       // the resident panel at most

// The panel's rows: the most of 128, 64, 32 whose panel takes at most PANEL_BYTES (bf16: 128
// up to C = 512, 64 past it; fp32: 64 up to C = 512, 32 past it).
template <typename TO>
__host__ __device__ constexpr int panel_rows(int c) {
  return 128 * kext<TO>(c) * (int)sizeof(TO) <= PANEL_BYTES  ? 128
         : 64 * kext<TO>(c) * (int)sizeof(TO) <= PANEL_BYTES ? 64
                                                              : 32;
}

template <typename TO>
size_t smem_bytes(int c) {
  return SMEM_ALIGN + (size_t)panel_rows<TO>(c) * kext<TO>(c) * sizeof(TO) +
         (size_t)STAGES * STAGE_BYTES + (2 * STAGES + 1) * sizeof(unsigned long long);
}

int block_rows(int c, bool out_bf16) {
  return out_bf16 ? panel_rows<bf16>(c) : panel_rows<float>(c);
}

struct WideArgs {
  CUtensorMap w_map[pcdiff_ln::MAX_OUT];  // W_i [F_i, C] in the product dtype: boxes of BN
                                          // rows x one k block
  CUtensorMap x_map;                      // x [rows, C] (x in the product dtype): boxes of
                                          // the panel's rows x one k block
  Args ln;
};

// The block's rows and its share of the outputs' tiles: block (row tile, group) of a 1-D grid.
struct Block {
  int r0, t_lo, t_hi;
};

template <int PR>
__device__ __forceinline__ Block block_of(const Args& a) {
  const int tiles = pcdiff_ln::total_tiles<bf16>(a);  // BN-column tiles (both paths)
  const int g = (int)(blockIdx.x % (unsigned)a.groups);
  Block b;
  b.r0 = (int)(blockIdx.x / (unsigned)a.groups) * PR;
  b.t_lo = (int)((long long)g * tiles / a.groups);
  b.t_hi = (int)((long long)(g + 1) * tiles / a.groups);
  return b;
}

// The producer's one thread: the panel's x boxes (x in the product dtype), then every W stage
// of the block's sequence (tile t_lo + s / kc_n, k block s % kc_n) into the ring by the TMA,
// each slot refilled once the eight consumer warps have released it.
template <typename TX, typename TO, int PR>
__device__ __forceinline__ void produce(const WideArgs& wa, TO* sa, TO* ring,
                                        unsigned long long* full, unsigned long long* empty,
                                        unsigned long long* xbar, const Block& bk, int kc_n) {
  constexpr int BK = Tile<TO>::BK;
  if constexpr (std::is_same<TX, TO>::value) {
    mbar_expect_tx(xbar, (unsigned)(PR * kc_n * BOX_BYTES));
    for (int kb = 0; kb < kc_n; ++kb)
      tma_load_2d(sa + kb * PR * BK, &wa.x_map, xbar, kb * BK, bk.r0);
  }
  const int stages = (bk.t_hi - bk.t_lo) * kc_n;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    const int slot = s % STAGES, use = s / STAGES;
    if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
    int n0;
    const int o = pcdiff_ln::tile_output<TO>(wa.ln, bk.t_lo + s / kc_n, n0);
    mbar_expect_tx(&full[slot], STAGE_BYTES);
    tma_load_2d(ring + slot * (STAGE_BYTES / (int)sizeof(TO)), &wa.w_map[o], &full[slot],
                (s % kc_n) * BK, n0);
  }
}

// ---- bf16 products: wgmma ----

// A consumer warpgroup's products and epilogues over the block's tiles. PR = 128: its 64
// rows by the tile's 128 columns; PR = 64: the 64 rows by its 64 of the tile's columns. Both
// warpgroups read every stage, so their epilogues run together on all eight warps. One wgmma
// group stays in flight: a stage's slot is released once the next stage's products are
// issued and its own are done.
template <int PR>
__device__ __forceinline__ void products_bf16(const Args& a, const bf16* sa, const bf16* ring,
                                              unsigned long long* full,
                                              unsigned long long* empty, const Block& bk) {
  constexpr int BK = Tile<bf16>::BK;
  constexpr int N = PR == 128 ? BN : BN / 2;  // the warpgroup's columns of a tile
  const int wg = threadIdx.x / 128, lane = threadIdx.x % 32;
  const bf16* a_wg = sa + (PR == 128 ? wg * 64 * BK : 0);  // its rows of every k block
  const int b_off = PR == 128 ? 0 : wg * (BN / 2) * BK;    // its columns of every stage
  const int row_base = bk.r0 + (PR == 128 ? 64 * wg : 0);
  const int kc_n = kext<bf16>(a.c) / BK;
  float acc[N / 2];
  int s = 0;
#pragma unroll 1
  for (int t = bk.t_lo; t < bk.t_hi; ++t) {
#pragma unroll 1
    for (int kc = 0; kc < kc_n; ++kc, ++s) {
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
      const bf16* ws = ring + (s % STAGES) * (STAGE_BYTES / 2) + b_off;
      const bf16* as = a_wg + kc * (PR * BK);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks)
        wgmma_m64k16<N>(acc, sw128_desc(as + 16 * ks), sw128_desc(ws + 16 * ks),
                        kc > 0 || ks > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: release its slot
      if (kc > 0 && lane == 0) mbar_arrive(&empty[(s - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    if (lane == 0) mbar_arrive(&empty[(s - 1) % STAGES]);
    int n0;
    const int o = pcdiff_ln::tile_output<bf16>(a, t, n0);
    n0 += PR == 128 ? 0 : wg * (BN / 2);
    switch (a.act[o]) {
      case pcdiff_ln::ACT_GELU:
        wide_epilogue_bf16<pcdiff_ln::ACT_GELU, N>(a, o, n0, row_base, acc); break;
      case pcdiff_ln::ACT_GELU_TANH:
        wide_epilogue_bf16<pcdiff_ln::ACT_GELU_TANH, N>(a, o, n0, row_base, acc); break;
      case pcdiff_ln::ACT_QUICK_GELU:
        wide_epilogue_bf16<pcdiff_ln::ACT_QUICK_GELU, N>(a, o, n0, row_base, acc); break;
      default: wide_epilogue_bf16<pcdiff_ln::ACT_NONE, N>(a, o, n0, row_base, acc);
    }
  }
}

// ---- fp32 products: 3xTF32 on mma.sync ----

// acc += the warp's rows of one k block of the panel (`ak`: its [PR][32] swizzled rows) times
// its columns of the W stage, in 3xTF32: per 8-deep step lo hi, hi lo, hi hi. Warp w: rows
// (w / 4) 16 MT + 16 mt + g (+ 8), columns (w % 4) 32 + 8 nt + g of the stage; the m16n8k8
// fragments of ptx.cuh's mma_tf32, each fragment's 32 loads on 32 banks.
template <int MT>
__device__ __forceinline__ void stage_3xtf32(float (&acc)[MT][4][4], const float* ak,
                                             const float* ws) {
  constexpr int BK = Tile<float>::BK;
  const int warp = (threadIdx.x / 32) % WARPS, lane = threadIdx.x % 32, g = lane >> 2,
            t = lane & 3;
  const int r0 = (warp / 4) * 16 * MT + g;  // (r0 + 8) % 8 == r0 % 8: one swizzle for both
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    unsigned ahi[MT][4], alo[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = r0 + 16 * mt;
      a_frag_tf32(ak + r * BK + t, r, kk, ahi[mt], alo[mt]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = (warp % 4) * 32 + 8 * nt + g;
      unsigned bhi[2], blo[2];
      b_frag_tf32(ws + n * BK + t, n, kk, bhi, blo);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) mma_3xtf32(acc[mt][nt], ahi[mt], alo[mt], bhi, blo);
    }
  }
}

template <int ACT, int MT, typename Div>
__device__ __forceinline__ void act_tile(const float (&acc)[MT][4][4], const float2 (&b)[4],
                                         bool hb, float (&v)[MT][4][4], Div div) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[mt][nt][e] = pcdiff_ln::bias_act<ACT>(acc[mt][nt][e], hb, e & 1 ? b[nt].y : b[nt].x,
                                                div);
}

// The bias, activation (DivFast, the DivRn retake) and float2 stores of the warp's share of a
// finished tile (columns n0 .. of output o, block rows r0 ..).
template <int ACT, int MT>
__device__ __forceinline__ void wide_epilogue_fp32(const Args& a, int o, int n0, int r0,
                                                   const float (&acc)[MT][4][4]) {
  const int F = a.f[o];
  const float* bias = a.b[o];
  float* out = static_cast<float*>(a.out[o]);
  const bool hb = bias != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int c0 = n0 + (warp % 4) * 32 + 2 * t, row0 = r0 + (warp / 4) * 16 * MT + g;
  float2 b[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
    b[nt] = hb && c0 + 8 * nt < F ? *reinterpret_cast<const float2*>(bias + c0 + 8 * nt)
                                  : make_float2(0.f, 0.f);
  float v[MT][4][4];
  bool ok = true;
  act_tile<ACT, MT>(acc, b, hb, v, pcdiff_ln::DivFast{ok});
  if (!ok) act_tile<ACT, MT>(acc, b, hb, v, pcdiff_ln::DivRn());
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 16 * mt + 8 * h;
      if (row >= a.rows) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        if (c0 + 8 * nt < F)  // F % 64 == 0: a tile's last 64 columns may lie past F
          *reinterpret_cast<float2*>(out + (size_t)row * F + c0 + 8 * nt) =
              make_float2(v[mt][nt][2 * h], v[mt][nt][2 * h + 1]);
    }
}

// The consumer warps' products and epilogues over the block's tiles: each stage's 3xTF32
// products, then its slot released.
template <int PR>
__device__ __forceinline__ void products_fp32(const Args& a, const float* sa,
                                              const float* ring, unsigned long long* full,
                                              unsigned long long* empty, const Block& bk) {
  constexpr int BK = Tile<float>::BK, MT = PR / 32;  // a warp's m16 tiles: PR / 2 rows
  const int lane = threadIdx.x % 32, kc_n = kext<float>(a.c) / BK;
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  int s = 0;
#pragma unroll 1
  for (int t = bk.t_lo; t < bk.t_hi; ++t) {
#pragma unroll 1
    for (int kc = 0; kc < kc_n; ++kc, ++s) {
      mbar_wait(&full[s % STAGES], (s / STAGES) & 1);
      stage_3xtf32<MT>(acc, sa + kc * (PR * BK), ring + (s % STAGES) * (STAGE_BYTES / 4));
      if (lane == 0) mbar_arrive(&empty[s % STAGES]);  // its fragments are in registers
    }
    int n0;
    const int o = pcdiff_ln::tile_output<float>(a, t, n0);
    switch (a.act[o]) {
      case pcdiff_ln::ACT_GELU:
        wide_epilogue_fp32<pcdiff_ln::ACT_GELU, MT>(a, o, n0, bk.r0, acc); break;
      case pcdiff_ln::ACT_GELU_TANH:
        wide_epilogue_fp32<pcdiff_ln::ACT_GELU_TANH, MT>(a, o, n0, bk.r0, acc); break;
      case pcdiff_ln::ACT_QUICK_GELU:
        wide_epilogue_fp32<pcdiff_ln::ACT_QUICK_GELU, MT>(a, o, n0, bk.r0, acc); break;
      default: wide_epilogue_fp32<pcdiff_ln::ACT_NONE, MT>(a, o, n0, bk.r0, acc);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
  }
}

template <typename TX, typename TO, int PR>
__global__ void __launch_bounds__(THREADS, 1)
ln_denses_wide_kernel(const __grid_constant__ WideArgs wa) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Args& a = wa.ln;
  TO* sa = reinterpret_cast<TO*>(
      smem + ((SMEM_ALIGN - (smem_u32(smem) & (SMEM_ALIGN - 1))) & (SMEM_ALIGN - 1)));
  const int kx = kext<TO>(a.c);
  TO* ring = sa + PR * kx;
  unsigned long long* full =
      reinterpret_cast<unsigned long long*>(ring + STAGES * (STAGE_BYTES / (int)sizeof(TO)));
  unsigned long long* empty = full + STAGES;
  unsigned long long* xbar = empty + STAGES;
  const Block bk = block_of<PR>(a);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_init(xbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == CONSUMERS)
      produce<TX, TO, PR>(wa, sa, ring, full, empty, xbar, bk, kx / Tile<TO>::BK);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    panel<TX, TO, PR>(a, bk.r0, sa, xbar, kx);
    fence_proxy_async();  // the panel's writes, for wgmma's reads
    named_sync(BAR_CONSUMERS, CONSUMERS);  // every warp's rows, for every warp's products
    if constexpr (std::is_same<TO, bf16>::value)
      products_bf16<PR>(a, sa, ring, full, empty, bk);
    else
      products_fp32<PR>(a, sa, ring, full, empty, bk);
  }
}

// ---- launch ----

// Lets `kernel` use `smem` bytes of dynamic shared memory (once per size and kernel).
template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, size_t& configured) {
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  return 0;
}

// The instantiation for (TX, TO) at width c and its shared memory, configured; then
// `fn(kernel, smem)`.
template <typename TX, typename TO, typename Fn>
int with_kernel(int c, Fn&& fn) {
  constexpr int TALL = std::is_same<TO, bf16>::value ? 128 : 64;  // panel_rows<TO>'s two
  static size_t configured[2] = {0, 0};
  const size_t smem = smem_bytes<TO>(c);
  const bool tall = panel_rows<TO>(c) == TALL;
  auto kernel =
      tall ? ln_denses_wide_kernel<TX, TO, TALL> : ln_denses_wide_kernel<TX, TO, TALL / 2>;
  if (const int e = set_smem(kernel, smem, configured[tall])) return e;
  return fn(kernel, smem);
}

template <typename TX, typename TO>
int launch(const Args& a, cudaStream_t stream) {
  constexpr bool FP32 = std::is_same<TO, float>::value;
  constexpr int BK = Tile<TO>::BK;
  const int pr = panel_rows<TO>(a.c);
  WideArgs wa = {};
  wa.ln = a;
  for (int i = 0; i < a.n_out; ++i) {
    const cuuint64_t dims[2] = {(cuuint64_t)a.c, (cuuint64_t)a.f[i]};
    const cuuint64_t strides[1] = {(cuuint64_t)a.c * sizeof(TO)};
    const cuuint32_t box[2] = {BK, BN};
    if (const int e = pcdiff_tma::tensor_map(&wa.w_map[i], a.w[i], 2, dims, strides, box, FP32))
      return e;
  }
  if constexpr (std::is_same<TX, TO>::value) {
    const cuuint64_t dims[2] = {(cuuint64_t)a.c, (cuuint64_t)a.rows};
    const cuuint64_t strides[1] = {(cuuint64_t)a.c * sizeof(TX)};
    const cuuint32_t box[2] = {BK, (cuuint32_t)pr};
    if (const int e = pcdiff_tma::tensor_map(&wa.x_map, a.x, 2, dims, strides, box, FP32))
      return e;
  }
  const unsigned blocks = (unsigned)((a.rows - 1) / pr + 1) * (unsigned)a.groups;
  return with_kernel<TX, TO>(a.c, [&](auto kernel, size_t smem) {
    kernel<<<blocks, THREADS, smem, stream>>>(wa);
    return (int)cudaGetLastError();
  });
}

template <typename TX, typename TO>
int occupancy(int c, int* blocks_per_sm) {
  return with_kernel<TX, TO>(c, [&](auto kernel, size_t smem) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, THREADS,
                                                              smem);
  });
}

}  // namespace wide

// ---- launch ----

// Lets the narrow kernel use `smem` bytes of dynamic shared memory (once per instantiation
// and size).
template <typename TX, typename TO>
int configure(size_t smem) {
  static size_t configured = 0;
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_denses_kernel<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  return 0;
}

// Rows a block at width c: the narrow kernel's BM, or the wide one's panel.
int block_rows(int c, bool out_bf16) {
  return c <= pcdiff_ln::MAX_C ? pcdiff_ln::BM : wide::block_rows(c, out_bf16);
}

template <typename TX, typename TO>
int launch(const Args& a, cudaStream_t stream) {
  if (a.c > pcdiff_ln::MAX_C) return wide::launch<TX, TO>(a, stream);
  const size_t smem = pcdiff_ln::smem_bytes<TO>(a.c);
  if (const int e = configure<TX, TO>(smem)) return e;
  const unsigned blocks = (unsigned)((a.rows - 1) / pcdiff_ln::BM + 1) * (unsigned)a.groups;
  ln_denses_kernel<TX, TO><<<blocks, pcdiff_ln::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int occupancy(int c, int* blocks_per_sm) {
  if (c > pcdiff_ln::MAX_C) return wide::occupancy<TX, TO>(c, blocks_per_sm);
  const size_t smem = pcdiff_ln::smem_bytes<TO>(c);
  if (const int e = configure<TX, TO>(smem)) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ln_denses_kernel<TX, TO>, pcdiff_ln::THREADS, smem);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, ln_scale, ln_bias: device pointers (ln params fp32). w, b, out, f, act: HOST arrays of
// n_out entries (b[i] may be null); w[i] is bf16 when out_bf16, fp32 otherwise. Requires
// 0 < c <= 1024, c % 32 == 0, every f[i] % 64 == 0, 1 <= groups <= the outputs' column tiles
// (128 columns each), and 16-byte aligned pointers. x_bf16 /
// out_bf16 select the input and output dtypes (the product dtype is the output's). Returns
// the cudaError_t of the launch (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_ln_denses_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                    int n_out, const void* const* w, const void* const* b,
                                    void* const* out, const int* f, const int* act, int rows,
                                    int c, float eps, int x_bf16, int out_bf16, int groups,
                                    void* stream) {
  if (n_out < 1 || n_out > pcdiff_ln::MAX_OUT || rows <= 0 || c <= 0 ||
      c > MAX_C_WIDE || c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(ln_scale) || !aligned16(ln_bias))
    return (int)cudaErrorMisalignedAddress;
  const int bn = out_bf16 ? Path<bf16>::BN : Path<float>::BN;
  Args a;
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  int tiles = 0;
  for (int i = 0; i < pcdiff_ln::MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && (f[i] <= 0 || f[i] % 64 != 0 || act[i] < pcdiff_ln::ACT_NONE ||
               act[i] > pcdiff_ln::ACT_QUICK_GELU))
      return (int)cudaErrorInvalidValue;
    if (on && (!aligned16(w[i]) || !aligned16(out[i]) || !aligned16(b[i])))
      return (int)cudaErrorMisalignedAddress;
    a.w[i] = on ? w[i] : nullptr;
    a.b[i] = on ? static_cast<const float*>(b[i]) : nullptr;
    a.out[i] = on ? out[i] : nullptr;
    a.f[i] = on ? f[i] : 0;
    a.act[i] = on ? act[i] : pcdiff_ln::ACT_NONE;
    if (on) tiles += (f[i] + bn - 1) / bn;
  }
  const long long row_tiles = (rows - 1) / block_rows(c, out_bf16 != 0) + 1;
  if (groups < 1 || groups > tiles || row_tiles * groups > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  a.n_out = n_out;
  a.rows = rows;
  a.c = c;
  a.groups = groups;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) return out_bf16 ? launch<bf16, bf16>(a, s) : launch<bf16, float>(a, s);
  return out_bf16 ? launch<float, bf16>(a, s) : launch<float, float>(a, s);
}

// The forward kernel's tiling for the x_bf16 / out_bf16 instantiation at width c (0 < c <=
// 1024, c % 32 == 0; past 256 the wide kernels'), for the wrapper's choice of column groups:
// rows a block, output columns a tile, and how many blocks an SM of the current device holds
// at once at the launch's shared memory (the occupancy API). Returns the cudaError_t (0 on
// success).
extern "C" int pcdiff_ln_denses_tiling(int x_bf16, int out_bf16, int c, int* bm, int* bn,
                                       int* blocks_per_sm) {
  if (c <= 0 || c > MAX_C_WIDE || c % 32 != 0) return (int)cudaErrorInvalidValue;
  *bm = block_rows(c, out_bf16 != 0);
  *bn = out_bf16 ? Path<bf16>::BN : Path<float>::BN;
  if (x_bf16)
    return out_bf16 ? occupancy<bf16, bf16>(c, blocks_per_sm)
                    : occupancy<bf16, float>(c, blocks_per_sm);
  return out_bf16 ? occupancy<float, bf16>(c, blocks_per_sm)
                  : occupancy<float, float>(c, blocks_per_sm);
}
