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
// the resident panel does not fit. At C = 1024 it would take 256 KB in bf16 and 520 KB in
// fp32, past an SM's 227 KB. Shrinking the row tile with C (64 rows and one warpgroup) would
// keep it resident in bf16 only, and change the epilogues, the thread layout of the FMA tile
// and the occupancy of both paths. Instead the block keeps its 128 rows, 8 warps, its W ring,
// its products and its epilogues, and streams the normalised panel: a statistics pass first
// (each warp 16 rows: the row's fp32 sum and sum of squares, lane by lane over 8-element
// chunks and across the warp by shuffles; mean, the fast variance and rsqrtf into shared
// memory), then beside each W stage the matching k block of LN(x) (128 rows x 64 bf16 in the
// 128-byte swizzle wgmma reads, or 128 rows x 32 fp32 of pitch 36 for the FMA tile), read from
// x again (L2), normalised with the stored statistics and rounded to the product dtype. The A
// ring has the W ring's three stages; the k block of stage s + 2 is written while stage s's
// wgmma runs (after its FMA stage in fp32), into the slot of stage s - 1, which the stage's
// barrier has freed. Both rings take 96 KB (bf16) or 102 KB (fp32): two blocks an SM in bf16.
// The cost: x is read and normalised once a column tile of the block's group, not once, which
// at these widths is a few percent of the products' work. The numerics are the resident
// panel's: the same statistics formula (summed in another order), fp32 affine, one rounding.

#include <cstdint>
#include <type_traits>

#include "ln_dense_fwd.cuh"

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

// ---- wide rows (MAX_C < C <= MAX_C_WIDE): the normalised panel streamed in k blocks ----

using pcdiff_ln::BM;
using pcdiff_ln::THREADS;

constexpr int MAX_C_WIDE = 1024;

// An A stage: one k block of the normalised rows, beside the W stage of the same k.
template <typename TO>
struct Wide {
  static constexpr bool BF16 = std::is_same<TO, bf16>::value;
  static constexpr int BK = Path<TO>::BK;        // 64 (bf16) or 32 (fp32) deep, as W's stages
  static constexpr int STAGES = Path<TO>::STAGES;
  static constexpr int LDA = BF16 ? BK : BK + 4;  // bf16: 128-byte swizzled rows; fp32: pitch 36
  static constexpr int A_STAGE = BM * LDA;        // elements
  static constexpr int PER = BF16 ? 8 : 4;        // elements a 16-byte store
};

template <typename TO>
size_t wide_smem_bytes() {
  using W = Wide<TO>;
  return (size_t)W::STAGES * (W::A_STAGE + pcdiff_ln::stage_elems<TO>()) * sizeof(TO) +
         BM * sizeof(float2) + pcdiff_ln::SMEM_ALIGN;
}

template <typename TX>
__device__ __forceinline__ void load8(const TX* src, float (&v)[8]) {
  if constexpr (std::is_same<TX, bf16>::value) {
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

// The block's rows' (mean, rstd) into `stats`: warp w takes rows 16 w .. 16 w + 15, lane l the
// 8-element chunks l, l + 32, ... of a row (C % 32 == 0: C / 8 chunks, at most 128). Rows past
// `rows` get (0, 0), so their normalised values are the LN bias: finite and never stored.
template <typename TX>
__device__ __forceinline__ void wide_stats(const Args& a, int r0, float2* stats) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int C = a.c, chunks = C / 8;
  const TX* x = static_cast<const TX*>(a.x);
#pragma unroll 2
  for (int i = 0; i < BM / pcdiff_ln::WARPS; ++i) {
    const int rl = warp * (BM / pcdiff_ln::WARPS) + i, row = r0 + rl;
    float s = 0.f, s2 = 0.f;
    if (row < a.rows) {
      const TX* src = x + (size_t)row * C;
#pragma unroll
      for (int j = 0; j < MAX_C_WIDE / 256; ++j) {
        const int ch = lane + 32 * j;
        if (ch < chunks) {
          float v[8];
          load8<TX>(src + 8 * ch, v);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s = __fadd_rn(s, v[e]);
            s2 = __fadd_rn(s2, __fmul_rn(v[e], v[e]));
          }
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    if (lane == 0) {
      const float mean = __fdiv_rn(s, (float)C);
      const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mean, mean)), 0.f);
      stats[rl] = row < a.rows ? make_float2(mean, rsqrtf(__fadd_rn(var, a.eps)))
                               : make_float2(0.f, 0.f);
    }
  }
}

// The k block of stage s (k chunk s % kc_n) of LN(x) into A slot `dst`: 128 rows x BK columns,
// read from x, normalised with `stats`, the fp32 affine, rounded to TO. Columns past C are
// zeros. bf16: the 128-byte swizzle of a_at's k block; fp32: rows of pitch LDA.
template <typename TX, typename TO>
__device__ __forceinline__ void wide_a_stage(const Args& a, int r0, int kc, const float2* stats,
                                             TO* dst) {
  using W = Wide<TO>;
  constexpr int CH = W::BK / W::PER;  // 16-byte chunks a row: 8
  const int C = a.c, k0 = kc * W::BK;
  const TX* x = static_cast<const TX*>(a.x);
#pragma unroll
  for (int j = 0; j < BM * CH / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / CH, ch = i % CH, col = k0 + ch * W::PER;
    float y[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) y[e] = 0.f;
    if (col < C && r0 + r < a.rows) {
      const float2 st = stats[r];
      const TX* src = x + (size_t)(r0 + r) * C + col;
      float v[8];
      if constexpr (W::BF16) {
        load8<TX>(src, v);
      } else if constexpr (std::is_same<TX, bf16>::value) {
        const uint2 raw = *reinterpret_cast<const uint2*>(src);
        const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = __bfloat162float(h[e]);
      } else {
        const float4 p = *reinterpret_cast<const float4*>(src);
        v[0] = p.x; v[1] = p.y; v[2] = p.z; v[3] = p.w;
      }
#pragma unroll
      for (int e = 0; e < W::PER; ++e)
        y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[e], st.x), st.y),
                                   __ldg(a.ln_scale + col + e)),
                         __ldg(a.ln_bias + col + e));
    }
    if constexpr (W::BF16) {
      *reinterpret_cast<uint4*>(dst + r * W::LDA + ((ch ^ (r & 7)) << 3)) =
          make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]),
                     pack_bf16(y[6], y[7]));
    } else {
      *reinterpret_cast<float4*>(dst + r * W::LDA + ch * W::PER) =
          make_float4(y[0], y[1], y[2], y[3]);
    }
  }
}

// The wide block: the statistics, then the outputs' tiles of the block's group with the A and
// W rings in step, and K3's epilogues.
template <typename TX, typename TO>
__device__ __forceinline__ void wide_block(const Args& a, unsigned char* smem) {
  using W = Wide<TO>;
  using P = Path<TO>;
  TO* aring = reinterpret_cast<TO*>(
      smem + ((pcdiff_ln::SMEM_ALIGN - (smem_u32(smem) & (pcdiff_ln::SMEM_ALIGN - 1))) &
              (pcdiff_ln::SMEM_ALIGN - 1)));
  TO* wring = aring + W::STAGES * W::A_STAGE;
  float2* stats = reinterpret_cast<float2*>(wring + W::STAGES * pcdiff_ln::stage_elems<TO>());
  const int r0 = pcdiff_ln::block_row0(a);
  const pcdiff_ln::Span sp = pcdiff_ln::block_span<TO>(a);

  pcdiff_ln::ring_start<TO>(a, sp, wring);
  wide_stats<TX>(a, r0, stats);
  __syncthreads();
#pragma unroll
  for (int s = 0; s < W::STAGES - 1; ++s)
    if (s < sp.stages) wide_a_stage<TX, TO>(a, r0, s % sp.kc_n, stats, aring + s * W::A_STAGE);

  if constexpr (W::BF16) {
    const int wg = threadIdx.x / 128;
    float acc[P::BN / 2];
#pragma unroll 1
    for (int s = 0; s < sp.stages; ++s) {
      const bf16* ws = pcdiff_ln::ring_step<bf16>(a, sp, wring, s);
      const int kc = s % sp.kc_n;
      const bf16* as = aring + (s % W::STAGES) * W::A_STAGE + wg * 64 * W::LDA;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < P::BK / 16; ++ks)
        wgmma_m64k16<P::BN>(acc, sw128_desc(as + 16 * ks), sw128_desc(ws + 16 * ks),
                            kc > 0 || ks > 0);
      wgmma_commit();
      const int sn = s + W::STAGES - 1;  // its slot is stage s - 1's, freed by the barrier
      if (sn < sp.stages)
        wide_a_stage<TX, TO>(a, r0, sn % sp.kc_n, stats, aring + (sn % W::STAGES) * W::A_STAGE);
      wgmma_wait<0>();
      if (kc == sp.kc_n - 1) {
        int n0;
        const int o = pcdiff_ln::tile_output<bf16>(a, sp.t_lo + s / sp.kc_n, n0);
        switch (a.act[o]) {
          case pcdiff_ln::ACT_GELU:
            pcdiff_ln::epilogue_bf16<pcdiff_ln::ACT_GELU>(a, o, n0, r0, acc); break;
          case pcdiff_ln::ACT_GELU_TANH:
            pcdiff_ln::epilogue_bf16<pcdiff_ln::ACT_GELU_TANH>(a, o, n0, r0, acc); break;
          case pcdiff_ln::ACT_QUICK_GELU:
            pcdiff_ln::epilogue_bf16<pcdiff_ln::ACT_QUICK_GELU>(a, o, n0, r0, acc); break;
          default: pcdiff_ln::epilogue_bf16<pcdiff_ln::ACT_NONE>(a, o, n0, r0, acc);
        }
      }
    }
  } else {
    const int ty = threadIdx.x / 16;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
    for (int s = 0; s < sp.stages; ++s) {
      const float* ws = pcdiff_ln::ring_step<float>(a, sp, wring, s);
      const int kc = s % sp.kc_n;
      pcdiff_ln::fma_stage_fp32<2>(acc, aring + (s % W::STAGES) * W::A_STAGE + ty * W::LDA,
                                   W::LDA, ws);
      const int sn = s + W::STAGES - 1;
      if (sn < sp.stages)
        wide_a_stage<TX, TO>(a, r0, sn % sp.kc_n, stats, aring + (sn % W::STAGES) * W::A_STAGE);
      if (kc == sp.kc_n - 1) {
        int n0;
        const int o = pcdiff_ln::tile_output<float>(a, sp.t_lo + s / sp.kc_n, n0);
        switch (a.act[o]) {
          case pcdiff_ln::ACT_GELU:
            pcdiff_ln::epilogue_fp32<pcdiff_ln::ACT_GELU>(a, o, n0, r0, acc); break;
          case pcdiff_ln::ACT_GELU_TANH:
            pcdiff_ln::epilogue_fp32<pcdiff_ln::ACT_GELU_TANH>(a, o, n0, r0, acc); break;
          case pcdiff_ln::ACT_QUICK_GELU:
            pcdiff_ln::epilogue_fp32<pcdiff_ln::ACT_QUICK_GELU>(a, o, n0, r0, acc); break;
          default: pcdiff_ln::epilogue_fp32<pcdiff_ln::ACT_NONE>(a, o, n0, r0, acc);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      }
    }
  }
  cp_async_wait<0>();
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(pcdiff_ln::THREADS, Path<TO>::MIN_BLOCKS)
ln_denses_wide_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  wide_block<TX, TO>(a, smem);
}

// ---- launch ----

// The instantiation for width c: the resident panel up to MAX_C, the streamed one past it.
template <typename TX, typename TO>
void (*kernel_for(int c))(const Args) {
  return c <= pcdiff_ln::MAX_C ? ln_denses_kernel<TX, TO> : ln_denses_wide_kernel<TX, TO>;
}

// Lets the instantiation for width c use `smem` bytes of dynamic shared memory (once per
// kernel and size).
template <typename TX, typename TO>
int configure(int c, size_t smem) {
  static size_t configured[2] = {0, 0};  // dynamic shared memory each kernel may use
  const int wide = c > pcdiff_ln::MAX_C;
  if (smem > configured[wide]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel_for<TX, TO>(c), cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured[wide] = smem;
  }
  return 0;
}

int row_tiles(int rows) { return (rows - 1) / pcdiff_ln::BM + 1; }

template <typename TO>
size_t smem_for(int c) {
  return c <= pcdiff_ln::MAX_C ? pcdiff_ln::smem_bytes<TO>(c) : wide_smem_bytes<TO>();
}

template <typename TX, typename TO>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_for<TO>(a.c);
  if (const int e = configure<TX, TO>(a.c, smem)) return e;
  const unsigned blocks = (unsigned)row_tiles(a.rows) * (unsigned)a.groups;
  kernel_for<TX, TO>(a.c)<<<blocks, pcdiff_ln::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int occupancy(int c, int* blocks_per_sm) {
  const size_t smem = smem_for<TO>(c);
  if (const int e = configure<TX, TO>(c, smem)) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel_for<TX, TO>(c), pcdiff_ln::THREADS, smem);
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
  if (groups < 1 || groups > tiles ||
      (long long)row_tiles(rows) * groups > 0x7fffffffLL)
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
// 1024, c % 32 == 0; past 256 the wide kernel's), for the wrapper's choice of column groups: rows a block, output columns
// a tile, and how many blocks an SM of the current device holds at once at the launch's
// shared memory (the occupancy API). Returns the cudaError_t (0 on success).
extern "C" int pcdiff_ln_denses_tiling(int x_bf16, int out_bf16, int c, int* bm, int* bn,
                                       int* blocks_per_sm) {
  if (c <= 0 || c > MAX_C_WIDE || c % 32 != 0) return (int)cudaErrorInvalidValue;
  *bm = pcdiff_ln::BM;
  *bn = out_bf16 ? Path<bf16>::BN : Path<float>::BN;
  if (x_bf16)
    return out_bf16 ? occupancy<bf16, bf16>(c, blocks_per_sm)
                    : occupancy<bf16, float>(c, blocks_per_sm);
  return out_bf16 ? occupancy<float, bf16>(c, blocks_per_sm)
                  : occupancy<float, float>(c, blocks_per_sm);
}
