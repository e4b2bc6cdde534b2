// Fused LayerNorm -> 1 to 3 projections, backward, for Hopper (sm_90a). x [rows, C]
// row-major; for each output i: W_i [F_i, C] (the nn.Linear layout; fp32 on the fp32 path, its
// bf16 copy on the bf16 path), an optional fp32
// bias [F_i], the activation act_i, and the gradient g_i [rows, F_i] of out_i.
//
// Replaces the TPU kernel pcdiff/ops/ln_dense.py::_ln_denses_bwd_kernel (launched by
// _pallas_ln_denses_bwd, the backward of fused_ln_denses). With the forward's y = the
// LayerNorm of x cast to the product dtype (bf16 when the output is bf16, fp32 when it is
// fp32) and z_i = y W_i^T + b_i recomputed, it forms
//     gz_i = g_i act_i'(z_i)                 (fp32; db_i = its column sums, fp32)
//     dW_i = gz_i^T y,  dy = sum_i gz_i W_i   (gz_i rounded to the product dtype)
//     dscale = sum_rows dy xhat,  dbias = sum_rows dy
//     dx = rstd (dy scale - mean_c(dy scale) - xhat mean_c(dy scale xhat))
// in the TPU kernel's numerics class: fast-variance fp32 LN statistics, fp32 products in
// the fp32 model and bf16 products (fp32 accumulation) in the bf16 model, fp32 parameter
// gradients summed over all rows, dx in x's dtype. act' is _act_grad's formula, evaluated
// with round-to-nearest intrinsics in its order.
//
// What bounds it on the H100: the products, 2 (2 + [act]) rows C F_i FLOPs per output
// (the z recompute where there is an activation, dy and dW), at the fp32 FMA rate in the
// fp32 model (the train step's: 43.9 ms of a step at 67 TFLOP/s); in the bf16 model the
// products (16.2 GFLOP at a qkv z site, ~16 us at 989 TFLOP/s) and the bytes (x, g_i, dx:
// ~53 MB there, ~16 us at 3.35 TB/s) weigh alike, so every intermediate that leaves the chip
// costs about as much as a product. The three products contract over different axes with
// their operands as stored: z over C (y rows, W rows: K3's own product), dy over F (gz rows,
// and W's [F, C] rows, which are K-major for the fp32 loop and MN-major for wgmma), dW over
// the rows (gz and y, both K-major for the fp32 loop, both MN-major for wgmma).
// What has no counterpart: the TPU kernel sums dW_i, db_i, dscale and dbias across a
// sequential grid. Blocks here run in no order, so each writes partial sums that a last
// launch adds in a fixed order, with no atomics, and the result is the same from run to run.
//
// fp32 path (fp32 outputs, the default train step's), on ln_dense_fwd.cuh: every product on
// its 8 x 8 FMA register tile a thread (fma_stage_fp32, 16-byte shared loads, no TF32), both
// operands streamed 32 deep through a 3-stage cp.async ring, one barrier a stage, one
// 256-thread block an SM (at two, the 128-register cap made the dy and dW loops spill, and
// they ran slower; a deeper ring gained nothing). Launches:
//   gz  (outputs with an activation only) K3's fp32 block (ln_dense_fwd.cuh block_fp32: the
//       panel normalised in place, W through K3's ring) with another epilogue: g act'(z + b)
//       in registers, specialised by activation, its divisions on DivFast (taken again with
//       __fdiv_rn for four elements with an operand out of its range), stored to the gz
//       scratch. z is summed in K3's order, so act' is taken at the forward's z.
//   dy  one block per (128 rows, 128 columns of C): gz (or g) 128 x 32 and W 32 x 128 a stage,
//       over the outputs' F in order; the blocks of the first column tile also sum each gz
//       stage's columns into the row tile's partial db.
//   ln  one block per 128 rows, two rows a warp (ln_in_place's statistics, in its order): dx,
//       the row tile's partial dscale and dbias, and y, written over dy's rows.
//   dW  one block per (128 x 128 tile of a dW_i, range of rows): gz and y 32 rows a stage, the
//       partial tile written per range; the range length is the wrapper's, from the card's SM
//       count and this kernel's occupancy.
//   sum the partials of dW_i, db_i, dscale and dbias, each in a fixed order, in one launch.
// bf16 path (bf16 outputs, the bf16 model's: configs/modelnet_fast.yaml), every product on
// wgmma from 128-byte-swizzled shared memory, W the bf16 copy the forward's K3 already made
// (ld._product_weight), operands streamed 64 deep by cp.async, dy never in device memory:
//   gz  (outputs with an activation only) K3's bf16 block (block_bf16: z on wgmma m64n128k16
//       in K3's order) with K4's epilogue: g act'(z + b) in registers on DivFast (with the
//       DivRn retake), stored rounded to bf16, and the row tile's partial db summed from the
//       unrounded products (the 16 rows of a warp by shuffles, the 8 warps through the
//       tile's free ring slot).
//   dy  one block per 128 rows, two warpgroups each holding a 64 x 256 fp32 share of dy in
//       registers (128 a thread): x's rows copied to shared memory and normalised there in
//       ln_in_place's order (the statistics kept, y written in bf16 for dW), then gz (or g)
//       128 x 64 K-major and W 64 x 256 MN-major a stage (wgmma m64n256k16 with B
//       transposed) over the outputs' F in order through a ring of 48 KB stages, summing g's
//       columns into the row tile's partial db (an output with a bias and no activation)
//       while each stage's products run; then the LayerNorm's backward from the registers:
//       dx, and the partial dscale and dbias. bf16 x's rows load beside a 3-stage ring, ahead
//       of the products; fp32 x's, twice the size, into the 4-stage ring after them. One
//       block an SM (208 registers a thread), so the z sites' 161 row tiles take two waves.
//   dW  one block per (128 rows of a dW_i by every column, range of rows): gz 64 x 128 and y
//       64 x 256 a stage, both MN-major (wgmma m64n256k16 with A and B transposed), the
//       partial tile written per range; the ranges are the wrapper's, as on the fp32 path.
//   sum the fp32 path's launch.

#include <cstdint>
#include <type_traits>

#include "ln_dense_fwd.cuh"
#include "ptx.cuh"

namespace {

using pcdiff_ln::ACT_GELU;
using pcdiff_ln::ACT_GELU_TANH;
using pcdiff_ln::ACT_NONE;
using pcdiff_ln::ACT_QUICK_GELU;
using pcdiff_ln::bf16;
using pcdiff_ln::MAX_C;
using pcdiff_ln::MAX_OUT;
using pcdiff_ln::THREADS;
using pcdiff_ln::WARPS;
using namespace pcdiff_ptx;

// ---- the sum launch: out = the sum over k of part[k], in a fixed order, for up to 8 arrays ----
// A chain of fewer than LONG_CHAIN partials (the weight gradients' row ranges) is summed in
// order by one thread a quad of outputs; a longer one (the row tiles' partials of db, dscale
// and dbias) by a warp a quad: lane l sums k = l, l + 32, ... in order, then a butterfly over
// the 32 lanes (xor 16, 8, 4, 2, 1), so its loads are not one long dependent walk.

constexpr int MAX_SEG = 2 * MAX_OUT + 2;  // dW_i, db_i, dscale, dbias
constexpr int LONG_CHAIN = 64;

struct SumSeg {
  const float* part;  // [nsplit][n]
  float* out;         // [n]
  int n;              // a multiple of 4
  int nsplit;
};
struct SumArgs {
  SumSeg seg[MAX_SEG];
  int nseg;
};

__host__ __device__ __forceinline__ int chain_lanes(int nsplit) {
  return nsplit >= LONG_CHAIN ? 32 : 1;
}
// threads a segment takes: lanes per quad, rounded up to whole warps so that no warp spans
// two segments
__host__ __device__ __forceinline__ long long seg_threads(const SumSeg& g) {
  return ((long long)(g.n / 4) * chain_lanes(g.nsplit) + 31) / 32 * 32;
}

__global__ void __launch_bounds__(THREADS) ln_denses_bwd_sum_kernel(const __grid_constant__ SumArgs s) {
  long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
  for (int i = 0; i < s.nseg; ++i) {
    const SumSeg& g = s.seg[i];
    const long long threads = seg_threads(g);
    if (t < threads) {
      const int lanes = chain_lanes(g.nsplit), nq = g.n / 4;
      const int quad = (int)(t / lanes), lane = (int)(t % lanes);
      if (quad >= nq) return;  // the round-up of a one-lane segment
      const float4* p = reinterpret_cast<const float4*>(g.part) + quad;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
      for (int k = lane; k < g.nsplit; k += lanes) {
        const float4 v = p[(size_t)k * nq];
        acc = make_float4(__fadd_rn(acc.x, v.x), __fadd_rn(acc.y, v.y), __fadd_rn(acc.z, v.z),
                          __fadd_rn(acc.w, v.w));
      }
      if (lanes > 1) {  // a whole warp takes this quad
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          acc = make_float4(__fadd_rn(acc.x, __shfl_xor_sync(0xffffffffu, acc.x, off)),
                            __fadd_rn(acc.y, __shfl_xor_sync(0xffffffffu, acc.y, off)),
                            __fadd_rn(acc.z, __shfl_xor_sync(0xffffffffu, acc.z, off)),
                            __fadd_rn(acc.w, __shfl_xor_sync(0xffffffffu, acc.w, off)));
      }
      if (lane == 0) reinterpret_cast<float4*>(g.out)[quad] = acc;
      return;
    }
    t -= threads;
  }
}

int sum_launch(const SumArgs& s, cudaStream_t stream) {
  long long threads = 0;
  for (int i = 0; i < s.nseg; ++i) threads += seg_threads(s.seg[i]);
  const unsigned blocks = (unsigned)((threads + THREADS - 1) / THREADS);
  ln_denses_bwd_sum_kernel<<<blocks, THREADS, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

void add_seg(SumArgs& s, const float* part, float* out, int n, int nsplit) {
  s.seg[s.nseg++] = SumSeg{part, out, n, nsplit};
}

// Lets `kernel` use `smem` bytes of dynamic shared memory (once per size).
template <typename K>
int configure(K kernel, size_t smem, size_t& configured) {
  if (smem > configured) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  return 0;
}

// ============================== fp32 path ==============================

constexpr int BM = pcdiff_ln::BM;  // rows a dy / ln block; dy's column tile; dW's tile side
constexpr int BK = 32;             // a stage: F for dy, rows for dW
constexpr int STAGES = 3;          // one multiplied while the next two load
constexpr int A_LD = BK + 4;       // dy's gz stage [128 rows][32], padded rows
constexpr int DY_SLOT = BM * A_LD + BK * BM;  // floats: the gz stage, then W's [32][128]
constexpr int DW_SLOT = 2 * BK * BM;          // floats: gz's [32][128], then y's [32][128]
constexpr size_t DY_SMEM = (size_t)STAGES * DY_SLOT * sizeof(float);
constexpr size_t DW_SMEM = (size_t)STAGES * DW_SLOT * sizeof(float);

struct Fp32Args {
  const void* x;            // [rows, C], fp32 or bf16
  const float* ln_scale;
  const float* ln_bias;
  const float* w[MAX_OUT];  // [F_i, C]
  const float* gz[MAX_OUT]; // [rows, F_i]: g_i act_i'(z_i), or g_i itself without an activation
  float* db_part[MAX_OUT];  // [row tiles][F_i], null without a bias
  float* dw_part[MAX_OUT];  // [ranges][F_i][C]
  int f[MAX_OUT];
  int n_out;
  int rows;
  int c;
  float eps;
  float* dy;                // [rows, C]: dy, then y
  void* dx;                 // [rows, C] in x's dtype
  float* ln_part;           // [2][row tiles][C]: partial dscale, then partial dbias
  int per;                  // rows a dW range, a multiple of BK
};

// ---- gz: K3's fp32 block with g act'(z + b) as its epilogue ----

struct GzArgs {
  pcdiff_ln::Args ln;        // the outputs with an activation; out[i] is the gz scratch
  const float* g[MAX_OUT];   // their gradients, [rows, F_i]
};

// gz for two rows of four columns: g act'(z)
template <int ACT, typename Div>
__device__ __forceinline__ void gz_quads(const float (&z)[2][4], const float4 (&g)[2],
                                         float4 (&out)[2], Div div) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
    out[r] = make_float4(__fmul_rn(g[r].x, pcdiff_ln::act_grad<ACT>(z[r][0], div)),
                         __fmul_rn(g[r].y, pcdiff_ln::act_grad<ACT>(z[r][1], div)),
                         __fmul_rn(g[r].z, pcdiff_ln::act_grad<ACT>(z[r][2], div)),
                         __fmul_rn(g[r].w, pcdiff_ln::act_grad<ACT>(z[r][3], div)));
}

// The tile's gz (the thread's rows ty + 16 i, columns n0 + 64 jj + 4 tx + d of K3's tile),
// eight elements at a time.
template <int ACT>
__device__ __forceinline__ void gz_epilogue(const GzArgs& ga, int o, int n0, int r0,
                                            const float (&acc)[8][8]) {
  const pcdiff_ln::Args& a = ga.ln;
  const int F = a.f[o];
  const float* bias = a.b[o];
  const float* g = ga.g[o];
  float* out = static_cast<float*>(a.out[o]);
  const bool hb = bias != nullptr;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int jj = 0; jj < 2; ++jj) {
    const int col = n0 + 64 * jj + 4 * tx;
    if (col >= F) continue;  // F % 64 == 0: the four columns lie wholly in or out
    const float4 b = hb ? *reinterpret_cast<const float4*>(bias + col)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    const float bv[4] = {b.x, b.y, b.z, b.w};
    float4 gv[8];  // g at the thread's eight rows, all loads in flight at once
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = r0 + ty + 16 * i;
      gv[i] = row < a.rows ? *reinterpret_cast<const float4*>(g + (size_t)row * F + col)
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int i = 0; i < 8; i += 2) {
      float z[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int d = 0; d < 4; ++d)
          z[r][d] = hb ? __fadd_rn(acc[i + r][4 * jj + d], bv[d]) : acc[i + r][4 * jj + d];
      const float4 gp[2] = {gv[i], gv[i + 1]};
      float4 q[2];
      bool ok = true;
      gz_quads<ACT>(z, gp, q, pcdiff_ln::DivFast{ok});
      if (!ok) gz_quads<ACT>(z, gp, q, pcdiff_ln::DivRn());
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + ty + 16 * (i + r);
        if (row < a.rows) *reinterpret_cast<float4*>(out + (size_t)row * F + col) = q[r];
      }
    }
  }
}

template <typename TX>
__global__ void __launch_bounds__(THREADS, 1) ln_denses_bwd_gz_kernel(const __grid_constant__ GzArgs ga) {
  extern __shared__ __align__(128) unsigned char smem[];
  pcdiff_ln::block_fp32<TX>(ga.ln, smem, [&](int o, int n0, int r0, const float (&acc)[8][8]) {
    switch (ga.ln.act[o]) {
      case ACT_GELU: gz_epilogue<ACT_GELU>(ga, o, n0, r0, acc); break;
      case ACT_GELU_TANH: gz_epilogue<ACT_GELU_TANH>(ga, o, n0, r0, acc); break;
      case ACT_QUICK_GELU: gz_epilogue<ACT_QUICK_GELU>(ga, o, n0, r0, acc); break;
      default: gz_epilogue<ACT_NONE>(ga, o, n0, r0, acc);
    }
  });
}

// ---- dy = sum_i gz_i W_i: one block per (128 rows, 128 columns) ----

// Stage s of the sequence over the outputs' F, 32 deep: output o, its columns f0 .. f0 + 31.
__device__ __forceinline__ int dy_stage(const Fp32Args& a, int s, int& f0) {
  int o = 0;
  f0 = s * BK;
  while (f0 >= a.f[o]) {
    f0 -= a.f[o];
    ++o;
  }
  return o;
}

// Stage s into `slot`: gz's rows r0 .. r0 + 127 at columns f0 .. (8 16-byte copies a row, rows
// past `rows` zero-filled) and W's rows f0 .. f0 + 31 at columns c0 .. c0 + 127 (32 a row,
// zero-filled past C): 2048 copies, 8 a thread.
__device__ __forceinline__ void dy_load(const Fp32Args& a, int r0, int c0, int s, float* slot) {
  int f0;
  const int o = dy_stage(a, s, f0);
  const int F = a.f[o], C = a.c;
  const float* gz = a.gz[o];
  const float* w = a.w[o];
  float* sb = slot + BM * A_LD;
#pragma unroll
  for (int j = 0; j < BM * BK / 4 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / 8, ca = i % 8, k = i / 32, cb = i % 32;
    const bool oka = r0 + r < a.rows, okb = c0 + 4 * cb < C;
    cp_async_16(slot + r * A_LD + 4 * ca, gz + (oka ? (size_t)(r0 + r) * F + f0 + 4 * ca : 0),
                oka ? 16 : 0);
    cp_async_16(sb + k * BM + 4 * cb, w + (okb ? (size_t)(f0 + k) * C + c0 + 4 * cb : 0),
                okb ? 16 : 0);
  }
}

// The row tile's partial db over a gz stage: column f0 + t / 8 summed by the 8 lanes t % 8,
// each over the rows t % 8 + 8 j in order, then across the 8 lanes by a butterfly.
__device__ __forceinline__ void db_stage(const Fp32Args& a, int rt, int s, const float* sa) {
  int f0;
  const int o = dy_stage(a, s, f0);
  float* part = a.db_part[o];
  if (part == nullptr) return;
  const int col = threadIdx.x / 8, l = threadIdx.x % 8;
  float sum = 0.f;
#pragma unroll
  for (int j = 0; j < BM / 8; ++j) sum = __fadd_rn(sum, sa[(l + 8 * j) * A_LD + col]);
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (l == 0) part[(size_t)rt * a.f[o] + f0 + col] = sum;
}

__global__ void __launch_bounds__(THREADS, 1)
ln_denses_bwd_dy_kernel(const __grid_constant__ Fp32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int ctiles = (a.c + BM - 1) / BM;
  const int rt = blockIdx.x / ctiles, c0 = (blockIdx.x % ctiles) * BM, r0 = rt * BM;
  int stages = 0;
  for (int o = 0; o < a.n_out; ++o) stages += a.f[o] / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) dy_load(a, r0, c0, s, ring + s * DY_SLOT);
    cp_async_commit();
  }
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // stage s landed for everyone; everyone is done with stage s - 1
    const int sn = s + STAGES - 1;
    if (sn < stages) dy_load(a, r0, c0, sn, ring + (sn % STAGES) * DY_SLOT);
    cp_async_commit();
    const float* slot = ring + (s % STAGES) * DY_SLOT;
    if (c0 == 0) db_stage(a, rt, s, slot);
    pcdiff_ln::fma_stage_fp32<2, pcdiff_ln::K_CONTIG, pcdiff_ln::K_MAJOR>(
        acc, slot + ty * A_LD, A_LD, slot + BM * A_LD, BM);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= a.rows) break;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = c0 + 64 * jj + 4 * tx;
      if (col < a.c)
        *reinterpret_cast<float4*>(a.dy + (size_t)row * a.c + col) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    }
  }
}

// ---- ln: the LayerNorm's backward, a streaming row pass ----

// 8 elements of a row from 16 bytes (bf16) or 32 (fp32); zeros where !ok.
template <typename T>
__device__ __forceinline__ void load8(const T* p, bool ok, float (&v)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    const uint4 raw = ok ? *reinterpret_cast<const uint4*>(p) : make_uint4(0u, 0u, 0u, 0u);
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(h[e]);
  } else {
    const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 p0 = ok ? reinterpret_cast<const float4*>(p)[0] : z;
    const float4 p1 = ok ? reinterpret_cast<const float4*>(p)[1] : z;
    v[0] = p0.x; v[1] = p0.y; v[2] = p0.z; v[3] = p0.w;
    v[4] = p1.x; v[5] = p1.y; v[6] = p1.z; v[7] = p1.w;
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* p, const float (&v)[8]) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                                              pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// One block per 128 rows; a warp takes two rows at a time, one a half-warp, lane l of a half
// the 8-element chunks l and l + 16 (C <= 256), as ln_in_place does, with its statistics in its
// order. The lanes keep their columns' partial dscale and dbias over their rows; the halves
// and then the warps (through shared memory, in order) are added at the end.
template <typename TX>
__global__ void __launch_bounds__(THREADS) ln_denses_bwd_ln_kernel(const __grid_constant__ Fp32Args a) {
  __shared__ __align__(16) float red[WARPS][2][MAX_C];
  constexpr int ROWS = BM / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane >> 4, hl = lane & 15;
  const int C = a.c;
  const bool pow2 = (C & (C - 1)) == 0;
  const float inv_c = 1.f / (float)C;
  const TX* x = static_cast<const TX*>(a.x);
  TX* dx = static_cast<TX*>(a.dx);
  bool live[2];
  float sc[2][8], bi[2][8], ds[2][8], db[2][8];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 8 * (hl + 16 * j);
    live[j] = col < C;
    load8(a.ln_scale + col, live[j], sc[j]);
    load8(a.ln_bias + col, live[j], bi[j]);
#pragma unroll
    for (int e = 0; e < 8; ++e) ds[j][e] = db[j][e] = 0.f;
  }
  const int r0 = blockIdx.x * BM;
#pragma unroll 1
  for (int i = 0; i < ROWS; i += 2) {
    const int row = r0 + warp * ROWS + i + half;
    const bool in = row < a.rows;
    float v[2][8], d[2][8];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const size_t at = (size_t)row * C + 8 * (hl + 16 * j);
      load8(x + at, in && live[j], v[j]);
      load8(a.dy + at, in && live[j], d[j]);
    }
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s = __fadd_rn(s, v[j][e]);
        s2 = __fadd_rn(s2, __fmul_rn(v[j][e], v[j][e]));
      }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // within the half-warp
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = pow2 ? __fmul_rn(s, inv_c) : __fdiv_rn(s, (float)C);
    const float ex2 = pow2 ? __fmul_rn(s2, inv_c) : __fdiv_rn(s2, (float)C);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));
    float xh[2][8], t1 = 0.f, t2 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        xh[j][e] = __fmul_rn(__fsub_rn(v[j][e], mean), rstd);
        const float dxh = __fmul_rn(d[j][e], sc[j][e]);
        t1 = __fadd_rn(t1, dxh);
        t2 = __fadd_rn(t2, __fmul_rn(dxh, xh[j][e]));
      }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      t1 += __shfl_xor_sync(0xffffffffu, t1, off);
      t2 += __shfl_xor_sync(0xffffffffu, t2, off);
    }
    const float m1 = pow2 ? __fmul_rn(t1, inv_c) : __fdiv_rn(t1, (float)C);
    const float m2 = pow2 ? __fmul_rn(t2, inv_c) : __fdiv_rn(t2, (float)C);
    if (!in) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!live[j]) continue;
      float dxv[8], y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const float dxh = __fmul_rn(d[j][e], sc[j][e]);
        dxv[e] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xh[j][e], m2)));
        y[e] = __fadd_rn(__fmul_rn(xh[j][e], sc[j][e]), bi[j][e]);
        ds[j][e] = __fadd_rn(ds[j][e], __fmul_rn(d[j][e], xh[j][e]));
        db[j][e] = __fadd_rn(db[j][e], d[j][e]);
      }
      const size_t at = (size_t)row * C + 8 * (hl + 16 * j);
      store8(dx + at, dxv);
      store8(a.dy + at, y);  // the row's dy is in registers: y takes its place
    }
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      ds[j][e] = __fadd_rn(ds[j][e], __shfl_xor_sync(0xffffffffu, ds[j][e], 16));
      db[j][e] = __fadd_rn(db[j][e], __shfl_xor_sync(0xffffffffu, db[j][e], 16));
    }
  if (half == 0) {
#pragma unroll
    for (int j = 0; j < 2; ++j)
      if (live[j]) {
        store8(&red[warp][0][8 * (hl + 16 * j)], ds[j]);
        store8(&red[warp][1][8 * (hl + 16 * j)], db[j]);
      }
  }
  __syncthreads();
  const int tiles = gridDim.x;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s0 = __fadd_rn(s0, red[w][0][c]);
      s1 = __fadd_rn(s1, red[w][1][c]);
    }
    a.ln_part[(size_t)blockIdx.x * C + c] = s0;
    a.ln_part[((size_t)tiles + blockIdx.x) * C + c] = s1;
  }
}

// ---- dW_i = gz_i^T y: one block per (128 x 128 tile, range of rows) ----

__device__ __forceinline__ int dw_tiles(const Fp32Args& a) {
  int t = 0;
  for (int o = 0; o < a.n_out; ++o) t += (a.f[o] + BM - 1) / BM;
  return t * ((a.c + BM - 1) / BM);
}

// Tile t: output o, its rows f0 .. f0 + 127 of dW_i and columns c0 .. c0 + 127.
__device__ __forceinline__ int dw_tile(const Fp32Args& a, int t, int& f0, int& c0) {
  const int ctiles = (a.c + BM - 1) / BM;
  c0 = (t % ctiles) * BM;
  t /= ctiles;
  int o = 0, ft = (a.f[0] + BM - 1) / BM;
  while (t >= ft) {
    t -= ft;
    ++o;
    ft = (a.f[o] + BM - 1) / BM;
  }
  f0 = t * BM;
  return o;
}

// Rows row0 .. row0 + 31 of gz_i (columns f0 ..) and of y (columns c0 ..) into `slot`, 32
// 16-byte copies a row each, zero-filled at or past `hi`, past F and past C.
__device__ __forceinline__ void dw_load(const Fp32Args& a, int o, int f0, int c0, int row0,
                                        int hi, float* slot) {
  const int F = a.f[o], C = a.c;
  const float* gz = a.gz[o];
  float* sy = slot + BK * BM;
#pragma unroll
  for (int j = 0; j < BK * BM / 4 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = i / 32, ch = i % 32, row = row0 + k;
    const bool oka = row < hi && f0 + 4 * ch < F, okb = row < hi && c0 + 4 * ch < C;
    cp_async_16(slot + k * BM + 4 * ch, gz + (oka ? (size_t)row * F + f0 + 4 * ch : 0),
                oka ? 16 : 0);
    cp_async_16(sy + k * BM + 4 * ch, a.dy + (okb ? (size_t)row * C + c0 + 4 * ch : 0),
                okb ? 16 : 0);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
ln_denses_bwd_dw_kernel(const __grid_constant__ Fp32Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  const int tiles = dw_tiles(a);
  const int range = blockIdx.x / tiles;
  int f0, c0;
  const int o = dw_tile(a, blockIdx.x % tiles, f0, c0);
  const int lo = range * a.per, hi = min(a.rows, lo + a.per);
  const int stages = (hi - lo + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) dw_load(a, o, f0, c0, lo + s * BK, hi, ring + s * DW_SLOT);
    cp_async_commit();
  }
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int sn = s + STAGES - 1;
    if (sn < stages) dw_load(a, o, f0, c0, lo + sn * BK, hi, ring + (sn % STAGES) * DW_SLOT);
    cp_async_commit();
    const float* slot = ring + (s % STAGES) * DW_SLOT;
    pcdiff_ln::fma_stage_fp32<2, pcdiff_ln::K_MAJOR, pcdiff_ln::K_MAJOR>(acc, slot, BM,
                                                                        slot + BK * BM, BM);
  }
  cp_async_wait<0>();
  // the thread's rows of the tile are f0 + 64 (i / 4) + 4 ty + i % 4
  const int F = a.f[o], C = a.c;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float* part = a.dw_part[o] + (size_t)range * F * C;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int f = f0 + 64 * (i / 4) + 4 * ty + i % 4;
    if (f >= F) continue;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      const int col = c0 + 64 * jj + 4 * tx;
      if (col < C)
        *reinterpret_cast<float4*>(part + (size_t)f * C + col) =
            make_float4(acc[i][4 * jj], acc[i][4 * jj + 1], acc[i][4 * jj + 2], acc[i][4 * jj + 3]);
    }
  }
}

template <typename TX>
int launch_fp32(const Fp32Args& a, const GzArgs& ga, float* dscale, float* dbias,
                float* const* dw, float* const* db, cudaStream_t s) {
  int err;
  const int row_tiles = (a.rows + BM - 1) / BM;
  if (ga.ln.n_out > 0) {
    static size_t configured = 0;
    const size_t smem = pcdiff_ln::smem_bytes<float>(a.c);
    if ((err = configure(ln_denses_bwd_gz_kernel<TX>, smem, configured))) return err;
    ln_denses_bwd_gz_kernel<TX><<<(unsigned)row_tiles * ga.ln.groups, THREADS, smem, s>>>(ga);
    if ((err = (int)cudaGetLastError())) return err;
  }
  static size_t dy_configured = 0, dw_configured = 0;
  if ((err = configure(ln_denses_bwd_dy_kernel, DY_SMEM, dy_configured))) return err;
  const int ctiles = (a.c + BM - 1) / BM;
  ln_denses_bwd_dy_kernel<<<(unsigned)(row_tiles * ctiles), THREADS, DY_SMEM, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  ln_denses_bwd_ln_kernel<TX><<<(unsigned)row_tiles, THREADS, 0, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = configure(ln_denses_bwd_dw_kernel, DW_SMEM, dw_configured))) return err;
  int tiles = 0;
  for (int o = 0; o < a.n_out; ++o) tiles += (a.f[o] + BM - 1) / BM;
  tiles *= ctiles;
  const int ranges = (a.rows + a.per - 1) / a.per;
  ln_denses_bwd_dw_kernel<<<(unsigned)(tiles * ranges), THREADS, DW_SMEM, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  SumArgs sa;
  sa.nseg = 0;
  add_seg(sa, a.ln_part, dscale, a.c, row_tiles);
  add_seg(sa, a.ln_part + (size_t)row_tiles * a.c, dbias, a.c, row_tiles);
  for (int o = 0; o < a.n_out; ++o)
    if (db[o] != nullptr) add_seg(sa, a.db_part[o], db[o], a.f[o], row_tiles);
  for (int o = 0; o < a.n_out; ++o) add_seg(sa, a.dw_part[o], dw[o], a.f[o] * a.c, ranges);
  return sum_launch(sa, s);
}

// ============================== bf16 path ==============================

namespace bf16_path {

constexpr int BK = 64;     // a stage: F (dy) or rows (dW), one 128-byte swizzled row deep
constexpr int NC = MAX_C;  // the products' column extent (C), zero-filled past C
constexpr int STAGES = 4;  // one multiplied while the next three load
constexpr int A_ELEMS = BM * BK;  // dy: gz [128 rows][64 f], K-major; dW: gz [2][64 rows][64 f]
constexpr int B_ELEMS = BK * NC;  // W [4][64 f][64 c] or y [4][64 rows][64 c], MN-major
constexpr int SLOT = A_ELEMS + B_ELEMS;  // bf16 elements: 48 KB
constexpr int MN_BLOCK = BK * 64;        // elements from one 64-wide MN block to the next
constexpr size_t SMEM = (size_t)STAGES * SLOT * sizeof(bf16) + pcdiff_ln::SMEM_ALIGN;

struct Args {
  const void* x;            // [rows, C], fp32 or bf16
  const float* ln_scale;
  const float* ln_bias;
  const bf16* w[MAX_OUT];   // [F_i, C], ld._product_weight's bf16 copy
  const bf16* gz[MAX_OUT];  // [rows, F_i]: bf16(g_i act_i'(z_i)), or g_i itself without an activation
  float* db_part[MAX_OUT];  // [row tiles][F_i] for the dy launch's outputs: a bias, no activation
  float* dw_part[MAX_OUT];  // [ranges][F_i][C]
  int f[MAX_OUT];
  int n_out;
  int rows;
  int c;
  float eps;
  bf16* y;                  // [rows, C]: y, written by the dy launch for the dW launch
  void* dx;                 // [rows, C] in x's dtype
  float* ln_part;           // [2][row tiles][C]: partial dscale, then partial dbias
  int per;                  // rows a dW range, a multiple of BK
};

__device__ __forceinline__ bf16* ring_base(unsigned char* smem) {
  constexpr int AL = pcdiff_ln::SMEM_ALIGN;
  return reinterpret_cast<bf16*>(smem + ((AL - (smem_u32(smem) & (AL - 1))) & (AL - 1)));
}

// Element (k, n) of a [k][64] MN-major block: the 16-byte chunk n / 8 at (n / 8) ^ (k % 8).
__device__ __forceinline__ int sw(int k, int n) { return k * 64 + ((((n >> 3) ^ (k & 7))) << 3); }

// The C columns of `src`'s row (a [*, C] bf16 matrix) into a stage's four MN blocks at k row
// `k`: 32 16-byte copies a row, zero-filled past C or where !ok.
__device__ __forceinline__ void load_wide_row(bf16* dst, const bf16* src, int c, bool ok, int k,
                                              int nc) {
  const bool in = ok && 8 * nc < c;
  cp_async_16(dst + (nc >> 3) * MN_BLOCK + sw(k, 8 * (nc & 7)), src + (in ? 8 * nc : 0),
              in ? 16 : 0);
}

// ---- gz (outputs with an activation): K3's bf16 block, g act'(z + b) as its epilogue ----

struct GzArgs {
  pcdiff_ln::Args ln;         // the outputs with an activation; out[i] is the bf16 gz scratch
  const bf16* g[MAX_OUT];     // their gradients, [rows, F_i]
  float* db_part[MAX_OUT];    // [row tiles][F_i] where the output has a bias, else null
};

// gz for one n8 block of a warpgroup's accumulator: rows (h) and columns (e) of the thread,
// g act'(z) in fp32 (q) from z = acc + b.
template <int ACT, typename Div>
__device__ __forceinline__ void gz_pairs(const float (&z)[2][2], const float (&gv)[2][2],
                                         float (&q)[2][2], Div div) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int e = 0; e < 2; ++e) q[h][e] = __fmul_rn(gv[h][e], pcdiff_ln::act_grad<ACT>(z[h][e], div));
}

// The warpgroup's 64 x 128 share of a tile: gz = bf16(g act'(z + b)) stored, and, with a bias,
// the row tile's partial db from the unrounded products: the thread's two rows, then the
// warp's 16 (lanes xor 4, 8, 16), then the 8 warps in order through `red` (the tile's free
// ring slot).
template <int ACT>
__device__ __forceinline__ void gz_epilogue(const GzArgs& ga, int o, int n0, int r0,
                                            const float (&acc)[64], float* red) {
  const pcdiff_ln::Args& a = ga.ln;
  const int F = a.f[o];
  const float* bias = a.b[o];
  const bf16* g = ga.g[o];
  bf16* out = static_cast<bf16*>(a.out[o]);
  float* db = ga.db_part[o];
  const bool hb = bias != nullptr;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  const int row0 = r0 + 16 * warp + (lane >> 2);  // and row0 + 8
  if (db != nullptr) __syncthreads();  // both warpgroups' products are done: `red` is free
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (n0 + 8 * j >= F) break;  // F % 64 == 0: the tile's last 64 columns may lie past F
    const int col = n0 + 8 * j + 2 * tig;
    const float2 b = hb ? *reinterpret_cast<const float2*>(bias + col) : make_float2(0.f, 0.f);
    float z[2][2], gv[2][2], q[2][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      const __nv_bfloat162 v = row < a.rows
          ? *reinterpret_cast<const __nv_bfloat162*>(g + (size_t)row * F + col)
          : __floats2bfloat162_rn(0.f, 0.f);
      gv[h][0] = __low2float(v);
      gv[h][1] = __high2float(v);
      z[h][0] = hb ? __fadd_rn(acc[4 * j + 2 * h], b.x) : acc[4 * j + 2 * h];
      z[h][1] = hb ? __fadd_rn(acc[4 * j + 2 * h + 1], b.y) : acc[4 * j + 2 * h + 1];
    }
    bool ok = true;
    gz_pairs<ACT>(z, gv, q, pcdiff_ln::DivFast{ok});
    if (!ok) gz_pairs<ACT>(z, gv, q, pcdiff_ln::DivRn());
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < a.rows)
        *reinterpret_cast<unsigned*>(out + (size_t)row * F + col) = pack_bf16(q[h][0], q[h][1]);
    }
    if (db != nullptr) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float sum = __fadd_rn(q[0][e], q[1][e]);
#pragma unroll
        for (int off = 4; off < 32; off <<= 1)
          sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
        if (lane < 4) red[warp * 128 + 8 * j + 2 * tig + e] = sum;
      }
    }
  }
  if (db != nullptr) {
    __syncthreads();
    const int t = threadIdx.x;
    if (t < 128 && n0 + t < F) {
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) sum = __fadd_rn(sum, red[w * 128 + t]);
      db[(size_t)(r0 / BM) * F + n0 + t] = sum;
    }
  }
}

template <typename TX>
// Two blocks an SM, as K3's bf16 block (one, with more registers, or with g's loads all issued
// before the epilogue, ran slower on an H100).
__global__ void __launch_bounds__(THREADS, 2) ln_denses_bwd_gz_bf16_kernel(const __grid_constant__ GzArgs ga) {
  extern __shared__ __align__(128) unsigned char smem[];
  pcdiff_ln::block_bf16<TX>(ga.ln, smem, [&](int o, int n0, int r0, const float (&acc)[64],
                                             bf16* slot) {
    float* red = reinterpret_cast<float*>(slot);
    switch (ga.ln.act[o]) {
      case ACT_GELU: gz_epilogue<ACT_GELU>(ga, o, n0, r0, acc, red); break;
      case ACT_GELU_TANH: gz_epilogue<ACT_GELU_TANH>(ga, o, n0, r0, acc, red); break;
      case ACT_QUICK_GELU: gz_epilogue<ACT_QUICK_GELU>(ga, o, n0, r0, acc, red); break;
      default: gz_epilogue<ACT_NONE>(ga, o, n0, r0, acc, red);
    }
  });
}

// ---- dy = sum_i gz_i W_i with the LayerNorm's backward: one block per 128 rows ----

// Stage s of the sequence over the outputs' F, 64 deep: output o, its columns f0 .. f0 + 63.
__device__ __forceinline__ int f_stage(const Args& a, int s, int& f0) {
  int o = 0;
  f0 = s * BK;
  while (f0 >= a.f[o]) {
    f0 -= a.f[o];
    ++o;
  }
  return o;
}

// Stage s into `slot`: gz's rows r0 .. r0 + 127 at columns f0 .. f0 + 63 (K-major, rows past
// `rows` zero-filled) and W's rows f0 .. f0 + 63 at every column (MN-major): 3072 copies, 12
// a thread.
__device__ __forceinline__ void dy_load(const Args& a, int r0, int s, bf16* slot) {
  int f0;
  const int o = f_stage(a, s, f0);
  const int F = a.f[o], C = a.c;
  const bf16* gz = a.gz[o];
  const bf16* w = a.w[o];
#pragma unroll
  for (int j = 0; j < BM * 8 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int r = i / 8, ch = i % 8;
    const bool ok = r0 + r < a.rows;
    cp_async_16(slot + sw(r, 8 * ch), gz + (ok ? (size_t)(r0 + r) * F + f0 + 8 * ch : 0),
                ok ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < BK * 32 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = i / 32;
    load_wide_row(slot + A_ELEMS, w + (size_t)(f0 + k) * C, C, true, k, i % 32);
  }
}

// The row tile's partial db over a g stage (an output with a bias and no activation): column
// t / 4 summed by the 4 lanes t % 4, each over the rows t % 4 + 4 j in order, then across
// the 4 lanes by a butterfly.
__device__ __forceinline__ void db_stage(const Args& a, int rt, int s, const bf16* sa) {
  int f0;
  const int o = f_stage(a, s, f0);
  float* part = a.db_part[o];
  if (part == nullptr) return;
  const int col = threadIdx.x / 4, l = threadIdx.x % 4;
  float sum = 0.f;
#pragma unroll 8
  for (int j = 0; j < BM / 4; ++j) {
    const int r = l + 4 * j;
    sum = __fadd_rn(sum, __bfloat162float(sa[sw(r, col) + (col & 7)]));
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (l == 0) part[(size_t)rt * a.f[o] + f0 + col] = sum;
}

// x's rows r0 .. r0 + 127 copied into `sx` (rows of C + 8 elements, so the LN backward's
// fragment-ordered reads fall in distinct banks) by cp.async, rows past `rows` zero-filled;
// one commit group, every copy in flight at once.
template <typename TX>
__device__ __forceinline__ void stage_rows(const Args& a, int r0, TX* sx) {
  constexpr int PER = 16 / (int)sizeof(TX);
  const int C = a.c, chunks = C / PER, ld = C + 8;
  const TX* x = static_cast<const TX*>(a.x);
  for (int i = threadIdx.x; i < BM * chunks; i += THREADS) {
    const int r = i / chunks, c = (i % chunks) * PER;
    const bool ok = r0 + r < a.rows;
    cp_async_16(sx + r * ld + c, x + (ok ? (size_t)(r0 + r) * C + c : 0), ok ? 16 : 0);
  }
  cp_async_commit();
}

// The rows' statistics and y, as ln_in_place computes them (two rows a warp, lane l of a half
// the 8-element chunks l and l + 16), from the rows in `sx`: y rounded to bf16 and stored for
// the dW launch, (mean, rstd) kept in `stats`; rows past `rows` get (0, 0).
template <typename TX>
__device__ __forceinline__ void ln_rows(const Args& a, int r0, const TX* sx, float2* stats) {
  constexpr int ROWS = BM / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int half = lane >> 4, hl = lane & 15;
  const int C = a.c, ld = C + 8;
  const bool pow2 = (C & (C - 1)) == 0;
  const float inv_c = 1.f / (float)C;
  bool live[2];
  float sc[2][8], bi[2][8];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int col = 8 * (hl + 16 * j);
    live[j] = col < C;
    load8(a.ln_scale + col, live[j], sc[j]);
    load8(a.ln_bias + col, live[j], bi[j]);
  }
#pragma unroll 2
  for (int i = 0; i < ROWS; i += 2) {
    const int rl = warp * ROWS + i + half, row = r0 + rl;
    const bool in = row < a.rows;
    float v[2][8];
#pragma unroll
    for (int j = 0; j < 2; ++j) load8(sx + rl * ld + 8 * (hl + 16 * j), live[j], v[j]);
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s = __fadd_rn(s, v[j][e]);
        s2 = __fadd_rn(s2, __fmul_rn(v[j][e], v[j][e]));
      }
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {  // within the half-warp
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = pow2 ? __fmul_rn(s, inv_c) : __fdiv_rn(s, (float)C);
    const float ex2 = pow2 ? __fmul_rn(s2, inv_c) : __fdiv_rn(s2, (float)C);
    const float var = fmaxf(__fsub_rn(ex2, __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));
    if (hl == 0) stats[rl] = in ? make_float2(mean, rstd) : make_float2(0.f, 0.f);
    if (!in) continue;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (!live[j]) continue;
      float y[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        y[e] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(v[j][e], mean), rstd), sc[j][e]), bi[j][e]);
      store8(a.y + (size_t)row * C + 8 * (hl + 16 * j), y);
    }
  }
}

template <typename T>
__device__ __forceinline__ float2 load2(const T* p, bool ok) {
  if constexpr (std::is_same<T, bf16>::value) {
    return ok ? __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p)) : make_float2(0.f, 0.f);
  } else {
    return ok ? *reinterpret_cast<const float2*>(p) : make_float2(0.f, 0.f);
  }
}
template <typename T>
__device__ __forceinline__ void store2(T* p, float v0, float v1) {
  if constexpr (std::is_same<T, bf16>::value)
    *reinterpret_cast<unsigned*>(p) = pack_bf16(v0, v1);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
}

// The LayerNorm's backward from dy in the warpgroups' accumulators (the thread's rows 16 warp +
// lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1)): the rows' sums of dxhat and dxhat xhat
// over the thread's 64 columns in order, then the quad's 4 lanes (xor 1, 2); dx; and the
// columns' partial dscale and dbias over the thread's two rows, the warp's 16 (xor 4, 8, 16),
// then the 8 warps in order through `red`.
template <typename TX>
__device__ __forceinline__ void ln_backward(const Args& a, int rt, const float (&acc)[128],
                                            const TX* sx, const float2* stats, float* red) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  const int C = a.c, r0 = rt * BM, ld = C + 8;
  const bool pow2 = (C & (C - 1)) == 0;
  const float inv_c = 1.f / (float)C;
  TX* dx = static_cast<TX*>(a.dx);
  int row[2], rl[2];
  bool in[2];
  float mean[2], rstd[2], t1[2] = {0.f, 0.f}, t2[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    rl[h] = 16 * warp + (lane >> 2) + 8 * h;
    row[h] = r0 + rl[h];
    in[h] = row[h] < a.rows;
    const float2 st = stats[rl[h]];
    mean[h] = st.x;
    rstd[h] = st.y;
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    if (8 * j >= C) break;  // C % 32 == 0: the n8 block lies wholly in or out
    const int col = 8 * j + 2 * tig;
    const float2 sc = *reinterpret_cast<const float2*>(a.ln_scale + col);
    const float scv[2] = {sc.x, sc.y};
    float ds[2], db[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float2 xv = load2(sx + rl[h] * ld + col, true);
      const float xs[2] = {xv.x, xv.y};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float d = acc[4 * j + 2 * h + e];
        const float xh = __fmul_rn(__fsub_rn(xs[e], mean[h]), rstd[h]);
        const float dxh = __fmul_rn(d, scv[e]);
        t1[h] = __fadd_rn(t1[h], dxh);
        t2[h] = __fadd_rn(t2[h], __fmul_rn(dxh, xh));
        const float p = __fmul_rn(d, xh);
        ds[e] = h == 0 ? p : __fadd_rn(ds[e], p);
        db[e] = h == 0 ? d : __fadd_rn(db[e], d);
      }
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        ds[e] = __fadd_rn(ds[e], __shfl_xor_sync(0xffffffffu, ds[e], off));
        db[e] = __fadd_rn(db[e], __shfl_xor_sync(0xffffffffu, db[e], off));
      }
      if (lane < 4) {
        red[(2 * warp) * NC + col + e] = ds[e];
        red[(2 * warp + 1) * NC + col + e] = db[e];
      }
    }
  }
  float m1[2], m2[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      t1[h] = __fadd_rn(t1[h], __shfl_xor_sync(0xffffffffu, t1[h], off));
      t2[h] = __fadd_rn(t2[h], __shfl_xor_sync(0xffffffffu, t2[h], off));
    }
    m1[h] = pow2 ? __fmul_rn(t1[h], inv_c) : __fdiv_rn(t1[h], (float)C);
    m2[h] = pow2 ? __fmul_rn(t2[h], inv_c) : __fdiv_rn(t2[h], (float)C);
  }
#pragma unroll
  for (int j = 0; j < NC / 8; ++j) {
    if (8 * j >= C) break;
    const int col = 8 * j + 2 * tig;
    const float2 sc = *reinterpret_cast<const float2*>(a.ln_scale + col);
    const float scv[2] = {sc.x, sc.y};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (!in[h]) continue;
      const float2 xv = load2(sx + rl[h] * ld + col, true);
      const float xs[2] = {xv.x, xv.y};
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float xh = __fmul_rn(__fsub_rn(xs[e], mean[h]), rstd[h]);
        const float dxh = __fmul_rn(acc[4 * j + 2 * h + e], scv[e]);
        v[e] = __fmul_rn(rstd[h], __fsub_rn(__fsub_rn(dxh, m1[h]), __fmul_rn(xh, m2[h])));
      }
      store2(dx + (size_t)row[h] * C + col, v[0], v[1]);
    }
  }
  __syncthreads();
  const int tiles = gridDim.x;
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s0 = 0.f, s1 = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      s0 = __fadd_rn(s0, red[(2 * w) * NC + c]);
      s1 = __fadd_rn(s1, red[(2 * w + 1) * NC + c]);
    }
    a.ln_part[(size_t)rt * C + c] = s0;
    a.ln_part[((size_t)tiles + rt) * C + c] = s1;
  }
}

// The dy launch's ring depth and shared memory by x's dtype: bf16 x's rows (66 KB at C = 256)
// get their own region beside a 3-stage ring, so they load with the ring's first stages and y
// is written while the products run; fp32 x's (132 KB) would not fit beside it, so they
// load into the 4-stage ring once the products are done.
template <typename TX>
__host__ __device__ constexpr int dy_stages() { return sizeof(TX) == 2 ? 3 : STAGES; }
template <typename TX>
constexpr size_t dy_smem() {
  return (size_t)dy_stages<TX>() * SLOT * sizeof(bf16) +
         (sizeof(TX) == 2 ? (size_t)BM * (MAX_C + 8) * sizeof(TX) : 0) + pcdiff_ln::SMEM_ALIGN;
}

// One block per 128 rows, two consumer warpgroups of 64 rows, each holding its 64 x 256 fp32
// share of dy in registers: x's rows (one cp.async group), their statistics and y; gz W stage
// by stage on wgmma m64n256k16 (gz K-major, W's rows MN-major: one stage is 64 of the outputs'
// F, in output order); then the LayerNorm's backward. bf16 x is copied and normalised ahead
// of the products, fp32 x after them (dy_stages).
template <typename TX>
__global__ void __launch_bounds__(THREADS, 1) ln_denses_bwd_dy_bf16_kernel(const __grid_constant__ Args a) {
  constexpr int ST = dy_stages<TX>();
  constexpr bool AHEAD = sizeof(TX) == 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float2 stats[BM];
  bf16* ring = ring_base(smem);
  // x's 128 rows: beside the ring (bf16), or in it once the products are done (fp32)
  TX* sx = reinterpret_cast<TX*>(AHEAD ? ring + ST * SLOT : ring);
  const int rt = blockIdx.x, r0 = rt * BM, wg = threadIdx.x / 128;
  int stages = 0;
  for (int o = 0; o < a.n_out; ++o) stages += a.f[o] / BK;
  if constexpr (AHEAD) stage_rows<TX>(a, r0, sx);
#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < stages) dy_load(a, r0, s, ring + s * SLOT);
    cp_async_commit();
  }
  if constexpr (AHEAD) {
    cp_async_wait<ST - 1>();  // x's group, older than the ring's
    __syncthreads();
    ln_rows<TX>(a, r0, sx, stats);
  }
  float acc[128];
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<ST - 2>();
    fence_proxy_async();
    __syncthreads();  // stage s landed for everyone; everyone's products of stage s - 1 are done
    const int sn = s + ST - 1;
    if (sn < stages) dy_load(a, r0, sn, ring + (sn % ST) * SLOT);
    cp_async_commit();
    const bf16* slot = ring + (s % ST) * SLOT;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_m64n256k16_ss<0, 1>(acc, sw128_desc(slot + wg * 64 * 64 + 16 * ks),
                                sw128_desc_mn(slot + A_ELEMS + ks * 16 * 64, MN_BLOCK * 2),
                                s > 0 || ks > 0);
    wgmma_commit();
    fence_regs(acc);  // the products run on while db_stage reads the same slot
    db_stage(a, rt, s, slot);
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp's products are done: the ring is free
  if constexpr (!AHEAD) {
    stage_rows<TX>(a, r0, sx);
    cp_async_wait<0>();
    __syncthreads();
    ln_rows<TX>(a, r0, sx, stats);
    __syncthreads();
  }
  float* red = reinterpret_cast<float*>(AHEAD ? ring : reinterpret_cast<bf16*>(sx + BM * (a.c + 8)));
  ln_backward<TX>(a, rt, acc, sx, stats, red);
}

// ---- dW_i = gz_i^T y: one block per (128 x C tile of a dW_i, range of rows) ----

__device__ __forceinline__ int dw_tiles(const Args& a) {
  int t = 0;
  for (int o = 0; o < a.n_out; ++o) t += (a.f[o] + BM - 1) / BM;
  return t;
}

__device__ __forceinline__ int dw_tile(const Args& a, int t, int& f0) {
  int o = 0, ft = (a.f[0] + BM - 1) / BM;
  while (t >= ft) {
    t -= ft;
    ++o;
    ft = (a.f[o] + BM - 1) / BM;
  }
  f0 = t * BM;
  return o;
}

// Rows row0 .. row0 + 63 of gz_i (columns f0 .. f0 + 127, two MN blocks) and of y (every
// column, four MN blocks) into `slot`, zero-filled at or past `hi`, past F and past C.
__device__ __forceinline__ void dw_load(const Args& a, int o, int f0, int row0, int hi,
                                        bf16* slot) {
  const int F = a.f[o], C = a.c;
  const bf16* gz = a.gz[o];
#pragma unroll
  for (int j = 0; j < BK * 16 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = i / 16, nc = i % 16, row = row0 + k;
    const bool ok = row < hi && f0 + 8 * nc < F;
    cp_async_16(slot + (nc >> 3) * MN_BLOCK + sw(k, 8 * (nc & 7)),
                gz + (ok ? (size_t)row * F + f0 + 8 * nc : 0), ok ? 16 : 0);
  }
#pragma unroll
  for (int j = 0; j < BK * 32 / THREADS; ++j) {
    const int i = threadIdx.x + j * THREADS;
    const int k = i / 32, row = row0 + k;
    const bool ok = row < hi;
    load_wide_row(slot + A_ELEMS, a.y + (ok ? (size_t)row * C : 0), C, ok, k, i % 32);
  }
}

__global__ void __launch_bounds__(THREADS, 1) ln_denses_bwd_dw_bf16_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* ring = ring_base(smem);
  const int tiles = dw_tiles(a);
  const int range = blockIdx.x / tiles, wg = threadIdx.x / 128;
  int f0;
  const int o = dw_tile(a, blockIdx.x % tiles, f0);
  const int lo = range * a.per, hi = min(a.rows, lo + a.per);
  const int stages = (hi - lo + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < stages) dw_load(a, o, f0, lo + s * BK, hi, ring + s * SLOT);
    cp_async_commit();
  }
  float acc[128];
#pragma unroll 1
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const int sn = s + STAGES - 1;
    if (sn < stages) dw_load(a, o, f0, lo + sn * BK, hi, ring + (sn % STAGES) * SLOT);
    cp_async_commit();
    const bf16* slot = ring + (s % STAGES) * SLOT;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_m64n256k16_ss<1, 1>(acc, sw128_desc_mn(slot + wg * MN_BLOCK + ks * 16 * 64,
                                                   MN_BLOCK * 2),
                                sw128_desc_mn(slot + A_ELEMS + ks * 16 * 64, MN_BLOCK * 2),
                                s > 0 || ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
  }
  cp_async_wait<0>();
  // the thread's rows of the tile are f0 + 64 wg + 16 (warp % 4) + lane / 4 (+ 8)
  const int F = a.f[o], C = a.c;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, tig = lane & 3;
  float* part = a.dw_part[o] + (size_t)range * F * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = f0 + 16 * warp + (lane >> 2) + 8 * h;
    if (f >= F) continue;
#pragma unroll
    for (int j = 0; j < NC / 8; ++j) {
      const int col = 8 * j + 2 * tig;
      if (8 * j < C)
        *reinterpret_cast<float2*>(part + (size_t)f * C + col) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// db_src[i]: output i's partial db, [row tiles][F_i] (the gz launch's or the dy launch's).
template <typename TX>
int launch(const Args& a, const GzArgs& ga, float* dscale, float* dbias, float* const* dw,
           float* const* db, float* const* db_src, cudaStream_t s) {
  int err;
  const int row_tiles = (a.rows + BM - 1) / BM;
  if (ga.ln.n_out > 0) {
    static size_t configured = 0;
    const size_t smem = pcdiff_ln::smem_bytes<bf16>(a.c);
    if ((err = configure(ln_denses_bwd_gz_bf16_kernel<TX>, smem, configured))) return err;
    ln_denses_bwd_gz_bf16_kernel<TX><<<(unsigned)row_tiles * ga.ln.groups, THREADS, smem, s>>>(ga);
    if ((err = (int)cudaGetLastError())) return err;
  }
  static size_t dy_configured = 0, dw_configured = 0;
  if ((err = configure(ln_denses_bwd_dy_bf16_kernel<TX>, dy_smem<TX>(), dy_configured)))
    return err;
  ln_denses_bwd_dy_bf16_kernel<TX><<<(unsigned)row_tiles, THREADS, dy_smem<TX>(), s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  if ((err = configure(ln_denses_bwd_dw_bf16_kernel, SMEM, dw_configured))) return err;
  int tiles = 0;
  for (int o = 0; o < a.n_out; ++o) tiles += (a.f[o] + BM - 1) / BM;
  const int ranges = (a.rows + a.per - 1) / a.per;
  ln_denses_bwd_dw_bf16_kernel<<<(unsigned)(tiles * ranges), THREADS, SMEM, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  SumArgs sa;
  sa.nseg = 0;
  add_seg(sa, a.ln_part, dscale, a.c, row_tiles);
  add_seg(sa, a.ln_part + (size_t)row_tiles * a.c, dbias, a.c, row_tiles);
  for (int o = 0; o < a.n_out; ++o)
    if (db[o] != nullptr) add_seg(sa, db_src[o], db[o], a.f[o], row_tiles);
  for (int o = 0; o < a.n_out; ++o) add_seg(sa, a.dw_part[o], dw[o], a.f[o] * a.c, ranges);
  return sum_launch(sa, s);
}

}  // namespace bf16_path

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

bool valid_outputs(int n_out, const int* f, const int* act, const void* const* w,
                   const void* const* b, const void* const* g, const void* const* dw,
                   const void* const* db, const void* const* dw_part,
                   const void* const* db_part, const void* const* gz) {
  for (int i = 0; i < n_out; ++i) {
    if (f[i] <= 0 || f[i] % 64 != 0 || act[i] < ACT_NONE || act[i] > ACT_QUICK_GELU ||
        w[i] == nullptr || g[i] == nullptr || dw[i] == nullptr || dw_part[i] == nullptr ||
        (act[i] != ACT_NONE && gz[i] == nullptr) ||
        (b[i] != nullptr && (db[i] == nullptr || db_part[i] == nullptr)))
      return false;
  }
  return true;
}

}  // namespace

// The fp32 path (fp32 x or bf16 x, fp32 g and outputs). x, ln_scale, ln_bias, dx, dscale,
// dbias, dy, ln_part: device pointers. w, b, g, f, act, dw, db, gz, dw_part, db_part: HOST
// arrays of n_out entries (b[i], db[i] and db_part[i] null without a bias; gz[i] null without
// an activation). Requires 0 < c <= 256, c % 32 == 0, every f[i] % 64 == 0, 16-byte aligned
// pointers, 1 <= groups <= the activation outputs' 128-column tiles (when there are any), and
// dw_rows > 0 with dw_rows % 32 == 0. Scratch sizes, in fp32 elements, with tiles =
// ceil(rows / 128) and ranges = ceil(rows / dw_rows): dy rows c; gz[i] rows f[i]; ln_part 2
// tiles c; db_part[i] tiles f[i]; dw_part[i] ranges f[i] c. Returns the cudaError_t of the
// launches (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_ln_denses_bwd_fp32(
    const void* x, const void* ln_scale, const void* ln_bias, int n_out,
    const void* const* w, const void* const* b, const void* const* g, const int* f,
    const int* act, void* dx, void* dscale, void* dbias, void* const* dw, void* const* db,
    void* dy, void* const* gz, void* ln_part, void* const* dw_part, void* const* db_part,
    int rows, int c, float eps, int x_bf16, int groups, int dw_rows, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || rows <= 0 || c <= 0 || c > MAX_C || c % 32 != 0 ||
      dw_rows <= 0 || dw_rows % BK != 0 ||
      !valid_outputs(n_out, f, act, w, b, g, dw, db, dw_part, db_part, gz))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {x, ln_scale, ln_bias, dx, dscale, dbias, dy, ln_part};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  Fp32Args a;
  GzArgs ga;
  float* dwp[MAX_OUT];
  float* dbp[MAX_OUT];
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  ga.ln.x = x;
  ga.ln.ln_scale = a.ln_scale;
  ga.ln.ln_bias = a.ln_bias;
  int n_act = 0, act_tiles = 0;
  for (int i = 0; i < MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && (!aligned16(w[i]) || !aligned16(g[i]) || !aligned16(b[i]) || !aligned16(gz[i]) ||
               !aligned16(db_part[i]) || !aligned16(dw_part[i]) || !aligned16(dw[i]) ||
               !aligned16(db[i])))
      return (int)cudaErrorMisalignedAddress;
    const bool has_act = on && act[i] != ACT_NONE;
    a.w[i] = on ? static_cast<const float*>(w[i]) : nullptr;
    a.gz[i] = on ? static_cast<const float*>(has_act ? gz[i] : g[i]) : nullptr;
    a.db_part[i] = on && b[i] != nullptr ? static_cast<float*>(db_part[i]) : nullptr;
    a.dw_part[i] = on ? static_cast<float*>(dw_part[i]) : nullptr;
    a.f[i] = on ? f[i] : 0;
    dwp[i] = on ? static_cast<float*>(dw[i]) : nullptr;
    dbp[i] = on && b[i] != nullptr ? static_cast<float*>(db[i]) : nullptr;
    ga.ln.w[i] = ga.ln.b[i] = nullptr;
    ga.ln.out[i] = nullptr;
    ga.g[i] = nullptr;
    ga.ln.f[i] = 0;
    ga.ln.act[i] = ACT_NONE;
    if (has_act) {  // the gz launch's outputs: those with an activation, in order
      ga.ln.w[n_act] = w[i];
      ga.ln.b[n_act] = static_cast<const float*>(b[i]);
      ga.ln.out[n_act] = gz[i];
      ga.g[n_act] = static_cast<const float*>(g[i]);
      ga.ln.f[n_act] = f[i];
      ga.ln.act[n_act] = act[i];
      act_tiles += (f[i] + pcdiff_ln::Path<float>::BN - 1) / pcdiff_ln::Path<float>::BN;
      ++n_act;
    }
  }
  if (n_act > 0 && (groups < 1 || groups > act_tiles)) return (int)cudaErrorInvalidValue;
  a.n_out = n_out;
  a.rows = rows;
  a.c = c;
  a.eps = eps;
  a.dy = static_cast<float*>(dy);
  a.dx = dx;
  a.ln_part = static_cast<float*>(ln_part);
  a.per = dw_rows;
  ga.ln.n_out = n_act;
  ga.ln.rows = rows;
  ga.ln.c = c;
  ga.ln.groups = groups;
  ga.ln.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dscale);
  float* dbb = static_cast<float*>(dbias);
  return x_bf16 ? launch_fp32<bf16>(a, ga, ds, dbb, dwp, dbp, s)
                : launch_fp32<float>(a, ga, ds, dbb, dwp, dbp, s);
}

// How many blocks of a path's weight-gradient kernel (bf16 != 0: the bf16 path's) an SM of
// the current device holds at once (the occupancy API), for the wrapper's choice of row
// ranges; its tile side (128: the fp32 path's square tiles; the bf16 path's 128 rows of dW_i
// by every column) and stage depth (rows: 32 fp32, 64 bf16). Returns the cudaError_t (0 on
// success).
extern "C" int pcdiff_ln_denses_bwd_tiling(int bf16, int* tile, int* depth, int* blocks_per_sm) {
  *tile = BM;
  if (bf16) {
    static size_t configured = 0;
    *depth = bf16_path::BK;
    if (const int e = configure(bf16_path::ln_denses_bwd_dw_bf16_kernel, bf16_path::SMEM,
                                configured))
      return e;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, bf16_path::ln_denses_bwd_dw_bf16_kernel, THREADS, bf16_path::SMEM);
  }
  static size_t configured = 0;
  *depth = BK;
  if (const int e = configure(ln_denses_bwd_dw_kernel, DW_SMEM, configured)) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            ln_denses_bwd_dw_kernel, THREADS,
                                                            DW_SMEM);
}

// The bf16 path (bf16 g and outputs; x fp32 or bf16). Arguments as the fp32 path's, with w[i]
// the bf16 copies of the weights, the bf16 scratch y [rows, c] in place of dy, and gz[i] bf16;
// dw_rows % 64 == 0, and `groups` counted in the gz launch's 128-column tiles.
extern "C" int pcdiff_ln_denses_bwd_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, int n_out,
    const void* const* w, const void* const* b, const void* const* g, const int* f,
    const int* act, void* dx, void* dscale, void* dbias, void* const* dw, void* const* db,
    void* y, void* const* gz, void* ln_part, void* const* dw_part, void* const* db_part,
    int rows, int c, float eps, int x_bf16, int groups, int dw_rows, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || rows <= 0 || c <= 0 || c > MAX_C || c % 32 != 0 ||
      dw_rows <= 0 || dw_rows % bf16_path::BK != 0 ||
      !valid_outputs(n_out, f, act, w, b, g, dw, db, dw_part, db_part, gz))
    return (int)cudaErrorInvalidValue;
  const void* const ptrs[] = {x, ln_scale, ln_bias, dx, dscale, dbias, y, ln_part};
  for (const void* p : ptrs)
    if (!aligned16(p)) return (int)cudaErrorMisalignedAddress;
  bf16_path::Args a;
  bf16_path::GzArgs ga;
  float* dwp[MAX_OUT];
  float* dbp[MAX_OUT];
  float* db_src[MAX_OUT];
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  ga.ln.x = x;
  ga.ln.ln_scale = a.ln_scale;
  ga.ln.ln_bias = a.ln_bias;
  int n_act = 0, act_tiles = 0;
  for (int i = 0; i < MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && (!aligned16(w[i]) || !aligned16(g[i]) || !aligned16(b[i]) || !aligned16(gz[i]) ||
               !aligned16(db_part[i]) || !aligned16(dw_part[i]) || !aligned16(dw[i]) ||
               !aligned16(db[i])))
      return (int)cudaErrorMisalignedAddress;
    const bool has_act = on && act[i] != ACT_NONE, has_bias = on && b[i] != nullptr;
    a.w[i] = on ? static_cast<const bf16*>(w[i]) : nullptr;
    a.gz[i] = on ? static_cast<const bf16*>(has_act ? gz[i] : g[i]) : nullptr;
    // the dy launch sums g's columns where there is no activation; the gz launch sums the
    // unrounded g act'(z) where there is one
    a.db_part[i] = has_bias && !has_act ? static_cast<float*>(db_part[i]) : nullptr;
    a.dw_part[i] = on ? static_cast<float*>(dw_part[i]) : nullptr;
    a.f[i] = on ? f[i] : 0;
    dwp[i] = on ? static_cast<float*>(dw[i]) : nullptr;
    dbp[i] = has_bias ? static_cast<float*>(db[i]) : nullptr;
    db_src[i] = has_bias ? static_cast<float*>(db_part[i]) : nullptr;
    ga.ln.w[i] = ga.ln.b[i] = nullptr;
    ga.ln.out[i] = nullptr;
    ga.g[i] = nullptr;
    ga.db_part[i] = nullptr;
    ga.ln.f[i] = 0;
    ga.ln.act[i] = ACT_NONE;
    if (has_act) {  // the gz launch's outputs: those with an activation, in order
      ga.ln.w[n_act] = w[i];
      ga.ln.b[n_act] = static_cast<const float*>(b[i]);
      ga.ln.out[n_act] = gz[i];
      ga.g[n_act] = static_cast<const bf16*>(g[i]);
      ga.db_part[n_act] = has_bias ? static_cast<float*>(db_part[i]) : nullptr;
      ga.ln.f[n_act] = f[i];
      ga.ln.act[n_act] = act[i];
      act_tiles += (f[i] + pcdiff_ln::Path<bf16>::BN - 1) / pcdiff_ln::Path<bf16>::BN;
      ++n_act;
    }
  }
  if (n_act > 0 && (groups < 1 || groups > act_tiles)) return (int)cudaErrorInvalidValue;
  a.n_out = n_out;
  a.rows = rows;
  a.c = c;
  a.eps = eps;
  a.y = static_cast<bf16*>(y);
  a.dx = dx;
  a.ln_part = static_cast<float*>(ln_part);
  a.per = dw_rows;
  ga.ln.n_out = n_act;
  ga.ln.rows = rows;
  ga.ln.c = c;
  ga.ln.groups = groups;
  ga.ln.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ds = static_cast<float*>(dscale);
  float* dbb = static_cast<float*>(dbias);
  return x_bf16 ? bf16_path::launch<bf16>(a, ga, ds, dbb, dwp, dbp, db_src, s)
                : bf16_path::launch<float>(a, ga, ds, dbb, dwp, dbp, db_src, s);
}
