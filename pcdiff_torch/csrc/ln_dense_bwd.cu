// Fused LayerNorm -> 1 to 3 projections, backward, for Hopper (sm_90a). x [rows, C]
// row-major; for each output i: W_i [F_i, C] (the nn.Linear layout, fp32), an optional fp32
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
// fp32 model (the train step's: 43.9 ms of a step at 67 TFLOP/s); the bytes (x, g_i, dx, W_i)
// are a few hundred MB at most. The three products contract over different axes with their
// operands as stored: z over C (y rows, W rows: K3's own product), dy over F (gz rows, and
// W's [F, C] rows, which are K-major for it), dW over the rows (gz and y, both K-major).
// What has no counterpart: the TPU kernel sums dW_i, db_i, dscale and dbias across a
// sequential grid. Blocks here run in no order, so each writes partial sums that a last
// launch adds in a fixed order, with no atomics, and the result is the same from run to run.
//
// fp32 path (fp32 outputs, the train step's), on ln_dense_fwd.cuh: every product on its
// 8 x 8 FMA register tile a thread (fma_stage_fp32, 16-byte shared loads, no TF32), both
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
// bf16 path (bf16 outputs; on no timed path): (a) one block per 64 rows recomputes the LN
// and z with WMMA, forms gz (kept in bf16 in the scratch where there is an activation) and
// the block's partial db, dy in WMMA fragments, then dx and the partial dscale and dbias;
// (b) one block per (64 x 64 tile of dW_i, range of rows), WMMA; (c) the same sum launch.

#include <cstdint>
#include <mma.h>

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

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

// ============================== bf16 path (WMMA) ==============================

namespace wmma_path {

using namespace nvcuda;

constexpr int BM = 64;        // rows per block of pass (a), per step of pass (b)
constexpr int BN = 64;        // columns of a W / dW tile
constexpr int LD_E = BN + 4;  // fp32 [BM][BN] staging pitch
constexpr int LD_G = BN + 8;  // bf16 [BM][BN] pitch

struct BwdArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const float* w[MAX_OUT];
  const float* b[MAX_OUT];
  const bf16* g[MAX_OUT];
  bf16* gz[MAX_OUT];       // [rows, F_i]; null without an activation
  float* db_part[MAX_OUT]; // [blocks, F_i]; null without a bias
  int f[MAX_OUT];
  int act[MAX_OUT];
  int n_out;
  int rows;
  int c;
  float eps;
  void* dx;
  float2* stats;           // (mean, rstd) per row
  float* ln_part;          // [2, blocks, C]: partial dscale, then partial dbias
};

__host__ __device__ constexpr int row_pitch(int c) { return c + 8; }

size_t rows_smem_bytes(int c) {
  const size_t panels = 2 * (size_t)BM * row_pitch(c) * sizeof(bf16);  // y, W tile
  const size_t stage = (size_t)BM * LD_E * sizeof(float);
  const size_t gz = (size_t)BM * LD_G * sizeof(bf16);
  return panels + stage + gz + 2 * BM * sizeof(float);
}

__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case ACT_GELU: return pcdiff_ln::act_grad<ACT_GELU>(z);
    case ACT_GELU_TANH: return pcdiff_ln::act_grad<ACT_GELU_TANH>(z);
    case ACT_QUICK_GELU: return pcdiff_ln::act_grad<ACT_QUICK_GELU>(z);
    default: return 1.f;
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Pass (a): one block per BM rows.
template <typename TX>
__global__ void __launch_bounds__(THREADS) ln_denses_bwd_wmma_rows_kernel(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.c;
  const int ldy = row_pitch(C);
  bf16* sy = reinterpret_cast<bf16*>(smem);             // y
  bf16* sw = sy + BM * ldy;                              // one BN-row tile of W_i
  float* se = reinterpret_cast<float*>(sw + BN * ldy);   // z, then gz in fp32
  bf16* sgz = reinterpret_cast<bf16*>(se + BM * LD_E);   // gz in bf16
  float* smean = reinterpret_cast<float*>(sgz + BM * LD_G);
  float* srstd = smean + BM;
  float* sdy = reinterpret_cast<float*>(smem);           // dy, over y and W once they are done
  const int ldd = C + 4;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * BM;
  const TX* x = static_cast<const TX*>(a.x);

  // LayerNorm statistics and y, as the forward kernel computes them.
  for (int r = warp; r < BM; r += WARPS) {
    const int row = r0 + r;
    bf16* yr = sy + r * ldy;
    if (row >= a.rows) {
      for (int c = lane; c < C; c += 32) yr[c] = __float2bfloat16(0.f);
      if (lane == 0) smean[r] = srstd[r] = 0.f;
      continue;
    }
    const TX* xr = x + (size_t)row * C;
    float s = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float v = to_f32(xr[c]);
      s += v;
      s2 += v * v;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_xor_sync(0xffffffffu, s, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float mean = __fdiv_rn(s, (float)C);
    const float var = fmaxf(__fsub_rn(__fdiv_rn(s2, (float)C), __fmul_rn(mean, mean)), 0.f);
    const float rstd = rsqrtf(__fadd_rn(var, a.eps));
    if (lane == 0) {
      smean[r] = mean;
      srstd[r] = rstd;
      a.stats[row] = make_float2(mean, rstd);
    }
    for (int c = lane; c < C; c += 32) {
      const float y = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
      yr[c] = __float2bfloat16(__fadd_rn(__fmul_rn(y, a.ln_scale[c]), a.ln_bias[c]));
    }
  }
  __syncthreads();

  // dy accumulators: warp w owns rows 16 (w / 2) .. + 16 and the C / 2 columns of half w % 2,
  // as C / 32 fragments.
  FragC dfr[MAX_C / 32];
#pragma unroll
  for (int j = 0; j < MAX_C / 32; ++j) wmma::fill_fragment(dfr[j], 0.f);

  for (int o = 0; o < a.n_out; ++o) {
    const int F = a.f[o];
    const float* __restrict__ w = a.w[o];
    const float* __restrict__ bias = a.b[o];
    const int act = a.act[o];
    const bf16* __restrict__ g = a.g[o];
    bf16* __restrict__ gz = a.gz[o];
    for (int f0 = 0; f0 < F; f0 += BN) {
      for (int i = tid; i < BN * C; i += THREADS) {
        const int n = i / C, c = i - n * C;
        sw[n * ldy + c] = __float2bfloat16(w[(size_t)(f0 + n) * C + c]);
      }
      __syncthreads();
      if (act != ACT_NONE) {  // z = y W^T (+ b), the forward's product, into se
        const int wm = warp / 2;
        const int wn = (warp % 2) * 2;
        FragC acc[2];
        wmma::fill_fragment(acc[0], 0.f);
        wmma::fill_fragment(acc[1], 0.f);
        for (int k0 = 0; k0 < C; k0 += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
          wmma::load_matrix_sync(fa, sy + wm * 16 * ldy + k0, ldy);
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;
            wmma::load_matrix_sync(fb, sw + (wn + j) * 16 * ldy + k0, ldy);
            wmma::mma_sync(acc[j], fa, fb, acc[j]);
          }
        }
        for (int j = 0; j < 2; ++j)
          wmma::store_matrix_sync(se + wm * 16 * LD_E + (wn + j) * 16, acc[j], LD_E,
                                  wmma::mem_row_major);
        __syncthreads();
      }
      // gz = g act'(z) in fp32 (se), in bf16 (sgz, and the scratch for (b))
      for (int i = tid; i < BM * BN; i += THREADS) {
        const int r = i / BN, c = i - r * BN;
        const int row = r0 + r;
        float v = 0.f;
        if (row < a.rows) {
          v = __bfloat162float(g[(size_t)row * F + f0 + c]);
          if (act != ACT_NONE) {
            float z = se[r * LD_E + c];
            if (bias != nullptr) z = __fadd_rn(z, bias[f0 + c]);
            v = __fmul_rn(v, act_grad(z, act));
            gz[(size_t)row * F + f0 + c] = __float2bfloat16(v);
          }
        }
        se[r * LD_E + c] = v;
        sgz[r * LD_G + c] = __float2bfloat16(v);
      }
      __syncthreads();
      if (bias != nullptr && tid < BN) {  // this block's part of db, from the fp32 gz
        float s = 0.f;
        for (int r = 0; r < BM; ++r) s += se[r * LD_E + tid];
        a.db_part[o][(size_t)blockIdx.x * F + f0 + tid] = s;
      }
      // dy += gz W_tile
      const int slab = warp / 2;
      const int cbase = (warp % 2) * (C / 2);
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, sgz + slab * 16 * LD_G + kk * 16, LD_G);
#pragma unroll
        for (int j = 0; j < MAX_C / 32; ++j) {
          if (j < C / 32) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
            wmma::load_matrix_sync(fb, sw + kk * 16 * ldy + cbase + j * 16, ldy);
            wmma::mma_sync(dfr[j], fa, fb, dfr[j]);
          }
        }
      }
      __syncthreads();  // sw, se and sgz are rewritten by the next tile
    }
  }

  // dy to shared memory (over y and W, which are done)
  {
    const int slab = warp / 2;
    const int cbase = (warp % 2) * (C / 2);
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j)
      if (j < C / 32)
        wmma::store_matrix_sync(sdy + slab * 16 * ldd + cbase + j * 16, dfr[j], ldd,
                                wmma::mem_row_major);
  }
  __syncthreads();

  // dx, a warp per row
  TX* dx = static_cast<TX*>(a.dx);
  for (int r = warp; r < BM; r += WARPS) {
    const int row = r0 + r;
    if (row >= a.rows) continue;
    const TX* xr = x + (size_t)row * C;
    const float mean = smean[r], rstd = srstd[r];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float xhat = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
      const float dxh = __fmul_rn(sdy[r * ldd + c], a.ln_scale[c]);
      s1 += dxh;
      s2 += dxh * xhat;
    }
    for (int off = 16; off > 0; off >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      s2 += __shfl_xor_sync(0xffffffffu, s2, off);
    }
    const float m1 = __fdiv_rn(s1, (float)C);
    const float m2 = __fdiv_rn(s2, (float)C);
    for (int c = lane; c < C; c += 32) {
      const float xhat = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
      const float dxh = __fmul_rn(sdy[r * ldd + c], a.ln_scale[c]);
      const float v = __fmul_rn(rstd, __fsub_rn(__fsub_rn(dxh, m1), __fmul_rn(xhat, m2)));
      dx[(size_t)row * C + c] = from_f32<TX>(v);
    }
  }

  // this block's part of dscale and dbias, a thread per column
  if (tid < C) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < BM; ++r) {
      const int row = r0 + r;
      if (row >= a.rows) break;
      const float xhat = __fmul_rn(__fsub_rn(to_f32(x[(size_t)row * C + tid]), smean[r]),
                                   srstd[r]);
      const float d = sdy[r * ldd + tid];
      ds += d * xhat;
      db += d;
    }
    a.ln_part[(size_t)blockIdx.x * C + tid] = ds;
    a.ln_part[((size_t)gridDim.x + blockIdx.x) * C + tid] = db;
  }
}

// Pass (b): one block per (64 x 64 tile of dW_i, range of rows) -> a partial tile in
// part[range][F][C].
template <typename TX>
__global__ void __launch_bounds__(THREADS)
ln_denses_bwd_wmma_dw_kernel(const void* xv, const float2* __restrict__ stats,
                             const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                             const bf16* __restrict__ gz, float* __restrict__ part, int rows,
                             int C, int F, int rows_per_range) {
  constexpr int PANEL = BM * LD_G * (int)sizeof(bf16);
  constexpr int BYTES = 2 * PANEL > BN * LD_E * 4 ? 2 * PANEL : BN * LD_E * 4;
  __shared__ __align__(128) unsigned char buf[BYTES];
  bf16* sgz = reinterpret_cast<bf16*>(buf);          // [row][f]
  bf16* sy = reinterpret_cast<bf16*>(buf + PANEL);   // [row][c]
  float* se = reinterpret_cast<float*>(buf);         // the finished tile, over sgz and sy
  const TX* x = static_cast<const TX*>(xv);
  const int ctiles = (C + BN - 1) / BN;
  const int f0 = (blockIdx.x / ctiles) * BN;
  const int c0 = (blockIdx.x % ctiles) * BN;
  const int lo = blockIdx.y * rows_per_range;
  const int hi = min(rows, lo + rows_per_range);
  const int tid = threadIdx.x;
  const int warp = tid / 32;

  FragC acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);

  for (int r0 = lo; r0 < hi; r0 += BM) {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, j = i - r * BN;
      const int row = r0 + r;
      const int c = c0 + j;
      float yv = 0.f;
      bf16 gv = __float2bfloat16(0.f);
      if (row < hi) {
        gv = gz[(size_t)row * F + f0 + j];
        if (c < C) {
          const float2 st = stats[row];
          const float xh = __fmul_rn(__fsub_rn(to_f32(x[(size_t)row * C + c]), st.x), st.y);
          yv = __fadd_rn(__fmul_rn(xh, ln_scale[c]), ln_bias[c]);
        }
      }
      sgz[r * LD_G + j] = gv;
      sy[r * LD_G + j] = __float2bfloat16(yv);
    }
    __syncthreads();
    const int fs = warp / 2;        // 16-row slab of f
    const int cn = (warp % 2) * 2;  // first of two 16-column fragments of c
    for (int kk = 0; kk < BM / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;  // gz^T
      wmma::load_matrix_sync(fa, sgz + kk * 16 * LD_G + fs * 16, LD_G);
      for (int j = 0; j < 2; ++j) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, sy + kk * 16 * LD_G + (cn + j) * 16, LD_G);
        wmma::mma_sync(acc[j], fa, fb, acc[j]);
      }
    }
    __syncthreads();
  }

  {
    const int fs = warp / 2;
    const int cn = (warp % 2) * 2;
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(se + fs * 16 * LD_E + (cn + j) * 16, acc[j], LD_E,
                              wmma::mem_row_major);
  }
  __syncthreads();
  float* dst = part + (size_t)blockIdx.y * F * C;
  for (int i = tid; i < BN * BN; i += THREADS) {
    const int f = i / BN, j = i - f * BN;
    if (c0 + j < C) dst[(size_t)(f0 + f) * C + c0 + j] = se[f * LD_E + j];
  }
}

template <typename TX>
int launch(const BwdArgs& a, float* dscale, float* dbias, float* const* dw, float* const* db,
           float* const* dw_part, const int* dw_split, cudaStream_t s) {
  static size_t configured = 0;
  int err;
  const size_t smem = rows_smem_bytes(a.c);
  if ((err = configure(ln_denses_bwd_wmma_rows_kernel<TX>, smem, configured))) return err;
  const int blocks = (a.rows + BM - 1) / BM;
  ln_denses_bwd_wmma_rows_kernel<TX><<<blocks, THREADS, smem, s>>>(a);
  if ((err = (int)cudaGetLastError())) return err;
  const int ctiles = (a.c + BN - 1) / BN;
  SumArgs sa;
  sa.nseg = 0;
  for (int o = 0; o < a.n_out; ++o) {
    const int F = a.f[o];
    const int per = (blocks + dw_split[o] - 1) / dw_split[o] * BM;
    const int ranges = (a.rows + per - 1) / per;  // <= dw_split[o]; the rest stays unused
    const bf16* src = a.gz[o] != nullptr ? a.gz[o] : a.g[o];
    ln_denses_bwd_wmma_dw_kernel<TX><<<dim3((F / BN) * ctiles, ranges), THREADS, 0, s>>>(
        a.x, a.stats, a.ln_scale, a.ln_bias, src, dw_part[o], a.rows, a.c, F, per);
    if ((err = (int)cudaGetLastError())) return err;
    add_seg(sa, dw_part[o], dw[o], F * a.c, ranges);
    if (db[o] != nullptr) add_seg(sa, a.db_part[o], db[o], F, blocks);
  }
  add_seg(sa, a.ln_part, dscale, a.c, blocks);
  add_seg(sa, a.ln_part + (size_t)blocks * a.c, dbias, a.c, blocks);
  return sum_launch(sa, s);
}

}  // namespace wmma_path

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

// How many blocks of the fp32 path's weight-gradient kernel an SM of the current device holds
// at once (the occupancy API), for the wrapper's choice of row ranges; its tile side (128) and
// stage depth (32 rows). Returns the cudaError_t (0 on success).
extern "C" int pcdiff_ln_denses_bwd_tiling(int* tile, int* depth, int* blocks_per_sm) {
  static size_t configured = 0;
  *tile = BM;
  *depth = BK;
  if (const int e = configure(ln_denses_bwd_dw_kernel, DW_SMEM, configured)) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                            ln_denses_bwd_dw_kernel, THREADS,
                                                            DW_SMEM);
}

// The bf16 path (bf16 g and outputs; x fp32 or bf16). Arguments as the fp32 path's, with the
// statistics scratch stats (2 rows fp32) in place of dy, gz[i] bf16 [rows, f[i]], ln_part 2
// blocks c and db_part[i] blocks f[i] with blocks = ceil(rows / 64), dw_part[i] dw_split[i]
// f[i] c, and dw_split[i] the row ranges of output i's weight gradient.
extern "C" int pcdiff_ln_denses_bwd_bf16(
    const void* x, const void* ln_scale, const void* ln_bias, int n_out,
    const void* const* w, const void* const* b, const void* const* g, const int* f,
    const int* act, void* dx, void* dscale, void* dbias, void* const* dw, void* const* db,
    void* stats, void* const* gz, void* ln_part, void* const* dw_part,
    void* const* db_part, const int* dw_split, int rows, int c, float eps, int x_bf16,
    void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || rows <= 0 || c <= 0 || c > MAX_C || c % 32 != 0 ||
      !valid_outputs(n_out, f, act, w, b, g, dw, db, dw_part, db_part, gz))
    return (int)cudaErrorInvalidValue;
  wmma_path::BwdArgs a;
  float* dwp[MAX_OUT];
  float* dbp[MAX_OUT];
  float* dwpart[MAX_OUT];
  int split[MAX_OUT];
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  for (int i = 0; i < MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && dw_split[i] <= 0) return (int)cudaErrorInvalidValue;
    a.w[i] = on ? static_cast<const float*>(w[i]) : nullptr;
    a.b[i] = on ? static_cast<const float*>(b[i]) : nullptr;
    a.g[i] = on ? static_cast<const bf16*>(g[i]) : nullptr;
    a.gz[i] = on && act[i] != ACT_NONE ? static_cast<bf16*>(gz[i]) : nullptr;
    a.db_part[i] = on ? static_cast<float*>(db_part[i]) : nullptr;
    a.f[i] = on ? f[i] : 0;
    a.act[i] = on ? act[i] : ACT_NONE;
    dwp[i] = on ? static_cast<float*>(dw[i]) : nullptr;
    dbp[i] = on && b[i] != nullptr ? static_cast<float*>(db[i]) : nullptr;
    dwpart[i] = on ? static_cast<float*>(dw_part[i]) : nullptr;
    split[i] = on ? dw_split[i] : 1;
  }
  a.n_out = n_out;
  a.rows = rows;
  a.c = c;
  a.eps = eps;
  a.dx = dx;
  a.stats = static_cast<float2*>(stats);
  a.ln_part = static_cast<float*>(ln_part);
  float* ds = static_cast<float*>(dscale);
  float* dbb = static_cast<float*>(dbias);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return x_bf16 ? wmma_path::launch<bf16>(a, ds, dbb, dwp, dbp, dwpart, split, s)
                : wmma_path::launch<float>(a, ds, dbb, dwp, dbp, dwpart, split, s);
}
