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
// fp32 model; the bytes (x, g_i, dx, W_i) are a few hundred MB at most.
// What has no counterpart: the TPU kernel sums dW_i, db_i, dscale and dbias across a
// sequential grid. Blocks here run in no order, so the sums are taken in a fixed order in
// separate passes, with no atomics, and the result is the same from run to run:
//   (a) rows: one block of 256 threads per 64 rows. It recomputes the LN statistics (kept
//       per row for (b)) and y into shared memory, then for each 64-column tile of each
//       output stages W, recomputes z where there is an activation, forms gz (kept in the
//       product dtype in a scratch buffer for (b) where there is an activation; g itself
//       serves otherwise), writes the block's partial db, and accumulates the block's
//       64 x C dy in registers (WMMA fragments in bf16, 4 x 16 FMA accumulators a thread in
//       fp32). Then dx, and the block's partial dscale and dbias.
//   (b) weight gradients: one block per (64 x 64 tile of dW_i, range of rows); it walks its
//       rows 64 at a time, recomputing y from x and the saved statistics, and writes its
//       partial tile. The ranges are chosen so that the tiles fill the card.
//   (c) fixed-order sums of the partials into dscale, dbias, dW_i and db_i.
// The partials are small (a [64 x C] dW tile is not kept per row block: the row blocks of
// (b) are long).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows per block of pass (a), per step of pass (b)
constexpr int BN = 64;        // columns of a W / dW tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LD_E = BN + 4;  // fp32 [BM][BN] staging pitch
constexpr int LD_G = BN + 8;  // bf16 [BM][BN] pitch
constexpr int MAX_OUT = 3;
constexpr int MAX_C = 256;

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3 };

struct BwdArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const float* w[MAX_OUT];
  const float* b[MAX_OUT];
  const void* g[MAX_OUT];  // output dtype
  void* gz[MAX_OUT];       // product dtype, [rows, F_i]; null without an activation
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

template <typename TO>
struct UseMma {
  static constexpr bool value = std::is_same<TO, bf16>::value;
};

template <typename TO>
__host__ __device__ constexpr int row_pitch(int c) { return UseMma<TO>::value ? c + 8 : c + 1; }

template <typename TO>
size_t rows_smem_bytes(int c) {
  const size_t panels = 2 * (size_t)BM * row_pitch<TO>(c) * sizeof(TO);  // y, W tile
  const size_t stage = (size_t)BM * LD_E * sizeof(float);
  const size_t gz = UseMma<TO>::value ? (size_t)BM * LD_G * sizeof(bf16) : 0;
  return panels + stage + gz + 2 * BM * sizeof(float);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16(v); }

// _erf_f32: XLA's fp32 erf rational (pcdiff/ops/ln_dense.py), evaluated in the same order.
__device__ __forceinline__ float erf_f32(float x) {
  x = fminf(fmaxf(x, -4.f), 4.f);
  const float x2 = __fmul_rn(x, x);
  float p = 0.00022905065861350646f;
  p = __fadd_rn(__fmul_rn(p, x2), 0.0034082910107109506f);
  p = __fadd_rn(__fmul_rn(p, x2), 0.050955695062380861f);
  p = __fadd_rn(__fmul_rn(p, x2), 0.18520832239976145f);
  p = __fadd_rn(__fmul_rn(p, x2), 1.128379143519084f);
  float q = -1.1791602954361697e-7f;
  q = __fadd_rn(__fmul_rn(q, x2), 0.000023547966471313185f);
  q = __fadd_rn(__fmul_rn(q, x2), 0.0010179625278914885f);
  q = __fadd_rn(__fmul_rn(q, x2), 0.014070470171167667f);
  q = __fadd_rn(__fmul_rn(q, x2), 0.11098505178285362f);
  q = __fadd_rn(__fmul_rn(q, x2), 0.49746925110067538f);
  q = __fadd_rn(__fmul_rn(q, x2), 1.0f);
  return __fdiv_rn(__fmul_rn(x, p), q);
}

__device__ __forceinline__ float clamp30(float v) { return fminf(fmaxf(v, -30.f), 30.f); }

// _act_grad: d act(z) / dz.
__device__ __forceinline__ float act_grad(float z, int act) {
  switch (act) {
    case ACT_GELU: {
      const float phi = __fmul_rn(expf(__fmul_rn(__fmul_rn(z, z), -0.5f)),
                                  0.3989422804014327f);
      const float cdf = __fmul_rn(0.5f, __fadd_rn(1.f, erf_f32(__fmul_rn(z, 0.70710678118654752f))));
      return __fadd_rn(cdf, __fmul_rn(z, phi));
    }
    case ACT_GELU_TANH: {
      const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, z), z), z);
      const float u2 = __fmul_rn(1.5957691216057308f, __fadd_rn(z, cube));
      const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(clamp30(-u2))));
      const float up = __fmul_rn(0.7978845608028654f,
                                 __fadd_rn(1.f, __fmul_rn(__fmul_rn(0.134145f, z), z)));
      return __fadd_rn(s, __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(2.f, z), up), s),
                                    __fsub_rn(1.f, s)));
    }
    case ACT_QUICK_GELU: {
      const float s = __fdiv_rn(1.f, __fadd_rn(1.f, expf(clamp30(__fmul_rn(-1.702f, z)))));
      return __fmul_rn(s, __fadd_rn(1.f, __fmul_rn(__fmul_rn(1.702f, z), __fsub_rn(1.f, s))));
    }
    default:
      return 1.f;
  }
}

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Pass (a): one block per BM rows.
template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS) ln_denses_bwd_rows(const BwdArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.c;
  const int ldy = row_pitch<TO>(C);
  TO* sy = reinterpret_cast<TO*>(smem);               // y, product dtype
  TO* sw = sy + BM * ldy;                              // one BN-row tile of W_i
  float* se = reinterpret_cast<float*>(sw + BN * ldy); // z, then gz in fp32
  bf16* sgz = reinterpret_cast<bf16*>(se + BM * LD_E); // gz in bf16 (bf16 path)
  float* smean = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(sgz) + (UseMma<TO>::value ? BM * LD_G * 2 : 0));
  float* srstd = smean + BM;
  float* sdy = reinterpret_cast<float*>(smem);         // dy, over y and W once they are done
  const int ldd = C + 4;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * BM;
  const TX* x = static_cast<const TX*>(a.x);

  // LayerNorm statistics and y, as the forward kernel computes them.
  for (int r = warp; r < BM; r += WARPS) {
    const int row = r0 + r;
    TO* yr = sy + r * ldy;
    if (row >= a.rows) {
      for (int c = lane; c < C; c += 32) yr[c] = from_f32<TO>(0.f);
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
      yr[c] = from_f32<TO>(__fadd_rn(__fmul_rn(y, a.ln_scale[c]), a.ln_bias[c]));
    }
  }
  __syncthreads();

  // dy accumulators. bf16: warp w owns rows 16 (w / 2) .. + 16 and the C / 2 columns of
  // half w % 2, as C / 32 fragments. fp32: thread (ty, tx) owns rows ty + 16 i and
  // columns tx + 16 j.
  FragC dfr[MAX_C / 32];
  float dacc[4][MAX_C / 16];
  const int tx = tid % 16, ty = tid / 16;
  if constexpr (UseMma<TO>::value) {
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j) wmma::fill_fragment(dfr[j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_C / 16; ++j) dacc[i][j] = 0.f;
  }

  for (int o = 0; o < a.n_out; ++o) {
    const int F = a.f[o];
    const float* __restrict__ w = a.w[o];
    const float* __restrict__ bias = a.b[o];
    const int act = a.act[o];
    const TO* __restrict__ g = static_cast<const TO*>(a.g[o]);
    TO* __restrict__ gz = static_cast<TO*>(a.gz[o]);
    for (int f0 = 0; f0 < F; f0 += BN) {
      for (int i = tid; i < BN * C; i += THREADS) {
        const int n = i / C, c = i - n * C;
        sw[n * ldy + c] = from_f32<TO>(w[(size_t)(f0 + n) * C + c]);
      }
      __syncthreads();
      if (act != ACT_NONE) {  // z = y W^T (+ b), the forward's product, into se
        if constexpr (UseMma<TO>::value) {
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
        } else {
          float acc[4][4];
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
          for (int c = 0; c < C; ++c) {
            float av[4], bv[4];
            for (int i = 0; i < 4; ++i) av[i] = to_f32(sy[(ty + 16 * i) * ldy + c]);
            for (int j = 0; j < 4; ++j) bv[j] = to_f32(sw[(tx + 16 * j) * ldy + c]);
            for (int i = 0; i < 4; ++i)
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
          for (int i = 0; i < 4; ++i)
            for (int j = 0; j < 4; ++j) se[(ty + 16 * i) * LD_E + tx + 16 * j] = acc[i][j];
        }
        __syncthreads();
      }
      // gz = g act'(z) in fp32 (se), in the product dtype (sgz, and the scratch for (b))
      for (int i = tid; i < BM * BN; i += THREADS) {
        const int r = i / BN, c = i - r * BN;
        const int row = r0 + r;
        float v = 0.f;
        if (row < a.rows) {
          v = to_f32(g[(size_t)row * F + f0 + c]);
          if (act != ACT_NONE) {
            float z = se[r * LD_E + c];
            if (bias != nullptr) z = __fadd_rn(z, bias[f0 + c]);
            v = __fmul_rn(v, act_grad(z, act));
            gz[(size_t)row * F + f0 + c] = from_f32<TO>(v);
          }
        }
        se[r * LD_E + c] = v;
        if constexpr (UseMma<TO>::value) sgz[r * LD_G + c] = __float2bfloat16(v);
      }
      __syncthreads();
      if (bias != nullptr && tid < BN) {  // this block's part of db, from the fp32 gz
        float s = 0.f;
        for (int r = 0; r < BM; ++r) s += se[r * LD_E + tid];
        a.db_part[o][(size_t)blockIdx.x * F + f0 + tid] = s;
      }
      // dy += gz W_tile
      if constexpr (UseMma<TO>::value) {
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
      } else {
        for (int n = 0; n < BN; ++n) {
          float av[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) av[i] = se[(ty + 16 * i) * LD_E + n];
#pragma unroll
          for (int j = 0; j < MAX_C / 16; ++j) {
            if (j < C / 16) {
              const float bv = to_f32(sw[n * ldy + tx + 16 * j]);
#pragma unroll
              for (int i = 0; i < 4; ++i) dacc[i][j] = fmaf(av[i], bv, dacc[i][j]);
            }
          }
        }
      }
      __syncthreads();  // sw, se and sgz are rewritten by the next tile
    }
  }

  // dy to shared memory (over y and W, which are done)
  if constexpr (UseMma<TO>::value) {
    const int slab = warp / 2;
    const int cbase = (warp % 2) * (C / 2);
#pragma unroll
    for (int j = 0; j < MAX_C / 32; ++j)
      if (j < C / 32)
        wmma::store_matrix_sync(sdy + slab * 16 * ldd + cbase + j * 16, dfr[j], ldd,
                                wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < MAX_C / 16; ++j)
        if (j < C / 16) sdy[(ty + 16 * i) * ldd + tx + 16 * j] = dacc[i][j];
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
template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS)
ln_denses_bwd_dw(const void* xv, const float2* __restrict__ stats,
                 const float* __restrict__ ln_scale, const float* __restrict__ ln_bias,
                 const void* gzv, float* __restrict__ part, int rows, int C, int F,
                 int rows_per_range) {
  constexpr int PANEL = BM * LD_G * (int)sizeof(TO);
  constexpr int BYTES = 2 * PANEL > BN * LD_E * 4 ? 2 * PANEL : BN * LD_E * 4;
  __shared__ __align__(128) unsigned char buf[BYTES];
  TO* sgz = reinterpret_cast<TO*>(buf);          // [row][f]
  TO* sy = reinterpret_cast<TO*>(buf + PANEL);   // [row][c]
  float* se = reinterpret_cast<float*>(buf);     // the finished tile, over sgz and sy
  const TX* x = static_cast<const TX*>(xv);
  const TO* gz = static_cast<const TO*>(gzv);
  const int ctiles = (C + BN - 1) / BN;
  const int f0 = (blockIdx.x / ctiles) * BN;
  const int c0 = (blockIdx.x % ctiles) * BN;
  const int lo = blockIdx.y * rows_per_range;
  const int hi = min(rows, lo + rows_per_range);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int tx = tid % 16, ty = tid / 16;

  FragC acc[2];
  float facc[4][4];
  if constexpr (UseMma<TO>::value) {
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.f;
  }

  for (int r0 = lo; r0 < hi; r0 += BM) {
    for (int i = tid; i < BM * BN; i += THREADS) {
      const int r = i / BN, j = i - r * BN;
      const int row = r0 + r;
      const int c = c0 + j;
      float yv = 0.f;
      TO gv = from_f32<TO>(0.f);
      if (row < hi) {
        gv = gz[(size_t)row * F + f0 + j];
        if (c < C) {
          const float2 st = stats[row];
          const float xh = __fmul_rn(__fsub_rn(to_f32(x[(size_t)row * C + c]), st.x), st.y);
          yv = __fadd_rn(__fmul_rn(xh, ln_scale[c]), ln_bias[c]);
        }
      }
      sgz[r * LD_G + j] = gv;
      sy[r * LD_G + j] = from_f32<TO>(yv);
    }
    __syncthreads();
    if constexpr (UseMma<TO>::value) {
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
    } else {
      for (int r = 0; r < BM; ++r) {
        float av[4], bv[4];
        for (int i = 0; i < 4; ++i) av[i] = to_f32(sgz[r * LD_G + ty + 16 * i]);
        for (int j = 0; j < 4; ++j) bv[j] = to_f32(sy[r * LD_G + tx + 16 * j]);
        for (int i = 0; i < 4; ++i)
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], bv[j], facc[i][j]);
      }
    }
    __syncthreads();
  }

  if constexpr (UseMma<TO>::value) {
    const int fs = warp / 2;
    const int cn = (warp % 2) * 2;
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(se + fs * 16 * LD_E + (cn + j) * 16, acc[j], LD_E,
                              wmma::mem_row_major);
  } else {
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) se[(ty + 16 * i) * LD_E + tx + 16 * j] = facc[i][j];
  }
  __syncthreads();
  float* dst = part + (size_t)blockIdx.y * F * C;
  for (int i = tid; i < BN * BN; i += THREADS) {
    const int f = i / BN, j = i - f * BN;
    if (c0 + j < C) dst[(size_t)(f0 + f) * C + c0 + j] = se[f * LD_E + j];
  }
}

// Pass (c): out[j] = sum over s of part[s][j], in order.
__global__ void __launch_bounds__(THREADS)
sum_partials(const float* __restrict__ part, int nsplit, int n, float* __restrict__ out) {
  const int j = blockIdx.x * THREADS + threadIdx.x;
  if (j >= n) return;
  float s = 0.f;
  for (int k = 0; k < nsplit; ++k) s += part[(size_t)k * n + j];
  out[j] = s;
}

int sum_into(const float* part, int nsplit, int n, float* out, cudaStream_t s) {
  sum_partials<<<(n + THREADS - 1) / THREADS, THREADS, 0, s>>>(part, nsplit, n, out);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int launch(const BwdArgs& a, float* dscale, float* dbias, float* const* dw, float* const* db,
           float* const* dw_part, const int* dw_split, cudaStream_t s) {
  static size_t configured = 0;
  const size_t smem = rows_smem_bytes<TO>(a.c);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_denses_bwd_rows<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  const int blocks = (a.rows + BM - 1) / BM;
  ln_denses_bwd_rows<TX, TO><<<blocks, THREADS, smem, s>>>(a);
  int err = (int)cudaGetLastError();
  if (err) return err;
  const int ctiles = (a.c + BN - 1) / BN;
  for (int o = 0; o < a.n_out; ++o) {
    const int F = a.f[o];
    const int chunks = (a.rows + BM - 1) / BM;
    const int per = (chunks + dw_split[o] - 1) / dw_split[o] * BM;
    const int ranges = (a.rows + per - 1) / per;  // <= dw_split[o]; the rest stays unused
    const void* src = a.act[o] != ACT_NONE ? a.gz[o] : a.g[o];
    ln_denses_bwd_dw<TX, TO><<<dim3((F / BN) * ctiles, ranges), THREADS, 0, s>>>(
        a.x, a.stats, a.ln_scale, a.ln_bias, src, dw_part[o], a.rows, a.c, F, per);
    if ((err = (int)cudaGetLastError())) return err;
    if ((err = sum_into(dw_part[o], ranges, F * a.c, dw[o], s))) return err;
    if (db[o] != nullptr && (err = sum_into(a.db_part[o], blocks, F, db[o], s))) return err;
  }
  if ((err = sum_into(a.ln_part, blocks, a.c, dscale, s))) return err;
  return sum_into(a.ln_part + (size_t)blocks * a.c, blocks, a.c, dbias, s);
}

}  // namespace

// x, ln_scale, ln_bias, dx, dscale, dbias, stats, ln_part: device pointers. w, b, g, f, act,
// dw, db, gz, dw_part, db_part, dw_split: HOST arrays of n_out entries (b[i], db[i] and
// db_part[i] null without a bias; gz[i] null without an activation). Requires
// 0 < c <= 256, c % 32 == 0, every f[i] % 64 == 0. x_bf16 / out_bf16 select the dtypes of x
// (and dx) and of g (the product dtype is the output's). Scratch sizes, in elements:
// stats 2 rows; gz[i] rows f[i]; ln_part 2 blocks c; dw_part[i] dw_split[i] f[i] c;
// db_part[i] blocks f[i]; blocks = ceil(rows / 64). Returns the cudaError_t of the
// launches (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_ln_denses_bwd(
    const void* x, const void* ln_scale, const void* ln_bias, int n_out,
    const void* const* w, const void* const* b, const void* const* g, const int* f,
    const int* act, void* dx, void* dscale, void* dbias, void* const* dw, void* const* db,
    void* stats, void* const* gz, void* ln_part, void* const* dw_part,
    void* const* db_part, const int* dw_split, int rows, int c, float eps, int x_bf16,
    int out_bf16, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || rows <= 0 || c <= 0 || c > MAX_C || c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  BwdArgs a;
  float* dwp[MAX_OUT];
  float* dbp[MAX_OUT];
  float* dwpart[MAX_OUT];
  int split[MAX_OUT];
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  for (int i = 0; i < MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && (f[i] <= 0 || f[i] % BN != 0 || act[i] < ACT_NONE || act[i] > ACT_QUICK_GELU ||
               dw_split[i] <= 0 || g[i] == nullptr || dw[i] == nullptr ||
               dw_part[i] == nullptr || (act[i] != ACT_NONE && gz[i] == nullptr) ||
               (b[i] != nullptr && (db[i] == nullptr || db_part[i] == nullptr))))
      return (int)cudaErrorInvalidValue;
    a.w[i] = on ? static_cast<const float*>(w[i]) : nullptr;
    a.b[i] = on ? static_cast<const float*>(b[i]) : nullptr;
    a.g[i] = on ? g[i] : nullptr;
    a.gz[i] = on ? gz[i] : nullptr;
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
  if (x_bf16) {
    return out_bf16 ? launch<bf16, bf16>(a, ds, dbb, dwp, dbp, dwpart, split, s)
                    : launch<bf16, float>(a, ds, dbb, dwp, dbp, dwpart, split, s);
  }
  return out_bf16 ? launch<float, bf16>(a, ds, dbb, dwp, dbp, dwpart, split, s)
                  : launch<float, float>(a, ds, dbb, dwp, dbp, dwpart, split, s);
}
