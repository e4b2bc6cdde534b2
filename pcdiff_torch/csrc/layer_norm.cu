// Standalone LayerNorm over the last axis, forward (K6a) and backward (K6b), for Hopper
// (sm_90a). x [rows, C] row-major, C % 128 == 0 and C <= 4096; fp32 scale and bias [C].
//
// K6a replaces the TPU kernel pcdiff/ops/layer_norm.py::_ln_fwd_kernel (launched by
// _pallas_layer_norm, reached through fused_layer_norm). It computes
//     y = (x - mean) * (rsqrt(var + eps) * scale) + bias
// with fp32 statistics by the fast-variance formula var = max(0, E[x^2] - E[x]^2), the fp32
// affine, and one cast to the output dtype.
// K6b replaces _ln_bwd_kernel (launched by _pallas_layer_norm_bwd, the backward of
// fused_layer_norm). With xhat = (x - mean) rstd and gs = g scale it forms
//     dx = rstd (gs - mean_c(gs) - xhat mean_c(gs xhat))      (in x's dtype)
//     dscale = sum_rows g xhat,  dbias = sum_rows g          (fp32)
//
// What bounds them on the H100: the bytes. Each element is read once and written once
// (K6a: x, y; K6b: x, g, dx), a handful of fp32 operations apiece; the bound is the bytes
// over 3.35 TB/s.
// What the design does about it:
//   K6a: one warp per row, 8 rows per block of 256 threads; each lane loads 4 consecutive
//        elements at a time (16-byte loads in fp32), sums x and x^2 in one pass, and reads
//        its elements again (from L1) for the affine and the store.
//   K6b: (a) a grid sized to the card (the wrapper's `blocks`: a fixed number a SM, fewer
//        for few rows), block b taking a contiguous range of rows that its 8 warps walk in
//        turn, a warp per row. Where C <= 256 (every site of the port's configurations) the
//        warp reads its row of x and g once into registers (lane l holds columns 4l + 128i,
//        +3) and from them forms the statistics, the two row means and dx; each lane adds
//        g xhat and g into its own columns' dscale and dbias over the warp's rows, and the
//        block's warps add theirs in shared memory in warp order into the block's partial,
//        written to an fp32 [2, blocks, C] scratch. Wider rows take one block per 64 rows that
//        reads x and g again from L1/L2 and walks its rows column by column for the partials.
//        (b) the partials summed over the blocks in a fixed order: a block per 32 outputs,
//        warp w summing blocks w, w + 8, ... and warp 0 the eight warps' sums in order. No
//        atomics, so the result is the same from run to run. The TPU kernel returns per-cell
//        partials too, summed outside it.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BWD_ROWS = 64;  // rows per block of K6b's first pass past REG_C
constexpr int REG_C = 256;    // the widest row K6b's first pass holds in registers
constexpr int MAX_C = 4096;

enum Dtype { F32 = 0, BF16 = 1, F16 = 2 };

// 4 consecutive elements <-> 4 fp32 values (16-byte loads for fp32, 8-byte otherwise)
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const bf16* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&t.x);
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const __half2 a = *reinterpret_cast<const __half2*>(&t.x);
  const __half2 b = *reinterpret_cast<const __half2*>(&t.y);
  v[0] = __low2float(a); v[1] = __high2float(a); v[2] = __low2float(b); v[3] = __high2float(b);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ void store4(__half* p, const float (&v)[4]) {
  uint2 t;
  *reinterpret_cast<__half2*>(&t.x) = __floats2half2_rn(v[0], v[1]);
  *reinterpret_cast<__half2*>(&t.y) = __floats2half2_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// (mean, rstd) of one row, by the fast-variance formula; every lane gets them.
template <typename TX>
__device__ __forceinline__ float2 row_stats(const TX* xr, int C, float eps, int lane) {
  float s = 0.f, s2 = 0.f;
  for (int c = lane * 4; c < C; c += 128) {
    float v[4];
    load4(xr + c, v);
    for (int i = 0; i < 4; ++i) {
      s += v[i];
      s2 += v[i] * v[i];
    }
  }
  s = warp_sum(s);
  s2 = warp_sum(s2);
  const float inv_c = __fdiv_rn(1.f, (float)C);
  const float mean = __fmul_rn(s, inv_c);
  const float var = fmaxf(0.f, __fsub_rn(__fmul_rn(s2, inv_c), __fmul_rn(mean, mean)));
  return make_float2(mean, rsqrtf(__fadd_rn(var, eps)));
}

template <typename TX, typename TY>
__global__ void __launch_bounds__(THREADS)
layer_norm_fwd(const TX* __restrict__ x, const float* __restrict__ scale,
               const float* __restrict__ bias, TY* __restrict__ y, int rows, int C, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= rows) return;
  const TX* xr = x + (size_t)row * C;
  const float2 st = row_stats(xr, C, eps, lane);
  TY* yr = y + (size_t)row * C;
  for (int c = lane * 4; c < C; c += 128) {
    float v[4];
    load4(xr + c, v);
    for (int i = 0; i < 4; ++i) {
      const float mul = __fmul_rn(st.y, scale[c + i]);
      v[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], st.x), mul), bias[c + i]);
    }
    store4(yr + c, v);
  }
}

// K6b pass (a) for C <= REG_C: block b takes rows [b chunk, (b + 1) chunk), chunk =
// ceil(rows / gridDim.x), its warps rows r0 + warp, r0 + warp + 8, ...; a lane holds the row's
// columns 4 lane + 128 i, +3 for i < C / 128 <= NC in registers. part: [2, gridDim.x, C] fp32
// (dscale partials, then dbias partials).
template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS, 2)
layer_norm_bwd_regs(const TX* __restrict__ x, const float* __restrict__ scale,
                    const TG* __restrict__ g, TX* __restrict__ dx, float* __restrict__ part,
                    int rows, int C, float eps) {
  constexpr int NC = REG_C / 128;
  __shared__ __align__(16) float red[WARPS * 2 * REG_C];  // each warp's dscale, dbias
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nc = C / 128;
  const int chunk = (rows + gridDim.x - 1) / gridDim.x;
  const int r0 = blockIdx.x * chunk, r1 = min(rows, r0 + chunk);
  const float inv_c = __fdiv_rn(1.f, (float)C);
  float sc[NC][4], ds[NC][4], db[NC][4];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < nc) load4(scale + 4 * lane + 128 * i, sc[i]);
#pragma unroll
    for (int e = 0; e < 4; ++e) ds[i][e] = db[i][e] = 0.f;
  }
  for (int r = r0 + warp; r < r1; r += WARPS) {
    const size_t off = (size_t)r * C + 4 * lane;
    float xv[NC][4], gv[NC][4];
    float s = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < nc) {
        load4(x + off + 128 * i, xv[i]);
        load4(g + off + 128 * i, gv[i]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s += xv[i][e];
          s2 += xv[i][e] * xv[i][e];
        }
      }
    }
    s = warp_sum(s);
    s2 = warp_sum(s2);
    const float mean = __fmul_rn(s, inv_c);
    const float var = fmaxf(0.f, __fsub_rn(__fmul_rn(s2, inv_c), __fmul_rn(mean, mean)));
    const float rstd = rsqrtf(__fadd_rn(var, eps));
    float m1 = 0.f, m2 = 0.f;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < nc) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xv[i][e] = __fmul_rn(__fsub_rn(xv[i][e], mean), rstd);  // xhat from here on
          const float gs = __fmul_rn(gv[i][e], sc[i][e]);
          m1 += gs;
          m2 += __fmul_rn(gs, xv[i][e]);
        }
      }
    }
    m1 = __fmul_rn(warp_sum(m1), inv_c);
    m2 = __fmul_rn(warp_sum(m2), inv_c);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      if (i < nc) {
        float d[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float gs = __fmul_rn(gv[i][e], sc[i][e]);
          d[e] = __fmul_rn(rstd, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xv[i][e], m2)));
          ds[i][e] += __fmul_rn(gv[i][e], xv[i][e]);
          db[i][e] += gv[i][e];
        }
        store4(dx + off + 128 * i, d);
      }
    }
  }
  // the block's partial: each warp's sums into shared memory, then added in warp order
  float* mine = red + (size_t)warp * 2 * C + 4 * lane;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if (i < nc) {
      store4(mine + 128 * i, ds[i]);
      store4(mine + C + 128 * i, db[i]);
    }
  }
  __syncthreads();
  for (int j = threadIdx.x; j < 2 * C; j += THREADS) {
    float v = red[j];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[(size_t)w * 2 * C + j];
    const int which = j / C;
    part[((size_t)which * gridDim.x + blockIdx.x) * C + (j - which * C)] = v;
  }
}

// K6b pass (a) past REG_C: one block per BWD_ROWS rows. part: [2, blocks, C] fp32.
template <typename TX, typename TG>
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_rows(const TX* __restrict__ x, const float* __restrict__ scale,
                    const TG* __restrict__ g, TX* __restrict__ dx, float* __restrict__ part,
                    int rows, int C, float eps) {
  __shared__ float2 stats[BWD_ROWS];
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = blockIdx.x * BWD_ROWS;
  const int n = min(BWD_ROWS, rows - r0);
  const float inv_c = __fdiv_rn(1.f, (float)C);
  for (int r = warp; r < n; r += WARPS) {
    const size_t off = (size_t)(r0 + r) * C;
    const float2 st = row_stats(x + off, C, eps, lane);
    if (lane == 0) stats[r] = st;
    float m1 = 0.f, m2 = 0.f;
    for (int c = lane * 4; c < C; c += 128) {
      float xv[4], gv[4];
      load4(x + off + c, xv);
      load4(g + off + c, gv);
      for (int i = 0; i < 4; ++i) {
        const float gs = __fmul_rn(gv[i], scale[c + i]);
        m1 += gs;
        m2 += __fmul_rn(gs, __fmul_rn(__fsub_rn(xv[i], st.x), st.y));
      }
    }
    m1 = __fmul_rn(warp_sum(m1), inv_c);
    m2 = __fmul_rn(warp_sum(m2), inv_c);
    for (int c = lane * 4; c < C; c += 128) {
      float xv[4], gv[4];
      load4(x + off + c, xv);
      load4(g + off + c, gv);
      for (int i = 0; i < 4; ++i) {
        const float xhat = __fmul_rn(__fsub_rn(xv[i], st.x), st.y);
        const float gs = __fmul_rn(gv[i], scale[c + i]);
        xv[i] = __fmul_rn(st.y, __fsub_rn(__fsub_rn(gs, m1), __fmul_rn(xhat, m2)));
      }
      store4(dx + off + c, xv);
    }
  }
  __syncthreads();
  float* ds_part = part + (size_t)blockIdx.x * C;
  float* db_part = part + ((size_t)gridDim.x + blockIdx.x) * C;
  for (int c = tid; c < C; c += THREADS) {
    float ds = 0.f, db = 0.f;
    for (int r = 0; r < n; ++r) {
      const size_t off = (size_t)(r0 + r) * C + c;
      const float gv = to_f32(g[off]);
      ds += __fmul_rn(gv, __fmul_rn(__fsub_rn(to_f32(x[off]), stats[r].x), stats[r].y));
      db += gv;
    }
    ds_part[c] = ds;
    db_part[c] = db;
  }
}

// K6b pass (b): out[j] = sum over k of part[k][j] in the order of k, j < 2 C (dscale, then
// dbias): a block per 32 consecutive j, warp w summing k = w, w + 8, ... in order, then the
// eight warps' sums added in warp order.
__global__ void __launch_bounds__(THREADS)
layer_norm_bwd_sum(const float* __restrict__ part, int blocks, int C, float* __restrict__ dscale,
                   float* __restrict__ dbias) {
  __shared__ float wsum[WARPS][32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j = blockIdx.x * 32 + lane;
  const bool ok = j < 2 * C;
  const int which = ok ? j / C : 0, c = ok ? j - which * C : 0;
  const float* p = part + (size_t)which * blocks * C + c;
  float s = 0.f;
  if (ok) {
#pragma unroll 4
    for (int k = warp; k < blocks; k += WARPS) s += p[(size_t)k * C];
  }
  wsum[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && ok) {
    float t = wsum[0][lane];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) t += wsum[w][lane];
    (which ? dbias : dscale)[c] = t;
  }
}

template <typename TX, typename TY>
int launch_fwd(const void* x, const void* scale, const void* bias, void* y, int rows, int c,
               float eps, cudaStream_t s) {
  layer_norm_fwd<TX, TY><<<(rows + WARPS - 1) / WARPS, THREADS, 0, s>>>(
      static_cast<const TX*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<TY*>(y), rows, c, eps);
  return (int)cudaGetLastError();
}

template <typename TX>
int fwd_out(int y_dtype, const void* x, const void* scale, const void* bias, void* y,
            int rows, int c, float eps, cudaStream_t s) {
  switch (y_dtype) {
    case F32: return launch_fwd<TX, float>(x, scale, bias, y, rows, c, eps, s);
    case BF16: return launch_fwd<TX, bf16>(x, scale, bias, y, rows, c, eps, s);
    case F16: return launch_fwd<TX, __half>(x, scale, bias, y, rows, c, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename TX, typename TG>
int launch_bwd(const void* x_, const void* scale_, const void* g_, void* dx_, void* dscale,
               void* dbias, void* part_, int blocks, int rows, int c, float eps,
               cudaStream_t s) {
  const TX* x = static_cast<const TX*>(x_);
  const float* scale = static_cast<const float*>(scale_);
  const TG* g = static_cast<const TG*>(g_);
  TX* dx = static_cast<TX*>(dx_);
  float* part = static_cast<float*>(part_);
  if (c <= REG_C) {
    layer_norm_bwd_regs<TX, TG><<<blocks, THREADS, 0, s>>>(x, scale, g, dx, part, rows, c, eps);
  } else {
    if (blocks != (rows + BWD_ROWS - 1) / BWD_ROWS) return (int)cudaErrorInvalidValue;
    layer_norm_bwd_rows<TX, TG><<<blocks, THREADS, 0, s>>>(x, scale, g, dx, part, rows, c, eps);
  }
  const int err = (int)cudaGetLastError();
  if (err) return err;
  layer_norm_bwd_sum<<<(2 * c + 31) / 32, THREADS, 0, s>>>(
      part, blocks, c, static_cast<float*>(dscale), static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}

template <typename TX>
int bwd_grad(int g_dtype, const void* x, const void* scale, const void* g, void* dx,
             void* dscale, void* dbias, void* part, int blocks, int rows, int c, float eps,
             cudaStream_t s) {
  switch (g_dtype) {
    case F32:
      return launch_bwd<TX, float>(x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps, s);
    case BF16:
      return launch_bwd<TX, bf16>(x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps, s);
    case F16:
      return launch_bwd<TX, __half>(x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

bool bad_shape(int rows, int c) { return rows <= 0 || c <= 0 || c > MAX_C || c % 128 != 0; }

}  // namespace

// x, scale, bias, y: device pointers (scale and bias fp32 [c]). x_dtype / y_dtype: 0 fp32,
// 1 bf16, 2 fp16. Requires rows > 0, 0 < c <= 4096, c % 128 == 0. Returns the cudaError_t of
// the launch (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_layer_norm_fwd(const void* x, const void* scale, const void* bias, void* y,
                                     int rows, int c, float eps, int x_dtype, int y_dtype,
                                     void* stream) {
  if (bad_shape(rows, c)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case F32: return fwd_out<float>(y_dtype, x, scale, bias, y, rows, c, eps, s);
    case BF16: return fwd_out<bf16>(y_dtype, x, scale, bias, y, rows, c, eps, s);
    case F16: return fwd_out<__half>(y_dtype, x, scale, bias, y, rows, c, eps, s);
  }
  return (int)cudaErrorInvalidValue;
}

// x, scale, g, dx (x's dtype), dscale, dbias (fp32 [c]), part (fp32 scratch of 2 blocks c
// elements): device pointers. blocks: pass (a)'s grid, at least 1 (the wrapper sizes it to the
// card); past c = 256 it must be ceil(rows / 64). x_dtype / g_dtype as above. Same shape
// requirements as the forward. Returns the cudaError_t of the launches (0 on success);
// launches on `stream`, no sync.
extern "C" int pcdiff_layer_norm_bwd(const void* x, const void* scale, const void* g, void* dx,
                                     void* dscale, void* dbias, void* part, int blocks, int rows,
                                     int c, float eps, int x_dtype, int g_dtype, void* stream) {
  if (bad_shape(rows, c) || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case F32:
      return bwd_grad<float>(g_dtype, x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps,
                             s);
    case BF16:
      return bwd_grad<bf16>(g_dtype, x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps, s);
    case F16:
      return bwd_grad<__half>(g_dtype, x, scale, g, dx, dscale, dbias, part, blocks, rows, c, eps,
                              s);
  }
  return (int)cudaErrorInvalidValue;
}
