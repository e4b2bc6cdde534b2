// Fused LayerNorm -> 1 to 3 projections with a bias + activation epilogue, forward, for
// Hopper (sm_90a). x [rows, C] row-major; for each output i, W_i [F_i, C] (the nn.Linear
// layout, fp32), an optional fp32 bias [F_i], and out_i [rows, F_i].
//
// Replaces the TPU kernel pcdiff/ops/ln_dense.py::_ln_denses_kernel (launched by
// _pallas_ln_denses, reached through fused_ln_denses). It computes
//     out_i = act_i(LN(x) W_i^T + b_i)
// with fp32 LayerNorm statistics by the fast-variance formula max(0, E[x^2] - E[x]^2) and
// the fp32 affine, the normalised rows cast to the product dtype (bf16 when the output is
// bf16, fp32 when it is fp32), fp32 accumulation, bias and activation applied to the fp32
// accumulator, and one cast out. The activations are those of _apply_act with the _erf_f32
// rational: none, gelu (exact-erf form through the rational, clamped to [-4, 4]), gelu_tanh
// and quick_gelu (sigmoid forms with the exp argument clamped to +-30). The epilogue uses
// round-to-nearest intrinsics so that no multiply-add is contracted, which keeps it
// op-for-op equal to the plain PyTorch version.
//
// What bounds it on the H100: at C = 256 the products are short (256 deep), and at
// 1024 outputs per row (fc1) the weight panel is larger than the row tile, so the work is
// the tensor-core product plus staging W through shared memory; the normalised tensor is
// the traffic this kernel exists to remove (it never reaches device memory).
// What the design does about it: one block of 256 threads per tile of 64 rows. The block
// normalises its rows once (a warp per row) into shared memory (64 x C, above the 48 KB
// static limit for fp32, hence dynamic shared memory), then walks the column tiles of every
// output: a 64 x C tile of W is staged in shared memory, cast to the product dtype, and the
// 64 x 64 output tile is formed with WMMA bf16 tensor-core products (bf16 path) or with
// fp32 FMAs, 4 x 4 per thread (fp32 path), followed by the epilogue and a coalesced store.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <type_traits>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;        // rows per block
constexpr int BN = 64;        // output columns per tile
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int LD_E = BN + 4;  // fp32 epilogue pitch (bf16 path)
constexpr int MAX_OUT = 3;
constexpr int MAX_C = 256;

enum Act { ACT_NONE = 0, ACT_GELU = 1, ACT_GELU_TANH = 2, ACT_QUICK_GELU = 3 };

struct LnDenseArgs {
  const void* x;
  const float* ln_scale;
  const float* ln_bias;
  const float* w[MAX_OUT];
  const float* b[MAX_OUT];
  void* out[MAX_OUT];
  int f[MAX_OUT];
  int act[MAX_OUT];
  int n_out;
  int rows;
  int c;
  float eps;
};

// bf16 outputs take the tensor-core path; fp32 outputs the fp32 FMA path.
template <typename TO>
struct UseMma {
  static constexpr bool value = std::is_same<TO, bf16>::value;
};

template <typename TO>
__host__ __device__ constexpr int row_pitch(int c) { return UseMma<TO>::value ? c + 8 : c + 1; }

template <typename TO>
size_t smem_bytes(int c) {
  const size_t panels = 2 * (size_t)BM * row_pitch<TO>(c) * sizeof(TO);
  return UseMma<TO>::value ? panels + (size_t)BM * LD_E * sizeof(float) : panels;
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

__device__ __forceinline__ float apply_act(float v, int act) {
  switch (act) {
    case ACT_GELU:
      return __fmul_rn(__fmul_rn(v, 0.5f),
                       __fadd_rn(1.f, erf_f32(__fmul_rn(v, 0.70710678118654752f))));
    case ACT_GELU_TANH: {
      const float cube = __fmul_rn(__fmul_rn(__fmul_rn(0.044715f, v), v), v);
      const float u2 = __fmul_rn(1.5957691216057308f, __fadd_rn(v, cube));
      return __fdiv_rn(v, __fadd_rn(1.f, expf(clamp30(-u2))));
    }
    case ACT_QUICK_GELU:
      return __fdiv_rn(v, __fadd_rn(1.f, expf(clamp30(__fmul_rn(-1.702f, v)))));
    default:
      return v;
  }
}

template <typename TX, typename TO>
__global__ void __launch_bounds__(THREADS) ln_denses_kernel(const LnDenseArgs a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int C = a.c;
  const int ldy = row_pitch<TO>(C);
  TO* sy = reinterpret_cast<TO*>(smem);        // normalised rows, product dtype
  TO* sw = sy + BM * ldy;                       // one 64-column tile of W, product dtype
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int r0 = blockIdx.x * BM;
  const TX* x = static_cast<const TX*>(a.x);

  for (int r = warp; r < BM; r += WARPS) {
    const int row = r0 + r;
    TO* yr = sy + r * ldy;
    if (row >= a.rows) {
      for (int c = lane; c < C; c += 32) yr[c] = from_f32<TO>(0.f);
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
    for (int c = lane; c < C; c += 32) {
      const float y = __fmul_rn(__fsub_rn(to_f32(xr[c]), mean), rstd);
      yr[c] = from_f32<TO>(__fadd_rn(__fmul_rn(y, a.ln_scale[c]), a.ln_bias[c]));
    }
  }
  __syncthreads();

  for (int o = 0; o < a.n_out; ++o) {
    const int F = a.f[o];
    const float* __restrict__ w = a.w[o];
    const float* __restrict__ bias = a.b[o];
    const int act = a.act[o];
    TO* __restrict__ out = static_cast<TO*>(a.out[o]);
    for (int f0 = 0; f0 < F; f0 += BN) {
      for (int i = tid; i < BN * C; i += THREADS) {
        const int n = i / C, c = i - n * C;
        sw[n * ldy + c] = from_f32<TO>(w[(size_t)(f0 + n) * C + c]);
      }
      __syncthreads();
      if constexpr (UseMma<TO>::value) {
        float* se = reinterpret_cast<float*>(sw + BN * ldy);
        const int wm = warp / 2;        // 16-row slab of the tile
        const int wn = (warp % 2) * 2;  // first of this warp's two 16-column fragments
        wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
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
        for (int i = tid; i < BM * BN; i += THREADS) {
          const int r = i / BN, c = i - r * BN;
          const int row = r0 + r;
          if (row < a.rows) {
            float v = se[r * LD_E + c];
            if (bias != nullptr) v = __fadd_rn(v, bias[f0 + c]);
            out[(size_t)row * F + f0 + c] = from_f32<TO>(apply_act(v, act));
          }
        }
      } else {
        // thread (ty, tx) owns rows ty + 16 i and columns tx + 16 j of the tile
        const int tx = tid % 16, ty = tid / 16;
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
        for (int i = 0; i < 4; ++i) {
          const int row = r0 + ty + 16 * i;
          if (row >= a.rows) continue;
          for (int j = 0; j < 4; ++j) {
            const int col = f0 + tx + 16 * j;
            float v = acc[i][j];
            if (bias != nullptr) v = __fadd_rn(v, bias[col]);
            out[(size_t)row * F + col] = from_f32<TO>(apply_act(v, act));
          }
        }
      }
      __syncthreads();  // sw (and the epilogue buffer) are rewritten by the next tile
    }
  }
}

template <typename TX, typename TO>
int launch(const LnDenseArgs& a, cudaStream_t stream) {
  static size_t configured = 0;  // dynamic shared memory this instantiation may use
  const size_t smem = smem_bytes<TO>(a.c);
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_denses_kernel<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  ln_denses_kernel<TX, TO><<<(a.rows + BM - 1) / BM, THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// x, ln_scale, ln_bias: device pointers (ln params fp32). w, b, out, f, act: HOST arrays of
// n_out entries (b[i] may be null). Requires 0 < c <= 256, c % 32 == 0, every f[i] % 64 == 0.
// x_bf16 / out_bf16 select the input and output dtypes (the product dtype is the output's).
// Returns the cudaError_t of the launch (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_ln_denses_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                    int n_out, const void* const* w, const void* const* b,
                                    void* const* out, const int* f, const int* act, int rows,
                                    int c, float eps, int x_bf16, int out_bf16, void* stream) {
  if (n_out < 1 || n_out > MAX_OUT || rows <= 0 || c <= 0 || c > MAX_C || c % 32 != 0)
    return (int)cudaErrorInvalidValue;
  LnDenseArgs a;
  a.x = x;
  a.ln_scale = static_cast<const float*>(ln_scale);
  a.ln_bias = static_cast<const float*>(ln_bias);
  for (int i = 0; i < MAX_OUT; ++i) {
    const bool on = i < n_out;
    if (on && (f[i] <= 0 || f[i] % BN != 0 || act[i] < ACT_NONE || act[i] > ACT_QUICK_GELU))
      return (int)cudaErrorInvalidValue;
    a.w[i] = on ? static_cast<const float*>(w[i]) : nullptr;
    a.b[i] = on ? static_cast<const float*>(b[i]) : nullptr;
    a.out[i] = on ? out[i] : nullptr;
    a.f[i] = on ? f[i] : 0;
    a.act[i] = on ? act[i] : ACT_NONE;
  }
  a.n_out = n_out;
  a.rows = rows;
  a.c = c;
  a.eps = eps;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return out_bf16 ? launch<bf16, bf16>(a, s) : launch<bf16, float>(a, s);
  }
  return out_bf16 ? launch<float, bf16>(a, s) : launch<float, float>(a, s);
}
