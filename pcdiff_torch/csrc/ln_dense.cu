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

#include <cstdint>

#include "ln_dense_fwd.cuh"

namespace {

using pcdiff_ln::Args;
using pcdiff_ln::bf16;
using pcdiff_ln::Path;

template <typename TX, typename TO>
__global__ void __launch_bounds__(pcdiff_ln::THREADS, Path<TO>::MIN_BLOCKS)
ln_denses_kernel(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  pcdiff_ln::ln_dense_block<TX, TO>(a, smem);
}

// Lets this instantiation use `smem` bytes of dynamic shared memory (once per size).
template <typename TX, typename TO>
int configure(size_t smem) {
  static size_t configured = 0;  // dynamic shared memory this instantiation may use
  if (smem > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        ln_denses_kernel<TX, TO>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    configured = smem;
  }
  return 0;
}

int row_tiles(int rows) { return (rows - 1) / pcdiff_ln::BM + 1; }

template <typename TX, typename TO>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = pcdiff_ln::smem_bytes<TO>(a.c);
  if (const int e = configure<TX, TO>(smem)) return e;
  const unsigned blocks = (unsigned)row_tiles(a.rows) * (unsigned)a.groups;
  ln_denses_kernel<TX, TO><<<blocks, pcdiff_ln::THREADS, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename TX, typename TO>
int occupancy(int c, int* blocks_per_sm) {
  const size_t smem = pcdiff_ln::smem_bytes<TO>(c);
  if (const int e = configure<TX, TO>(smem)) return e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, ln_denses_kernel<TX, TO>, pcdiff_ln::THREADS, smem);
}

bool aligned16(const void* p) { return reinterpret_cast<std::uintptr_t>(p) % 16 == 0; }

}  // namespace

// x, ln_scale, ln_bias: device pointers (ln params fp32). w, b, out, f, act: HOST arrays of
// n_out entries (b[i] may be null); w[i] is bf16 when out_bf16, fp32 otherwise. Requires
// 0 < c <= 256, c % 32 == 0, every f[i] % 64 == 0, 1 <= groups <= the outputs' column tiles
// (128 columns each), and 16-byte aligned pointers. x_bf16 /
// out_bf16 select the input and output dtypes (the product dtype is the output's). Returns
// the cudaError_t of the launch (0 on success); launches on `stream`, no sync.
extern "C" int pcdiff_ln_denses_fwd(const void* x, const void* ln_scale, const void* ln_bias,
                                    int n_out, const void* const* w, const void* const* b,
                                    void* const* out, const int* f, const int* act, int rows,
                                    int c, float eps, int x_bf16, int out_bf16, int groups,
                                    void* stream) {
  if (n_out < 1 || n_out > pcdiff_ln::MAX_OUT || rows <= 0 || c <= 0 ||
      c > pcdiff_ln::MAX_C || c % 32 != 0)
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
// 256, c % 32 == 0), for the wrapper's choice of column groups: rows a block, output columns
// a tile, and how many blocks an SM of the current device holds at once at the launch's
// shared memory (the occupancy API). Returns the cudaError_t (0 on success).
extern "C" int pcdiff_ln_denses_tiling(int x_bf16, int out_bf16, int c, int* bm, int* bn,
                                       int* blocks_per_sm) {
  if (c <= 0 || c > pcdiff_ln::MAX_C || c % 32 != 0) return (int)cudaErrorInvalidValue;
  *bm = pcdiff_ln::BM;
  *bn = out_bf16 ? Path<bf16>::BN : Path<float>::BN;
  if (x_bf16)
    return out_bf16 ? occupancy<bf16, bf16>(c, blocks_per_sm)
                    : occupancy<bf16, float>(c, blocks_per_sm);
  return out_bf16 ? occupancy<float, bf16>(c, blocks_per_sm)
                  : occupancy<float, float>(c, blocks_per_sm);
}
