// Fused multi-head attention, forward, for Hopper (sm_90a). Heads are folded in the feature
// axis: q [B, Nq, H*D], k and v [B, Nk, H*D], o [B, Nq, H*D], all row-major.
//
// Replaces the TPU kernel pcdiff/ops/flash_attention.py::_mh_kernel (launched by
// _pallas_attention_mh, reached through fused_attention_mh). For every batch row b and
// head h it computes
//     o[b, :, hD:(h+1)D] = (P V_h) * (1 / rowsum(P)),  P = exp(S - rowmax(S)),  S = Q_h K_h^T
// with q already scaled by 1/sqrt(D), in the TPU kernel's numerics class: q, k and v are
// rounded to bf16 (fp32 inputs too), both products accumulate in fp32, the softmax runs in
// fp32, the unnormalised P is rounded to bf16 for the PV product, and the division by the
// fp32 row sum comes after PV.
//
// What bounds it on the H100: at D = 32 both products are thin (32 deep for Q K^T, 32 wide
// for P V), so for every tile of keys the softmax work (max, exp, sum over a 16 x 64 panel
// per warp) costs about as much as the tensor-core work. Device memory is not the limit:
// each block reads its query tile once and the K/V panel of its (row, head), which the
// other query tiles of that (row, head) read again from L2.
// What the design does about it: one block per (tile of 64 queries, head, batch row), four
// warps of 16 query rows each. K/V tiles of 64 keys are staged in shared memory as bf16;
// an online softmax keeps the running max and sum in registers and the output accumulator
// in shared memory, so the score panel never reaches device memory; the products run on
// the tensor cores through WMMA (bf16 in, fp32 accumulate). The TPU kernel's design of one
// whole K/V panel per batch row, sized for 128 MB of VMEM, is not carried over. Ragged
// edges (643, 1025, 257, 255, 127 are multiples of no tile) are masked here: query rows past
// Nq are computed on zeros and not stored; keys past Nk are zero-filled and excluded from
// the max and the sum.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 32;             // head dim
constexpr int BQ = 64;            // queries per block
constexpr int BK = 64;            // keys per K/V tile
constexpr int WARPS = BQ / 16;    // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
// Row pitches, padded against bank conflicts; 16-row and 16-column offsets stay 32-byte
// aligned as WMMA requires.
constexpr int LD_QKV = D + 8;     // bf16
constexpr int LD_S = BK + 4;      // fp32 scores
constexpr int LD_P = BK + 8;      // bf16 probabilities
constexpr int LD_O = D + 4;       // fp32 output accumulator

constexpr int S_BYTES = WARPS * 16 * LD_S * 4;   // also stages the Q tile before the loop
constexpr int KV_BYTES = BK * LD_QKV * 2;
constexpr int P_BYTES = WARPS * 16 * LD_P * 2;
constexpr int O_BYTES = WARPS * 16 * LD_O * 4;
constexpr int SMEM_BYTES = S_BYTES + 2 * KV_BYTES + P_BYTES + O_BYTES;
static_assert(BQ * LD_QKV * 2 <= S_BYTES, "Q staging must fit in the score buffer");
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");

__device__ __forceinline__ bf16 to_bf16(float v) { return __float2bfloat16(v); }
__device__ __forceinline__ bf16 to_bf16(bf16 v) { return v; }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16(v); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
attention_mh_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, T* __restrict__ o,
                    int nq, int nk, int heads) {
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  float* s_all = reinterpret_cast<float*>(smem);
  bf16* sq = reinterpret_cast<bf16*>(smem);  // aliases s_all until the fragments are loaded
  bf16* sk = reinterpret_cast<bf16*>(smem + S_BYTES);
  bf16* sv = reinterpret_cast<bf16*>(smem + S_BYTES + KV_BYTES);
  bf16* p_all = reinterpret_cast<bf16*>(smem + S_BYTES + 2 * KV_BYTES);
  float* o_all = reinterpret_cast<float*>(smem + S_BYTES + 2 * KV_BYTES + P_BYTES);

  const int hd = heads * D;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const T* qb = q + (size_t)b * nq * hd + h * D;
  const T* kb = k + (size_t)b * nk * hd + h * D;
  const T* vb = v + (size_t)b * nk * hd + h * D;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sq[r * LD_QKV + c] = row < nq ? to_bf16(qb[(size_t)row * hd + c]) : zero;
  }
  float* so = o_all + warp * 16 * LD_O;
  for (int i = lane; i < 16 * LD_O; i += 32) so[i] = 0.f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sq + warp * 16 * LD_QKV + kk * 16, LD_QKV);

  float* ss = s_all + warp * 16 * LD_S;
  bf16* sp = p_all + warp * 16 * LD_P;
  // The lane pair (2r, 2r + 1) owns row r of the warp's 16: each lane holds half its columns
  // and both lanes hold the row's running max and sum.
  const int r_own = lane / 2;
  const int half = lane % 2;
  float m_run = -INFINITY;
  float l_run = 0.f;

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile (and with sq)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool ok = row < nk;
      sk[r * LD_QKV + c] = ok ? to_bf16(kb[(size_t)row * hd + c]) : zero;
      sv[r * LD_QKV + c] = ok ? to_bf16(vb[(size_t)row * hd + c]) : zero;
    }
    __syncthreads();

    for (int n = 0; n < BK / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sk + n * 16 * LD_QKV + kk * 16, LD_QKV);
        wmma::mma_sync(acc, qa[kk], kf, acc);
      }
      wmma::store_matrix_sync(ss + n * 16, acc, LD_S, wmma::mem_row_major);
    }
    __syncwarp();

    const float* srow = ss + r_own * LD_S + half * (BK / 2);
    const int cbase = k0 + half * (BK / 2);
    float tmax = -INFINITY;
    for (int c = 0; c < BK / 2; ++c)
      if (cbase + c < nk) tmax = fmaxf(tmax, srow[c]);
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    const float m_new = fmaxf(m_run, tmax);  // finite: every tile holds at least one key
    const float alpha = expf(m_run - m_new);  // 0 on the first tile
    float psum = 0.f;
    bf16* prow = sp + r_own * LD_P + half * (BK / 2);
    for (int c = 0; c < BK / 2; ++c) {
      const float p = cbase + c < nk ? expf(srow[c] - m_new) : 0.f;
      psum += p;
      prow[c] = __float2bfloat16(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l_run = l_run * alpha + psum;
    m_run = m_new;
    float* orow = so + r_own * LD_O + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) orow[c] *= alpha;
    __syncwarp();

    for (int n = 0; n < D / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, so + n * 16, LD_O, wmma::mem_row_major);
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, sp + kk * 16, LD_P);
        wmma::load_matrix_sync(vf, sv + kk * 16 * LD_QKV + n * 16, LD_QKV);
        wmma::mma_sync(acc, pf, vf, acc);
      }
      wmma::store_matrix_sync(so + n * 16, acc, LD_O, wmma::mem_row_major);
    }
    __syncwarp();
  }

  const int row = q0 + warp * 16 + r_own;
  if (row < nq) {
    const float recip = 1.f / l_run;
    const float* orow = so + r_own * LD_O + half * (D / 2);
    T* dst = o + ((size_t)b * nq + row) * hd + h * D + half * (D / 2);
    for (int c = 0; c < D / 2; ++c) store_out(dst + c, orow[c] * recip);
  }
}

}  // namespace

// q, k, v, o: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_mh_fwd(const void* q, const void* k, const void* v, void* o,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       int is_bf16, void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 ||
      batch > 65535 || heads > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    attention_mh_kernel<bf16><<<grid, THREADS, 0, s>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(o), nq, nk, heads);
  } else {
    attention_mh_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), nq, nk, heads);
  }
  return (int)cudaGetLastError();
}
