// The multi-head attention kernel cut off after one stage, for Hopper (sm_90a): a profiling
// ladder. q [B, Nq, H*D], k and v [B, Nk, H*D], o [B, Nq, H*D], bf16, row-major, D = 32.
//
// Replaces the TPU kernel scripts/attn_profile.py::_ladder_kernel (launched by its
// _make_pallas), the stage-by-stage ablation of pcdiff/ops/flash_attention.py::_mh_kernel.
// Each rung runs the loop of attention_mh.cu (the port's kernel for _mh_kernel) with its
// tiles, warps and shared-memory staging, up to one stage, and writes what the TPU rung
// writes into each head's D columns:
//     qk      the first D key columns of S = Q K^T
//     qk_max  rowmax(S), broadcast
//     qk_exp  exp(S[:, :D] - rowmax(S)): the first tile's panel exp(S - m0), kept in
//             registers and scaled by exp(m0 - m_final) at the end
//     qk_sum  rowsum(exp(S - rowmax(S))), broadcast
//     nomax   (exp(S) V) / rowsum(exp(S)): the full kernel without the max and the rescales
// The full kernel itself is attention_mh.cu. Every rung stages K and V, stores every S tile
// to shared memory as the full kernel does (so no product is dead code), and rounds the
// exponentials to bf16 into shared memory from qk_exp on; the time between two rungs is
// the cost of the stage that the later one adds.
//
// What bounds it on the H100, per rung: the products on the tensor cores, the exponentials
// on the SFUs (16 a clock per SM), the other softmax operations on the fp32 lanes, or q, k,
// v and o once through device memory (pcdiff_torch/scripts/attn_profile.py prints each).
// Its design is the full kernel's, on purpose: it is a measuring instrument for that kernel.

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
constexpr int LD_QKV = D + 8;     // bf16
constexpr int LD_S = BK + 4;      // fp32 scores
constexpr int LD_P = BK + 8;      // bf16 exponentials
constexpr int LD_O = D + 4;       // fp32 output accumulator

constexpr int S_BYTES = WARPS * 16 * LD_S * 4;   // also stages the Q tile before the loop
constexpr int KV_BYTES = BK * LD_QKV * 2;
constexpr int P_BYTES = WARPS * 16 * LD_P * 2;
constexpr int O_BYTES = WARPS * 16 * LD_O * 4;
constexpr int SMEM_BYTES = S_BYTES + 2 * KV_BYTES + P_BYTES + O_BYTES;
static_assert(BQ * LD_QKV * 2 <= S_BYTES, "Q staging must fit in the score buffer");
static_assert(SMEM_BYTES <= 48 * 1024, "static shared memory limit");
static_assert(BK / 2 == D, "lane half 0 of a row's pair holds its first D key columns");

enum Rung { QK = 0, QK_MAX = 1, QK_EXP = 2, QK_SUM = 3, NOMAX = 4 };

template <int RUNG>
__global__ void __launch_bounds__(THREADS)
attention_ladder_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
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
  const bf16* qb = q + (size_t)b * nq * hd + h * D;
  const bf16* kb = k + (size_t)b * nk * hd + h * D;
  const bf16* vb = v + (size_t)b * nk * hd + h * D;
  const bf16 zero = __float2bfloat16(0.f);

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int row = q0 + r;
    sq[r * LD_QKV + c] = row < nq ? qb[(size_t)row * hd + c] : zero;
  }
  float* so = o_all + warp * 16 * LD_O;
  for (int i = lane; i < 16 * LD_O; i += 32) so[i] = 0.f;
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qa[D / 16];
  for (int kk = 0; kk < D / 16; ++kk)
    wmma::load_matrix_sync(qa[kk], sq + warp * 16 * LD_QKV + kk * 16, LD_QKV);

  float* ss = s_all + warp * 16 * LD_S;
  bf16* sp = p_all + warp * 16 * LD_P;
  const int r_own = lane / 2;
  const int half = lane % 2;
  float m_run = -INFINITY;
  float l_run = 0.f;
  float m_first = 0.f;
  float first[D];  // lane half 0: the first tile's S (qk) or exp(S - m0) (qk_exp) panel

  for (int k0 = 0; k0 < nk; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile (and with sq)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int row = k0 + r;
      const bool ok = row < nk;
      sk[r * LD_QKV + c] = ok ? kb[(size_t)row * hd + c] : zero;
      sv[r * LD_QKV + c] = ok ? vb[(size_t)row * hd + c] : zero;
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
    if constexpr (RUNG == QK) {
      if (k0 == 0) {
#pragma unroll
        for (int c = 0; c < D; ++c) first[c] = srow[c];
      }
      continue;
    }
    float m_new = 0.f;
    if constexpr (RUNG != NOMAX) {
      float tmax = -INFINITY;
      for (int c = 0; c < BK / 2; ++c)
        if (cbase + c < nk) tmax = fmaxf(tmax, srow[c]);
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      m_new = fmaxf(m_run, tmax);
    }
    if constexpr (RUNG == QK_MAX) {
      m_run = m_new;
      continue;
    }
    float psum = 0.f;
    bf16* prow = sp + r_own * LD_P + half * (BK / 2);
#pragma unroll
    for (int c = 0; c < BK / 2; ++c) {
      const float p = cbase + c < nk ? expf(srow[c] - m_new) : 0.f;
      psum += p;
      prow[c] = __float2bfloat16(p);
      if (RUNG == QK_EXP && k0 == 0 && c < D) first[c] = p;
    }
    if constexpr (RUNG == QK_EXP) {
      if (k0 == 0) m_first = m_new;
      m_run = m_new;
      continue;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    if constexpr (RUNG == QK_SUM) {
      l_run = l_run * expf(m_run - m_new) + psum;
      m_run = m_new;
      continue;
    }
    // NOMAX: exp(S) with no max, so no rescaling of the sum or the accumulator
    l_run += psum;
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
  if (row >= nq) return;
  bf16* dst = o + ((size_t)b * nq + row) * hd + h * D;
  if constexpr (RUNG == QK || RUNG == QK_EXP) {
    if (half == 0) {
      const float scale = RUNG == QK_EXP ? expf(m_first - m_run) : 1.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dst[c] = __float2bfloat16(first[c] * scale);
    }
  } else {
    float val[D / 2];
    if constexpr (RUNG == NOMAX) {
      const float recip = 1.f / l_run;
      const float* orow = so + r_own * LD_O + half * (D / 2);
      for (int c = 0; c < D / 2; ++c) val[c] = orow[c] * recip;
    } else {
      for (int c = 0; c < D / 2; ++c) val[c] = RUNG == QK_MAX ? m_run : l_run;
    }
    for (int c = 0; c < D / 2; ++c) dst[half * (D / 2) + c] = __float2bfloat16(val[c]);
  }
}

template <int RUNG>
int launch(const bf16* q, const bf16* k, const bf16* v, bf16* o, int batch, int nq, int nk,
           int heads, cudaStream_t s) {
  const dim3 grid((nq + BQ - 1) / BQ, heads, batch);
  attention_ladder_kernel<RUNG><<<grid, THREADS, 0, s>>>(q, k, v, o, nq, nk, heads);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o: bf16 device pointers. rung: 0 qk, 1 qk_max, 2 qk_exp, 3 qk_sum, 4 nomax.
// Requires nk >= head_dim (qk and qk_exp write the first D key columns). Returns the
// cudaError_t of the launch (0 on success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_ladder(const void* q, const void* k, const void* v, void* o,
                                       int batch, int nq, int nk, int heads, int head_dim,
                                       int rung, void* stream) {
  if (head_dim != D || batch <= 0 || nq <= 0 || nk < D || heads <= 0 || batch > 65535 ||
      heads > 65535)
    return (int)cudaErrorInvalidValue;
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rung) {
    case QK: return launch<QK>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case QK_MAX: return launch<QK_MAX>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case QK_EXP: return launch<QK_EXP>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case QK_SUM: return launch<QK_SUM>(qp, kp, vp, op, batch, nq, nk, heads, s);
    case NOMAX: return launch<NOMAX>(qp, kp, vp, op, batch, nq, nk, heads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
