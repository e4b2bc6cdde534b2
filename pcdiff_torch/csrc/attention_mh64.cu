// Fused multi-head attention at head dim 64, forward, for Hopper (sm_90a): K1 on the Point-E
// family's path (Point-E's 512 / 8 heads, the SDF model's 256 / 4, ViT-L/14's 1024 / 16).
// Heads are folded in the feature axis: q [B, Nq, H*64], k and v [B, Nk, H*64], o [B, Nq,
// H*64], row-major.
//
// Replaces the TPU kernel pcdiff/ops/flash_attention.py::_mh_kernel at head dim 64 (launched
// by _pallas_attention_mh, reached through fused_attention_mh), in its numerics class, as
// attention_mh.cu does at head dim 32: q (pre-scaled by 1/sqrt(D)), k and v rounded to bf16
// (fp32 inputs too), both products accumulated in fp32, the softmax in fp32 with an online
// row max (exp2 of log2e-scaled scores, one fused multiply-add each), the unnormalised P
// rounded to bf16 for PV, and O times 1 / (the fp32 row sum) after PV. Under the bf16 exp
// switch (the EXP instantiation, a template parameter: ptxas serialises a wgmma on a
// conditional path) each weight takes the TPU kernel's softmax_dtype=bfloat16 roundings
// against the final row max, in attention_fwd.cuh's BF16_EXP order: t = bf16(s - m),
// p = bf16(exp2(t log2e)), the fp32 sum of the rounded p, PV with the rounded p, and the
// division by the sum after PV.
//
// What bounds it on the H100: at D = 64 both products are 64 deep or wide, so the tensor cores
// (4 Nq Nk D operations a panel) and the exponentials (one a score on the SFUs, 16 a clock an
// SM) are of the same order; device memory is not the limit (a block reads its query tile and
// its panel's K and V, which the panel's other query tiles read again from L2).
// What the design does about it: FlashAttention-3's shape, simplified. One block per (128
// queries, head, batch row): a producer warpgroup whose one thread loads the query tile once
// and the panel's K and V in 128-key tiles by the TMA (3-D tensor maps, so keys and queries
// past the panel's end are zero-filled) into a 3-slot ring with full and empty mbarriers, and
// gives its registers to two consumer warpgroups (setmaxnreg 40 / 232), each of 64 query rows:
// S = Q K^T by wgmma m64n128k16 from the 128-byte-swizzled tiles, the online softmax on the
// accumulators in registers, P rounded to bf16 pairs in place as the A fragments of PV, and
// O += P V by wgmma m64n64k16 with A from registers and V read MN-major from its tile. The two
// warpgroups run independently, so one's softmax overlaps the other's products. fp32 inputs
// are rounded to bf16 copies once, by a streaming launch before the kernel (into the
// wrapper's scratch), not in the ring's registers.
// The bf16 exp mode's rounding of t needs the final max, which an online max cannot give, so
// it sweeps the keys twice through the same ring: first K alone (half a slot's bytes), S and
// the row max in registers with no exponential; then K and V again, S recomputed, the two
// roundings, the sum and PV with no rescale (the max is final). Where a cluster splits the
// keys, its blocks trade their row maxes by DSMEM behind one cluster barrier between the
// sweeps, so that every block rounds against the panel's max, and rank 0 adds the partial O
// and sums in rank order.

#include <cstdint>
#include <initializer_list>
#include <math.h>
#include <type_traits>

#include "ptx.cuh"
#include "tma_host.cuh"

namespace {

using namespace pcdiff_ptx;

constexpr int D = 64;
constexpr int BQ = 128;                       // queries a block: two warpgroups of 64
constexpr int BKV = 128;                      // keys a K/V tile
constexpr int STAGES = 3;                     // K/V tiles in the ring
constexpr int WARPS = 8;                      // consumer warps
constexpr int CONSUMERS = 32 * WARPS;
constexpr int THREADS = CONSUMERS + 128;      // and a producer warpgroup (one thread works)
constexpr int PRODUCER_REGS = 40;             // registers a thread after setmaxnreg:
constexpr int CONSUMER_REGS = 232;            // 128 x 40 + 256 x 232 of the SM's 65,536
constexpr int TILE = BKV * D;                 // bf16 elements of a K or V tile: a 16 KB box
constexpr int Q_TILE = BQ * D;
constexpr int MAX_SPLITS = 4;                 // blocks of a cluster that split a panel's keys
constexpr int PART = D / 8 + 2;               // float4s a consumer thread's partial takes:
                                              // its O, (m, m, l, l) of its two rows, and
                                              // the exp mode's first-sweep (m, m, -, -)
constexpr int ALIGN = 1024;                   // the 128-byte swizzle's period
constexpr size_t SMEM = ALIGN + (size_t)(Q_TILE + 2 * STAGES * TILE) * sizeof(bf16) +
                        (size_t)PART * CONSUMERS * sizeof(float4) +
                        (2 * STAGES + 1) * sizeof(unsigned long long);
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  CUtensorMap q_map, k_map, v_map;  // bf16 [B, N, H*64]: boxes of 64 features x 128 rows x 1
  void* o;                          // [B, Nq, H*64] in the inputs' dtype
  int nq, nk, heads;
  int splits;                       // blocks a query tile (a cluster), each a share of keys
};

// The block's query tile, the rank of its cluster, and its share [t0, t1) of the key tiles.
struct Share {
  int q0, rank, t0, t1;
};

__device__ __forceinline__ Share block_share(const Args& a) {
  const int ntiles = (a.nk + BKV - 1) / BKV;
  Share sh;
  sh.rank = a.splits > 1 ? (int)cluster_rank() : 0;
  sh.q0 = (int)(blockIdx.x / (unsigned)a.splits) * BQ;
  sh.t0 = ntiles * sh.rank / a.splits;
  sh.t1 = ntiles * (sh.rank + 1) / a.splits;
  return sh;
}

__device__ __forceinline__ float quad_max(float v) {  // across the 4 lanes of a row
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b) {
  if constexpr (std::is_same<T, bf16>::value)
    *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(dst) = make_float2(a, b);
}

// The producer's one thread: the block's query tile, then every K/V tile of its share into
// the ring, each slot refilled once the eight consumer warps have released it; in the exp
// mode a first sweep of the K tiles alone before them.
template <bool EXP>
__device__ __forceinline__ void produce(const Args& a, const Share& sh, bf16* sq, bf16* ring,
                                        unsigned long long* full, unsigned long long* empty,
                                        unsigned long long* qbar) {
  const int c0 = (int)blockIdx.y * D, b = (int)blockIdx.z, n = sh.t1 - sh.t0;
  mbar_expect_tx(qbar, Q_TILE * (unsigned)sizeof(bf16));
  tma_load_3d(sq, &a.q_map, qbar, c0, sh.q0, b);
#pragma unroll 1
  for (int i = 0; i < (EXP ? 2 * n : n); ++i) {
    const int slot = i % STAGES, use = i / STAGES;
    const bool with_v = !EXP || i >= n;
    const int k0 = (sh.t0 + (i < n ? i : i - n)) * BKV;
    if (use > 0) mbar_wait(&empty[slot], (use - 1) & 1);
    bf16* sk = ring + 2 * slot * TILE;
    mbar_expect_tx(&full[slot], (with_v ? 2 : 1) * TILE * (unsigned)sizeof(bf16));
    tma_load_3d(sk, &a.k_map, &full[slot], c0, k0, b);
    if (with_v) tma_load_3d(sk + TILE, &a.v_map, &full[slot], c0, k0, b);
  }
}

// The cluster's partials of a query tile merged into rank 0's, in rank order: each rank's O
// (unnormalised against its own running max), row max m and this lane's part of the row sum
// l; ranks past 0 leave theirs in `part` (their own shared memory), and rank 0 reads them by
// DSMEM and takes m = max(m, m_r), O = O 2^((m_old - m) log2e) + O_r 2^((m_r - m) log2e) and
// l likewise; in the exp mode every rank holds the same final max, so O = O + O_r and
// l = l + l_r. Every thread of every block of the cluster takes part in its two barriers (the
// producers by cluster_wait_after).
template <bool EXP>
__device__ __forceinline__ void merge_partials(float (&o)[D / 2], float (&m)[2], float (&l)[2],
                                               float4* part, int rank, int splits) {
  const int tid = threadIdx.x;
  if (rank > 0) {
#pragma unroll
    for (int q = 0; q < D / 8; ++q)
      part[q * CONSUMERS + tid] = make_float4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    part[(D / 8) * CONSUMERS + tid] = make_float4(m[0], m[1], l[0], l[1]);
  }
  cluster_sync();
  if (rank == 0) {
#pragma unroll 1
    for (int r = 1; r < splits; ++r) {
      const float4 ml = ld_peer_f4(part + (D / 8) * CONSUMERS + tid, (unsigned)r);
      const float mr[2] = {ml.x, ml.y}, lr[2] = {ml.z, ml.w};
      float sa[2] = {1.f, 1.f}, sb[2] = {1.f, 1.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if constexpr (EXP) {
          l[h] += lr[h];
        } else {
          const float mn = fmaxf(m[h], mr[h]);
          sa[h] = ex2((m[h] - mn) * LOG2E);
          sb[h] = ex2((mr[h] - mn) * LOG2E);
          l[h] = l[h] * sa[h] + lr[h] * sb[h];
          m[h] = mn;
        }
      }
#pragma unroll
      for (int q = 0; q < D / 8; ++q) {
        const float4 v = ld_peer_f4(part + q * CONSUMERS + tid, (unsigned)r);
        const float pv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {  // o[4 q + e]: row + 8 (e / 2)
          if constexpr (EXP)
            o[4 * q + e] += pv[e];
          else
            o[4 * q + e] = o[4 * q + e] * sa[e >> 1] + pv[e] * sb[e >> 1];
        }
      }
    }
  }
  cluster_sync();  // the peers' partials stay until rank 0 has read them
}

// The exp mode's first-sweep row maxes of the cluster's ranks, taken by every rank: each
// leaves its own in `part`, one cluster barrier, then each reads the others' by DSMEM (a max
// is the same in any order). No rank writes its slot again, so no second barrier is needed.
__device__ __forceinline__ void trade_max(float (&m)[2], float4* part, int rank, int splits) {
  const int tid = threadIdx.x;
  float4* slot = part + (D / 8 + 1) * CONSUMERS + tid;
  *slot = make_float4(m[0], m[1], 0.f, 0.f);
  cluster_sync();
#pragma unroll 1
  for (int r = 0; r < splits; ++r) {
    if (r == rank) continue;
    const float4 v = ld_peer_f4(slot, (unsigned)r);
    m[0] = fmaxf(m[0], v.x);
    m[1] = fmaxf(m[1], v.y);
  }
}

// The producer warpgroup's part in the cluster barriers of the consumers (the exp mode's max
// trade and the merge's two; the merge's alone): it arrives at the first before its loads,
// which the consumers wait on before they arrive, and waits for it after them.
template <bool EXP>
__device__ __forceinline__ void cluster_wait_after(bool loads, const Args& a, const Share& sh,
                                                   bf16* sq, bf16* ring,
                                                   unsigned long long* full,
                                                   unsigned long long* empty,
                                                   unsigned long long* qbar) {
  cluster_arrive();
  if (loads) produce<EXP>(a, sh, sq, ring, full, empty, qbar);
  cluster_wait();
#pragma unroll 1
  for (int i = EXP ? 2 : 1; i > 0; --i) cluster_sync();
}

// S = Q K^T of the warpgroup's 64 rows and a 128-key tile, keys past nk set to -inf.
__device__ __forceinline__ void scores(float (&s)[BKV / 2], const bf16* q_wg, const bf16* sk,
                                       int k0, int nk, int tig) {
  wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks)
    wgmma_m64n128k16(s, sw128_desc(q_wg + 16 * ks), sw128_desc(sk + 16 * ks), ks > 0);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(s);
  if (k0 + BKV > nk) {  // the panel's last tile, partial: keys past nk weigh nothing
#pragma unroll
    for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (k0 + 8 * j + 2 * tig + (e & 1) >= nk) s[4 * j + e] = -INFINITY;
  }
}

__device__ __forceinline__ float bf16_lo(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

// A consumer warpgroup: its 64 query rows against every K/V tile, then O / l stored. Thread t
// of the warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) of its 64, at columns
// 8 j + 2 (t % 4) (+ 1) of every accumulator: s[4 j + 2 h + e] is row + 8 h, key 8 j + ...
template <typename TO, bool EXP>
__device__ __forceinline__ void consume(const Args& a, const Share& sh, const bf16* sq,
                                        const bf16* ring, float4* part,
                                        unsigned long long* full, unsigned long long* empty,
                                        unsigned long long* qbar) {
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tig = lane & 3, n = sh.t1 - sh.t0;
  const bf16* q_wg = sq + wg * 64 * D;  // the warpgroup's rows: 8 KB, 1024-byte aligned
  float o[D / 2], s[BKV / 2], m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  unsigned pf[BKV / 16][4];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  mbar_wait(qbar, 0);
  int use = 0;  // the ring's slots taken so far, over both sweeps
  if constexpr (EXP) {  // the first sweep: the final row max, from K alone
#pragma unroll 1
    for (int i = 0; i < n; ++i, ++use) {
      const int slot = use % STAGES;
      mbar_wait(&full[slot], (use / STAGES) & 1);
      scores(s, q_wg, ring + 2 * slot * TILE, (sh.t0 + i) * BKV, a.nk, tig);
      if (lane == 0) mbar_arrive(&empty[slot]);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        m[r] = fmaxf(m[r], quad_max(mx));
      }
    }
    if (a.splits > 1) trade_max(m, part, sh.rank, a.splits);
  }
#pragma unroll 1
  for (int i = 0; i < n; ++i, ++use) {
    const int slot = use % STAGES;
    mbar_wait(&full[slot], (use / STAGES) & 1);
    const bf16* sk = ring + 2 * slot * TILE;
    const bf16* sv = sk + TILE;
    scores(s, q_wg, sk, (sh.t0 + i) * BKV, a.nk, tig);
    if constexpr (EXP) {
      // the TPU kernel's roundings against the final max, two scores at a time, the sum of
      // the rounded weights; the packed weights are PV's A fragments: k16 step kk's are n8
      // blocks 2 kk and 2 kk + 1, pair i of them row + 8 (i % 2)
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2) {
          const int r = i2 & 1;
          const unsigned t = pack_bf16(s[8 * kk + 2 * i2] - m[r], s[8 * kk + 2 * i2 + 1] - m[r]);
          const unsigned pp = pack_bf16(ex2(bf16_lo(t) * LOG2E), ex2(bf16_hi(t) * LOG2E));
          l[r] += bf16_lo(pp);
          l[r] += bf16_hi(pp);
          pf[kk][i2] = pp;
        }
    } else {
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
          mx = fmaxf(mx, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx));  // finite: every tile holds a key
        alpha[r] = ex2((m[r] - m_new) * LOG2E);           // 0 at the first tile
        const float off = m_new * LOG2E;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < BKV / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float p = ex2(fmaf(s[4 * j + 2 * r + e], LOG2E, -off));
            s[4 * j + 2 * r + e] = p;
            psum += p;
          }
        l[r] = l[r] * alpha[r] + psum;  // this lane's columns only
        m[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[4 * j + e] *= alpha[e >> 1];
      // P rounded to bf16 pairs: k16 step kk's A fragment is n8 blocks 2 kk and 2 kk + 1
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
        for (int i2 = 0; i2 < 4; ++i2)
          pf[kk][i2] = pack_bf16(s[8 * kk + 2 * i2], s[8 * kk + 2 * i2 + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      wgmma_m64n64k16_rs<1>(o, pf[kk], sw128_desc_mn(sv + kk * 16 * D, 8192), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) fence_regs(pf[kk]);
    if (lane == 0) mbar_arrive(&empty[slot]);  // this warp has done with the tile
  }

  if (a.splits > 1) merge_partials<EXP>(o, m, l, part, sh.rank, a.splits);
  if (sh.rank > 0) return;  // rank 0 stores the panel's rows

  const long long hd = (long long)a.heads * D;
  const int row0 = sh.q0 + 64 * wg + 16 * (warp % 4) + (lane >> 2);
  TO* out = static_cast<TO*>(a.o) + (long long)blockIdx.z * a.nq * hd + blockIdx.y * D + 2 * tig;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float inv = 1.f / quad_sum(l[r]);  // the division by the fp32 row sum after PV
    const int row = row0 + 8 * r;
    if (row < a.nq) {
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        store_pair(out + row * hd + 8 * j, o[4 * j + 2 * r] * inv, o[4 * j + 2 * r + 1] * inv);
    }
  }
}

template <typename TO, bool EXP>
__global__ void __launch_bounds__(THREADS, 1)
attention_mh64_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sq = reinterpret_cast<bf16*>(
      smem + ((ALIGN - (smem_u32(smem) & (ALIGN - 1))) & (ALIGN - 1)));
  bf16* ring = sq + Q_TILE;
  float4* part = reinterpret_cast<float4*>(ring + 2 * STAGES * TILE);
  unsigned long long* full = reinterpret_cast<unsigned long long*>(part + PART * CONSUMERS);
  unsigned long long* empty = full + STAGES;
  unsigned long long* qbar = empty + STAGES;
  const Share sh = block_share(a);

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < STAGES; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], WARPS);
    }
    mbar_init(qbar, 1);
    fence_mbar_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<PRODUCER_REGS>();
    const bool loads = threadIdx.x == CONSUMERS;
    if (a.splits > 1)
      cluster_wait_after<EXP>(loads, a, sh, sq, ring, full, empty, qbar);
    else if (loads)
      produce<EXP>(a, sh, sq, ring, full, empty, qbar);
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    consume<TO, EXP>(a, sh, sq, ring, part, full, empty, qbar);
  }
}

// fp32 inputs: q, k and v rounded to bf16 copies, 8 elements a thread (tensor blockIdx.y of
// the three), a grid of one chunk a thread so that every load is in flight at once.
struct Rounding {
  const float* src[3];
  bf16* dst[3];
  long long n[3];  // elements, multiples of 8
};

__global__ void __launch_bounds__(256) attention_mh64_round_kernel(const Rounding r) {
  const int i = blockIdx.y;  // selected, not indexed: the parameters stay in constant space
  const float4* src =
      reinterpret_cast<const float4*>(i == 0 ? r.src[0] : i == 1 ? r.src[1] : r.src[2]);
  uint4* dst = reinterpret_cast<uint4*>(i == 0 ? r.dst[0] : i == 1 ? r.dst[1] : r.dst[2]);
  const long long n = i == 0 ? r.n[0] : i == 1 ? r.n[1] : r.n[2];
  const long long c = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (c < n / 8) {
    const float4 a = __ldcs(src + 2 * c), b = __ldcs(src + 2 * c + 1);  // read once
    dst[c] = make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w), pack_bf16(b.x, b.y),
                        pack_bf16(b.z, b.w));
  }
}

// The tensor map of a bf16 [batch, n, heads * 64] tensor in 64 x 128 x 1 boxes.
int panel_map(CUtensorMap* map, const void* base, int batch, int n, int heads) {
  const cuuint64_t hd = (cuuint64_t)heads * D;
  const cuuint64_t dims[3] = {hd, (cuuint64_t)n, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {hd * sizeof(bf16), hd * sizeof(bf16) * (cuuint64_t)n};
  const cuuint32_t box[3] = {D, BKV, 1};
  return pcdiff_tma::tensor_map(map, base, 3, dims, strides, box);
}

template <typename TO, bool EXP>
int configure() {
  static bool configured = false;  // dynamic shared memory above 48 KB needs the attribute
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_mh64_kernel<TO, EXP>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  return 0;
}

// The launch's configuration: (query tiles x splits, heads, batch) blocks in clusters of
// `splits` along x (not to be copied: it points into itself).
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute cluster;
  Config(int qtiles, int heads, int batch, int splits, cudaStream_t stream) : cfg(), cluster() {
    cfg.gridDim = dim3((unsigned)(qtiles * splits), (unsigned)heads, (unsigned)batch);
    cfg.blockDim = dim3(THREADS);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = stream;
    cluster.id = cudaLaunchAttributeClusterDimension;
    cluster.val.clusterDim.x = (unsigned)splits;
    cluster.val.clusterDim.y = 1;
    cluster.val.clusterDim.z = 1;
    cfg.attrs = &cluster;
    cfg.numAttrs = 1;
  }
};

template <typename TO, bool EXP>
int launch(const Args& a, int batch, cudaStream_t stream) {
  if (const int e = configure<TO, EXP>()) return e;
  Config c((a.nq + BQ - 1) / BQ, a.heads, batch, a.splits, stream);
  return (int)cudaLaunchKernelEx(&c.cfg, attention_mh64_kernel<TO, EXP>, a);
}

}  // namespace

// q, k, v, o: device pointers of one dtype (is_bf16 = 1: bf16, 0: fp32), 16-byte aligned, in
// the [B, N, H*64] layout. fp32 inputs need `scratch`, room for bf16 copies of q, k and v
// (2 bytes an element, 16-byte aligned); bf16 inputs take none (null). bf16_exp = 1 selects
// the bf16 exp mode. Requires 0 < batch, heads <= 65535 and nq, nk > 0. Returns the
// cudaError_t of the launches (0 on success). Launches on `stream` and does not synchronise.
extern "C" int pcdiff_attention_mh64_fwd(const void* q, const void* k, const void* v, void* o,
                                         void* scratch, int batch, int nq, int nk, int heads,
                                         int is_bf16, int bf16_exp, int splits, void* stream) {
  if (batch <= 0 || nq <= 0 || nk <= 0 || heads <= 0 || batch > 65535 || heads > 65535 ||
      (!is_bf16 && scratch == nullptr) || splits < 1 || splits > MAX_SPLITS ||
      splits > (nk + BKV - 1) / BKV || (long long)((nq + BQ - 1) / BQ) * splits > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  for (const void* ptr : {q, k, v, static_cast<const void*>(o), static_cast<const void*>(scratch)})
    if (reinterpret_cast<std::uintptr_t>(ptr) % 16) return (int)cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long hd = (long long)heads * D;
  if (!is_bf16) {
    Rounding r;
    const long long nq_el = (long long)batch * nq * hd, nk_el = (long long)batch * nk * hd;
    bf16* dst = static_cast<bf16*>(scratch);
    r.src[0] = static_cast<const float*>(q);
    r.src[1] = static_cast<const float*>(k);
    r.src[2] = static_cast<const float*>(v);
    r.dst[0] = dst;
    r.dst[1] = dst + nq_el;
    r.dst[2] = dst + nq_el + nk_el;
    r.n[0] = nq_el;
    r.n[1] = r.n[2] = nk_el;
    const long long most = (nq_el > nk_el ? nq_el : nk_el) / 8;
    if ((most + 255) / 256 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    attention_mh64_round_kernel<<<dim3((unsigned)((most + 255) / 256), 3), 256, 0, s>>>(r);
    if (const cudaError_t e = cudaGetLastError()) return (int)e;
    q = r.dst[0];
    k = r.dst[1];
    v = r.dst[2];
  }
  Args a;
  if (const int e = panel_map(&a.q_map, q, batch, nq, heads)) return e;
  if (const int e = panel_map(&a.k_map, k, batch, nk, heads)) return e;
  if (const int e = panel_map(&a.v_map, v, batch, nk, heads)) return e;
  a.o = o;
  a.nq = nq;
  a.nk = nk;
  a.heads = heads;
  a.splits = splits;
  if (bf16_exp)
    return is_bf16 ? launch<bf16, true>(a, batch, s) : launch<float, true>(a, batch, s);
  return is_bf16 ? launch<bf16, false>(a, batch, s) : launch<float, false>(a, batch, s);
}

// How many clusters of `splits` blocks (1 to MAX_SPLITS) of the kernel the current device
// runs at once, for the wrapper's choice of splits; also the kernel's query and key tiles.
// Returns the cudaError_t (0 on success).
extern "C" int pcdiff_attention_mh64_tiling(int splits, int* clusters, int* bq, int* bkv) {
  if (splits < 1 || splits > MAX_SPLITS) return (int)cudaErrorInvalidValue;
  *bq = BQ;
  *bkv = BKV;
  if (const int e = configure<bf16, false>()) return e;
  Config c(1, 1, 1, splits, nullptr);
  return (int)cudaOccupancyMaxActiveClusters(clusters, attention_mh64_kernel<bf16, false>,
                                             &c.cfg);
}
