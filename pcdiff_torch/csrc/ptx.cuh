// PTX primitives of the port's Hopper (sm_90a) kernels: cp.async copies into shared memory,
// ldmatrix fragment loads, the m16n8k16 bf16 and m16n8k8 TF32 tensor-core products with fp32
// accumulation and the rounding to TF32, ex2.approx and bf16 packing, the warpgroup product
// wgmma (A from shared memory or from registers) with its fences and shared-memory
// descriptors, the pieces of a warp-specialised ring (mbarriers, named barriers, the tensor
// memory accelerator's 2-D and 3-D copies, a 2-D copy multicast to a cluster) and of a
// thread-block cluster (its barrier, a peer block's shared memory and mbarriers, a bulk copy
// into a peer's shared memory). Shared by
// the attention loop (attention_fwd.cuh), the LayerNorm -> projections loop
// (ln_dense_fwd.cuh) and its wide rows (ln_dense.cu), the whole-MLP kernel (ln_mlp.cu), the
// LayerNorm -> projections backward (ln_dense_bwd.cu) and the head-dim-64 attention
// (attention_mh64.cu); the TF32 pieces by the head-split attention's fp32 kernel (attention.cu)
// and the wide rows' fp32 path.

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace pcdiff_ptx {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes < 16 zero-fills the rest.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// 4 bytes from global to shared memory (through L1: cp.async takes 16 bytes only with .cg);
// src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(src_bytes) : "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// d += a b for one m16n8k16 tile: a the 16 x 16 A fragment, (b0, b1) the 16 x 8 B fragment.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 4 fp32 matrices (rows of 16 bytes) by ldmatrix's b16 form: lanes 8i..8i+7 give
// the row addresses of matrix i, and lane l receives word l % 4 of row l / 4 of each, in r[i].
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// x rounded to TF32 (10 mantissa bits, to nearest, ties away from zero) in fp32's layout,
// the 13 low bits zero: the bits cvt.rna.tf32.f32 gives a finite x, by two integer
// operations (ptxas expands that instruction into four, with a guard for inf and NaN).
__device__ __forceinline__ unsigned round_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// d += a b for one m16n8k8 TF32 tile, fp32 accumulation: a the 16 x 8 A fragment (a[0]: row
// g, column t; a[1]: row g + 8; a[2]: row g, column t + 4; a[3]: row g + 8, column t + 4;
// g = lane / 4, t = lane % 4), (b0, b1) the 8 x 8 B fragment (rows t and t + 4, column g).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {  // 2^x; -inf gives 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

__device__ __forceinline__ float round_bf16(float v) {  // v rounded to bf16, as fp32
  return __bfloat162float(__float2bfloat16(v));
}

// ---- warpgroup matrix multiply (wgmma, sm_90a) ----

// Makes this thread's generic-proxy writes to shared memory (st.shared, cp.async) visible to
// the async proxy that wgmma reads shared memory through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// The shared-memory descriptor of a K-major bf16 operand in the 128-byte swizzle: rows of 64
// elements (128 bytes) whose 16-byte chunk c sits at c ^ (row % 8), groups of 8 rows 1024
// bytes apart, the whole 1024-byte aligned. p is the operand's first row at its k offset
// (a k16 step advances p by 32 bytes inside the row).
__device__ __forceinline__ unsigned long long sw128_desc(const void* p) {
  const unsigned long long addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)              // start address, bits 0-13
         | (1ull << 16)                        // leading byte offset: unused when swizzled
         | ((1024ull >> 4) << 32)              // stride byte offset: the next 8 rows
         | (1ull << 62);                       // 128-byte swizzle
}

// d (+)= A B^T for a 64 x N x 16 step of one warpgroup: A 64 x 16 and B N x 16, both
// K-major in shared memory, fp32 accumulators. accumulate = 0 overwrites d. Thread t of the
// warpgroup holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) at columns 8 j + 2 (t % 4) (+ 1):
// d[4 j + 2 h + e] is row + 8 h, column + e.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], unsigned long long da,
                                                unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], unsigned long long da,
                                                unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], unsigned long long da,
                                                 unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

template <int N>
__device__ __forceinline__ void wgmma_m64k16(float (&d)[N / 2], unsigned long long da,
                                             unsigned long long db, int accumulate) {
  if constexpr (N == 64)
    wgmma_m64n64k16(d, da, db, accumulate);
  else
    wgmma_m64n128k16(d, da, db, accumulate);
}

// d (+)= A B^T for a 64 x 256 x 16 step of one warpgroup with A in registers: each warp's
// 16 rows of A as the m16n8k16 A fragment (a[0]: row g, columns 2 t, +1; a[1]: row g + 8;
// a[2]: row g, columns 8 + 2 t, +1; a[3]: row g + 8, the same; g = lane / 4, t = lane % 4),
// which is the layout of a 64 x 16 slice of a wgmma accumulator rounded to bf16 pairs; B
// 256 x 16 K-major in shared memory. The registers of a and d must not be touched until
// wgmma_wait has seen the product complete (fence_regs keeps the compiler from reusing them).
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const unsigned (&a)[4],
                                                    unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// d (+)= A B for a 64 x 64 x 16 step of one warpgroup with A in registers (the m16n8k16 A
// fragment of wgmma_m64n256k16_rs) and B in shared memory: 64 x 16 K-major (sw128_desc,
// TRANS_B = 0) or 16 x 64 MN-major (sw128_desc_mn, TRANS_B = 1); the accumulators in the
// layout of wgmma_m64n64k16's. The same register rules as wgmma_m64n256k16_rs.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const unsigned (&a)[4],
                                                   unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// The shared-memory descriptor of an MN-major bf16 operand in the 128-byte swizzle, the
// layout wgmma reads with its transpose bit set: rows of 64 elements (128 bytes) contiguous
// in M (or N), one row per k, whose 16-byte chunk c sits at c ^ (k % 8); groups of 8 k rows
// 1024 bytes apart (the stride byte offset), each 64-wide block of M or N `lbo` bytes after
// the last (the leading byte offset), the whole 1024-byte aligned. p is the operand's first
// block at its k offset (a k16 step advances p by 16 rows, 2048 bytes).
__device__ __forceinline__ unsigned long long sw128_desc_mn(const void* p, unsigned lbo) {
  const unsigned long long addr = smem_u32(p);
  return ((addr & 0x3FFFF) >> 4)                            // start address, bits 0-13
         | ((unsigned long long)((lbo & 0x3FFFF) >> 4) << 16)  // leading byte offset
         | ((1024ull >> 4) << 32)                            // stride byte offset
         | (1ull << 62);                                     // 128-byte swizzle
}

// d (+)= A B for a 64 x 256 x 16 step of one warpgroup, both operands in shared memory,
// fp32 accumulators in the layout of wgmma_m64n64k16's (32 n8 blocks: d[4 j + 2 h + e] is
// row 16 (t / 32) + (t % 32) / 4 + 8 h, column 8 j + 2 (t % 4) + e). A is 64 x 16: K-major
// (sw128_desc, TRANS_A = 0) or MN-major (sw128_desc_mn, TRANS_A = 1); B is 16 x 256 read
// MN-major (sw128_desc_mn over four 64-column blocks, TRANS_B = 1) or 256 x 16 K-major
// (TRANS_B = 0). K4's bf16 path: dy = gz W (A K-major, W's [F, C] rows MN-major) and
// dW = gz^T y (both MN-major: their rows are the contraction).
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n256k16_ss(float (&d)[128], unsigned long long da,
                                                    unsigned long long db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_A), "n"(TRANS_B));
}

// Pins registers that an in-flight wgmma reads or writes: the compiler may neither move
// their uses across this point nor hand them to other values before it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(unsigned (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Moves registers between the warpgroups of a warp-specialised block: a producer gives its
// surplus back (dec) and the consumers take it (inc), N a multiple of 8 in [24, 256].
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// ---- mbarriers, named barriers and the tensor memory accelerator (TMA) ----

__device__ __forceinline__ void mbar_init(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}
// Makes the barriers' initialisation visible to the other threads and to the async proxy.
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also expects `bytes` of asynchronous copies to complete on the barrier.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
}
// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads: sync waits for the
// count, arrive adds this warp's threads without waiting.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(count) : "memory");
}

// ---- thread-block clusters: the block's rank, the cluster barrier, a peer's shared memory ----

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster arrives and waits; shared-memory writes before
// it are visible to the cluster's blocks after it. Not .aligned: a warp may reach it
// diverged (a producer warp whose one working lane arrives last).
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The same barrier in two halves, for a thread with work of its own between them (a producer
// whose loads the cluster's consumers wait on before they arrive).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}
// The address, in the cluster's shared window, of the offset of `p` in block `rank`'s shared
// memory.
__device__ __forceinline__ unsigned peer_addr(const void* p, unsigned rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_u32(p)), "r"(rank));
  return remote;
}
// 16 bytes of block `rank`'s shared memory at the offset of `p` in this block's.
__device__ __forceinline__ float4 ld_peer_f4(const void* p, unsigned rank) {
  const unsigned remote = peer_addr(p, rank);
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "r"(remote) : "memory");
  return v;
}

// One arrival on block `rank`'s mbarrier at the offset of `bar`, releasing this thread's
// earlier memory operations to the cluster (a consumer telling a peer that it is done reading).
__device__ __forceinline__ void mbar_arrive_peer(unsigned long long* bar, unsigned rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n"
               :: "r"(peer_addr(bar, rank)) : "memory");
}
// An arrival on block `rank`'s mbarrier at the offset of `bar` with a local arrival's
// semantics (release at the CTA's scope), as CUTLASS's cluster pipelines signal a stage's
// producers: for a consumer whose reads of the stage were wgmma's, complete once wgmma_wait
// returned, so that nothing of its own needs to be made visible to the cluster first. Each
// mbar_arrive_peer is a release at the cluster's scope, far costlier when a warp makes one
// every stage.
__device__ __forceinline__ void mbar_arrive_remote(unsigned long long* bar, unsigned rank) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" :: "r"(peer_addr(bar, rank))
               : "memory");
}
// mbar_wait with acquire at the cluster's scope: for a barrier that a peer block arrives on or
// completes bytes on.
__device__ __forceinline__ void mbar_wait_cluster(unsigned long long* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}
// `bytes` (a multiple of 16, both ends 16-byte aligned) of this block's shared memory at `src`
// copied by the bulk-copy unit to block `rank`'s at the offset of `dst`; completion counts the
// bytes on `rank`'s mbarrier at the offset of `bar`. The copy reads through the async proxy: the
// threads that wrote `src` fence (fence_proxy_async) before the thread that issues it sees them.
__device__ __forceinline__ void bulk_copy_to_peer(void* dst, const void* src, unsigned bytes,
                                                  unsigned long long* bar, unsigned rank) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n"
      :: "r"(peer_addr(dst, rank)), "r"(smem_u32(src)), "r"(bytes), "r"(peer_addr(bar, rank))
      : "memory");
}

// The box of the 2-D tensor map `map` (a __grid_constant__ kernel parameter) at element
// coordinates (c0 innermost, c1) copied to shared memory at `dst` by the TMA, in the map's
// swizzle, elements outside the tensor zero-filled; completion counts its bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, unsigned long long* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1) : "memory");
}

// The box of tma_load_2d written into the shared memory of every block of the cluster whose
// bit is set in `mask` (bit i: rank i), each at the offset of `dst` in its own, completing on
// each one's mbarrier at the offset of `bar`: one read of L2 for the cluster.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const void* map,
                                                      unsigned long long* bar, int c0, int c1,
                                                      unsigned short mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".multicast::cluster [%0], [%1, {%4, %5}], [%2], %3;\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "h"(mask), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 3-D tensor map, coordinates (c0 innermost, c1, c2).
__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, unsigned long long* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(map), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

}  // namespace pcdiff_ptx
