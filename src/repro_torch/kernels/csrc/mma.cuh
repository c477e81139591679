// Tensor-core building blocks shared by the bf16 routes of the flash
// forward (`flash_attention.cu`), the paged partials
// (`paged_flash_decode.cu`) and the weight-only packed matmul, and by
// the integer packed matmul (both `mpq_matmul.cu`): 16-byte (and, for
// row scales, 4-byte) asynchronous copies into shared memory,
// `ldmatrix` fragment loads and the warp-level products
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32` and (`mma_s8`,
// below) `m16n8k32.row.col.s32.s8.s8.s32`.
//
// Fragment layouts of m16n8k16 (lane t of a warp, g = t / 4, c = t % 4):
//   A (16 x 16, row-major):  a0 = A[g][2c..2c+1],   a1 = A[g+8][2c..2c+1],
//                            a2 = A[g][2c+8..+9],   a3 = A[g+8][2c+8..+9]
//   B (16 x 8, "col"):       b0 = B[2c..2c+1][g],   b1 = B[2c+8..+9][g]
//   C/D (16 x 8, float32):   d0, d1 = D[g][2c..2c+1], d2, d3 = D[g+8][..]
// Each register of A and B holds two bf16, the lower column (or row) in
// the low half.  `ldmatrix` gives exactly these registers from 8 x 8
// tiles of 16-bit values in shared memory: plain for a tile stored with
// the fragment's k contiguous, `.trans` for one stored with k as rows.
// Tiles in shared memory are padded by 8 bf16 (16 bytes) a row, so the
// eight rows of one 8 x 8 load land in distinct bank quads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16-byte copy global -> shared that bypasses L1; `full` false writes
// 16 zero bytes instead (src must still be a valid address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0)
               : "memory");
}

// 4-byte copy global -> shared through L1 (`.cg` takes 16 bytes only);
// `full` false writes 4 zero bytes instead (src must still be valid).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 tiles of 16-bit values; lane 8i + j gives row j of tile i.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// The same, each tile transposed on the way to the registers.
__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// d += A * B on the tensor cores: bf16 products, float32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += A * B on the tensor cores: s8 products, exact int32 sums (the
// integer packed matmul).  Fragment layouts of m16n8k32, four s8 a
// register with the lowest k in the low byte:
//   A (16 x 32, row-major):  a0 = A[g][4c..4c+3],    a1 = A[g+8][4c..4c+3],
//                            a2 = A[g][16+4c..+19],  a3 = A[g+8][16+4c..+19]
//   B (32 x 8, "col"):       b0 = B[4c..4c+3][g],    b1 = B[16+4c..+19][g]
//   C/D (16 x 8, int32):     as m16n8k16's float32 C/D.
// A sum of exact products is exact in any order, so any assignment of k
// to fragment slots gives the same result, as long as A and B share it.
__device__ __forceinline__ void mma_s8(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (nearest even) in one register, lo first.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<unsigned*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(unsigned r) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&r));
}

__host__ __device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
