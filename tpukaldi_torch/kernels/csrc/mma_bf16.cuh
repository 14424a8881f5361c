// bf16 tensor-core products with float32 accumulators from shared memory:
// ldmatrix to load the fragments and mma.sync.m16n8k16 to multiply.
//
// A 16 x 16 bf16 tile stored row-major (k contiguous for an A tile of rows
// x depth; n contiguous for a B tile of depth x columns), with 16-byte
// aligned rows, loads with one ldmatrix.x4: lane l gives the address of
// row l % 16, columns (l / 16) * 8 ... + 7.  For A that yields the four
// registers of mma's A fragment; for B, with .trans, the two-register B
// fragments of the tile's left and right 8 columns.  The accumulator of a
// 16 x 8 product: lane l holds (row l / 4, columns 2 (l % 4) and + 1) in
// d[0], d[1] and the same columns of row l / 4 + 8 in d[2], d[3].

#pragma once

#include <cuda_runtime.h>

#include "persist_grid.cuh"

namespace tpk {

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* row) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(row)));
}

// d += a (16 x 16) * b (16 x 8), products exact, sums in float32
__device__ __forceinline__ void mma_16816(float (&d)[4], const unsigned (&a)[4],
                                          unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tpk
