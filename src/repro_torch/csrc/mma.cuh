// Warp-level tensor-core primitives shared by the kernels: ldmatrix loads of
// 8x8 b16 matrices from shared memory and the m16n8k16 bf16 product with f32
// accumulation (mma.sync; the warpgroup form, wgmma, is not used yet).
//
// Fragment layout of one m16n8k16 product, lane = 4*g + t:
//   A (16x16, row-major): a0 = (row g,   k 2t..2t+1)   a1 = (row g+8, k 2t..2t+1)
//                         a2 = (row g,   k 2t+8..+9)   a3 = (row g+8, k 2t+8..+9)
//   B (16x8):             b0 = (k 2t..2t+1, col g)     b1 = (k 2t+8..+9, col g)
//   C (16x8, f32):        c0,c1 = (row g, col 2t..2t+1)  c2,c3 = (row g+8, col 2t..2t+1)
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Four 8x8 matrices; lane l gives the address of row l%8 of matrix l/8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// The same, each matrix transposed on the way: turns [k][n] storage into B fragments.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as one bf16x2 register, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
}
