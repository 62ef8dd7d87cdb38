// Tensor-core primitives shared by the kernels: ldmatrix loads of 8x8 b16
// matrices from shared memory and the m16n8k16 bf16 product with f32
// accumulation (mma.sync); cp.async copies, the exact int8 -> bf16 widening
// and the warpgroup products (wgmma, A from registers or shared memory)
// follow at the end.
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

// ---- asynchronous copies (cp.async) -----------------------------------------

// 16 bytes from device to shared memory, bypassing L1; `src_bytes` = 0 writes
// 16 zero bytes and reads nothing.
__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem, int src_bytes) {
    const uint32_t addr = (uint32_t)__cvta_generic_to_shared(smem);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 :: "r"(addr), "l"(gmem), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Four int8 levels r = [e0, o0, e1, o1] (low byte first) as two bf16x2
// registers, even = (e0, e1) and odd = (o0, o1), `0` halves low.  Exact: each
// level is biased to 0..255 and set into the mantissa of 2^23, the bias
// 2^23 + 128 is subtracted in f32 (exact), and the f32's upper half is kept,
// which is the value itself in bf16 (|level| <= 128 has at most 8 significant
// bits).
__device__ __forceinline__ void i8x4_to_bf16x2(uint32_t r, uint32_t& even, uint32_t& odd) {
    const uint32_t u = r ^ 0x80808080u;
    const float e0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
    const float o0 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
    const float e1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
    const float o1 = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
    even = __byte_perm(__float_as_uint(e0), __float_as_uint(e1), 0x7632);
    odd = __byte_perm(__float_as_uint(o0), __float_as_uint(o1), 0x7632);
}

// ---- warpgroup products (wgmma, sm_90a only) --------------------------------
//
// m64nNk16, bf16 in, f32 accumulators, A (64 x 16) from registers
// (`wgmma_rs`) or from shared memory (`wgmma_ss`) and B (16 x N) from shared
// memory, each through a descriptor.  A's register fragment in each warp of
// the warpgroup is the m16n8k16 A fragment above for rows 16*warp..+15; D
// holds, for j < N/8, d[4j..4j+1] = (row g, cols 8j+2t, +1) and
// d[4j+2..4j+3] = (row g+8, the same cols).  scale_d = 0 writes D = A*B, 1
// adds A*B to D.  The registers of A and D may be touched again only after
// a wgmma_wait covering the product (`wgmma_keep` holds them live until then).
// B is K-major (K contiguous, `sw128_desc`) unless TRANS_B = 1, which reads
// it MN-major (N contiguous, `sw128_mn_desc`).

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

// Orders this thread's generic-proxy writes to shared memory (st.shared,
// cp.async) before later async-proxy reads of it (wgmma operands).
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void wgmma_keep(float (&d)[R]) {
#pragma unroll
    for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void wgmma_keep(uint32_t (&a)[4]) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i]) :: "memory");
}

// Descriptor of a K-major bf16 operand laid out as the 128-byte swizzle
// does: rows of 64 values (128 bytes), the 16-byte chunk c of row r at chunk
// c ^ (r % 8), 8-row atoms 1024 bytes apart, atoms 1024-byte aligned.  A
// 16-deep slice starts 32 bytes further along its row.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t smem_addr) {
    return (uint64_t)((smem_addr & 0x3FFFF) >> 4)       // start address, 16-byte units
           | ((uint64_t)1 << 16)                         // leading byte offset (unused when swizzled)
           | ((uint64_t)(1024 >> 4) << 32)               // stride byte offset: next 8-row atom
           | ((uint64_t)1 << 62);                        // 128-byte swizzle
}

// Descriptor of an MN-major bf16 operand in the 128-byte swizzle: for each
// K (row) 128 bytes of 64 consecutive N values, the 16-byte chunk c of row r
// at chunk c ^ (r % 8); 8-row atoms 1024 bytes apart (the stride byte
// offset, along K); the next 64 N values `panel_bytes` further on (the
// leading byte offset); atoms 1024-byte aligned.  A 16-deep slice starts 16
// rows (2048 bytes) further on.
__device__ __forceinline__ uint64_t sw128_mn_desc(uint32_t smem_addr, uint32_t panel_bytes) {
    return (uint64_t)((smem_addr & 0x3FFFF) >> 4)
           | ((uint64_t)((panel_bytes >> 4) & 0x3FFF) << 16)   // leading byte offset: next 64 N
           | ((uint64_t)(1024 >> 4) << 32)                     // stride byte offset: next 8 K
           | ((uint64_t)1 << 62);
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(TRANS_B));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// Both operands from shared memory, both K-major (`sw128_desc`).
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b,
                                         int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}
