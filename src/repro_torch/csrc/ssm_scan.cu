// ssm_scan: selective state-space scan per (batch * head), the Mamba2 / mLSTM
// recurrence with a scalar decay per step and a (P x N) matrix state:
//     S_t = a_t S_{t-1} + x_t (x) b_t          y_t = S_t c_t
//   x (BH,L,P), b,c (G,L,N) with BH = G*H, x and the pair b, c each bf16 or
//   f32; a (BH,L) f32  ->  y (BH,L,P) f32, everything computed in f32.
// Heads gH .. gH+H-1 share b and c of group g (zamba2's heads share one B and
// C per batch row; G = BH is the plain per-head form).
//
// Replaces the TPU kernel `ssm_scan` (body `_ssm_kernel`) of
// src/repro/kernels/ssm_scan.py.  There the grid's second axis walks the
// chunks in order with S in VMEM, and each chunk is the SSD closed form with
// the decay between steps s <= t formed as a ratio of cumulative products.
// On this card that closed form would run on the f32 FMA pipe (the result
// must be f32 from f32 operands) at (2C(N+P) + 4PN) operations per step for
// chunk C, against 5PN for the recurrence.  So this kernel runs the
// recurrence step by step, exactly as the sequential oracle `ssm_scan_ref`
// defines it, and has no ratio of cumulative products anywhere.
//
// What bounds it on an H100: 5*P*N f32 operations per (bh, step) against
// (P + 2N/H) inputs and P outputs, so at P = N = 64 and above the bound is
// the f32 pipe (67 TFLOP/s).  Each state entry costs three instructions a
// step (a*S, + x*b, + S*c), so the issue rate caps the kernel at about 1.2x
// that bound.  At batch 128 it runs at about 2.4x (PERF.md), and per-warp
// cycle counters (tools/torch_ssm_breakdown.py) say why: the step loop is
// 251 instructions a step for 196 f32 ones (bf16 widening, loads), which
// alone needs 1.6x the bound at one issue a cycle; and each time tile's
// bulk copies take about a quarter of a warp's cycles to issue, with the
// outputs' stores another fifth, so the steps are under half of them.
// `ssm_scan_kernel_ring`:
//
//  * One block per (head, row tile, chunk): `rbh` rows of one head.  A
//    thread holds NS entries of each of RT consecutive rows; a row is split
//    over R threads (R*NS >= N, N zero-padded).  b and c (G,L,N) are read
//    per group, never repeated per head: the blocks of a group's heads find
//    them in L2 (blocks of 2 or 4 heads sharing one staged b/c tile measured
//    slower).  Rows past P fill a block up to whole warps.
//  * Four rows of 16 entries a thread where the grid is wide (each b and c
//    value a thread loads serves four rows; 128 registers, 16 warps an SM:
//    the 64-register variants with 32 warps were slower or spilled), one
//    row of 8 where it is narrow (`ssm_plan`).
//  * Time is staged T steps at a time through a ring of two slots filled by
//    bulk copies (TMA, one thread, completing on an mbarrier per slot; spans
//    that are not 16-byte aligned go by element copies): tile k+1 is in
//    flight while tile k steps.  b, c and x stay in their own dtypes in
//    shared memory and are widened to f32 as they are read.  The index
//    math of the bulk staging is shifts and products: no runtime division.
//  * Each thread stores its rows' partial dot products with c to shared
//    memory, and the R partials of a row are summed once a tile as the
//    outputs leave as contiguous rows (summing them by warp shuffles at
//    every step measured no faster).  One barrier a tile; the partials are
//    double-buffered.  The decay is applied one step at a time.
//
// A long scan with a small state (zamba2 at batch 1: 64 heads, too few
// blocks for the card) is chunk-parallel, three kernels from one call:
// the ring kernel scans each chunk from a zero state, writing its local y,
// its final state S_k and the products of decays from its start, w_t,
// formed step by step forward; `ssm_scan_kernel_carry` walks the chunks of
// each state entry in order, S_in(k+1) = A_k S_in(k) + S_k (A_k the
// chunk's last w); `ssm_scan_kernel_carry_out` adds w_t (S_in(k) c_t), an
// f32 product per chunk.  Products of decays may underflow to 0, which is
// then the right answer; nothing divides by one.  Pass 2 costs 2/5 of the
// recurrence's operations whatever the chunk length and runs at about a
// quarter of the f32 peak: it is what keeps this form above 4x its bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int NT = 256;       // most threads a block has
constexpr int MAX_N = 512;    // 32 threads of 16 entries per row
constexpr int SMEM_PER_SM = 232448;

struct Args {
    const void* x;
    const float* a;
    const void* b;
    const void* c;
    float* y;
    int L, P, N, H;               // H: heads per b/c group
    int x_bf16;                   // b and c share one dtype, the kernel's BC_BF16
    int lg_r;                     // log2 R, threads per state row
    int lg_trh;                   // log2 of a block's thread rows
    int T;                        // steps per staged tile
    int bc_bulk, x_bulk, a_bulk;  // 1: staged by bulk copies (16-byte aligned spans)
    int chunk, nc;                // steps per chunk (blockIdx.z), chunks; nc = 1: no chunking
    float* s_scr;                 // nc > 1: each chunk's final state (BH, nc, P, N)
    float* w_scr;                 // nc > 1: decay products from each chunk's start (BH, L)
};

template <int V>
using Int = std::integral_constant<int, V>;

__host__ __device__ constexpr int lg2(int v) {
    int l = 0;
    while ((1 << l) < v) ++l;
    return l;
}

__host__ __device__ inline size_t align16(size_t v) { return (v + 15) & ~size_t(15); }

// Shared-memory layout, the same on host and device: the row partials yp
// [2][T][R][ypitch] f32 (double-buffered: one tile's leave while the next
// tile's are written; ypitch pads the block's rows so that the R threads of
// a row, storing at once, hit different banks), then two slots of raw
// inputs in their own dtypes: b, c [T][npad] (zero past N), x [T][xp], a
// [T] f32.
struct Layout {
    int npad, rbh, xp, row_tiles, ypitch;
    size_t ybuf, raw, rc, rx, ra, slot, total;
};

__host__ __device__ inline Layout layout_of(const Args& A, int NS, int RT, int ebc) {
    Layout ly{};
    ly.npad = NS << A.lg_r;
    ly.rbh = RT << A.lg_trh;
    ly.row_tiles = (A.P + ly.rbh - 1) / ly.rbh;
    ly.xp = ly.row_tiles == 1 ? A.P : ly.rbh;
    ly.ypitch = ly.rbh + ((32 >> A.lg_r) > 4 ? (32 >> A.lg_r) : 4);
    const size_t T = A.T, f = sizeof(float), ex = A.x_bf16 ? 2 : 4;
    ly.ybuf = (T << A.lg_r) * ly.ypitch * f;
    ly.raw = 2 * ly.ybuf;
    ly.rc = align16(T * ly.npad * ebc);
    ly.rx = 2 * ly.rc;
    ly.ra = ly.rx + align16(T * ly.xp * ex);
    ly.slot = align16(ly.ra + T * f);
    ly.total = ly.raw + 2 * ly.slot;
    return ly;
}

// ---- bulk copies (TMA, 1-D) completing on an mbarrier --------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "WAIT_%=:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT_%=;\n"
        "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
    asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
                 :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// 4 bytes from device to shared memory (cp.async, through L1)
__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" :: "r"(smem_u32(smem)), "l"(gmem) : "memory");
}

// the low and high bf16 of a pair as f32; the byte permute runs on the
// integer pipe (a shift may compile to a multiply on the FMA pipe)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(__byte_perm(w, 0, 0x1044)); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ void st_shared_v4(float* p, float a, float b, float c, float d) {
    asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n"
                 :: "r"(smem_u32(p)), "f"(a), "f"(b), "f"(c), "f"(d));
}

// GS consecutive values of b or c at `p` (16 or 8-byte aligned), as f32
template <bool BF16, int GS>
__device__ __forceinline__ void load_group(float (&v)[GS], const unsigned char* p) {
    if constexpr (BF16 && GS == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(p);
        v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
        v[4] = bf16_lo(u.z); v[5] = bf16_hi(u.z); v[6] = bf16_lo(u.w); v[7] = bf16_hi(u.w);
    } else if constexpr (BF16) {
        const uint2 u = *reinterpret_cast<const uint2*>(p);
        v[0] = bf16_lo(u.x); v[1] = bf16_hi(u.x); v[2] = bf16_lo(u.y); v[3] = bf16_hi(u.y);
    } else {
        const float4 f = *reinterpret_cast<const float4*>(p);
        v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    }
}

__device__ __forceinline__ float ld_elem(const unsigned char* p, int i, int bf16) {
    return bf16 ? bf16_lo(reinterpret_cast<const uint16_t*>(p)[i])
                : reinterpret_cast<const float*>(p)[i];
}

// `count` elements of `esize` bytes from `src` to `dst` by the block's
// threads, plain loads and stores (for spans a bulk copy cannot take)
__device__ __forceinline__ void copy_elems(unsigned char* dst, const unsigned char* src, int count,
                                           int esize, int tid, int nt) {
    if (esize == 2)
        for (int i = tid; i < count; i += nt)
            reinterpret_cast<uint16_t*>(dst)[i] = reinterpret_cast<const uint16_t*>(src)[i];
    else
        for (int i = tid; i < count; i += nt)
            reinterpret_cast<uint32_t*>(dst)[i] = reinterpret_cast<const uint32_t*>(src)[i];
}

// Built with -DSSM_SCAN_CLOCKS (tools/torch_ssm_breakdown.py), the ring
// kernel sums each warp's SM cycles (lane 0's clock) by part of its tile
// loop into `ssm_clocks`, for warp 0 (which issues the bulk copies) and the
// other warps apart: CLK_WAIT for a tile's copies, CLK_SYNC the block's
// barrier, CLK_STAGE issuing the next tile, CLK_STORE the last tile's
// outputs, CLK_STEPS the steps, CLK_REST the set-up and the end; then the
// warps counted and the nanoseconds (`globaltimer`) they ran.  The clock
// reads keep memory accesses on their side.  Without the macro every call
// below is empty.
enum { CLK_WAIT, CLK_SYNC, CLK_STAGE, CLK_STORE, CLK_STEPS, CLK_REST, CLK_WARPS, CLK_NS, CLK_N };
#ifdef SSM_SCAN_CLOCKS
__device__ unsigned long long ssm_clocks[2][CLK_N];

__device__ __forceinline__ unsigned clock_now() {
    unsigned t;
    asm volatile("mov.u32 %0, %%clock;" : "=r"(t) :: "memory");
    return t;
}

__device__ __forceinline__ unsigned long long globaltimer() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}

struct Clocks {
    unsigned acc[CLK_REST + 1], t;
    unsigned long long ns;
    __device__ Clocks() : acc{}, t(clock_now()), ns(globaltimer()) {}
    __device__ void lap(int part) {
        const unsigned now = clock_now();
        acc[part] += now - t;
        t = now;
    }
    __device__ void flush() {
        if ((threadIdx.x & 31) != 0) return;
        unsigned long long* out = ssm_clocks[threadIdx.x >= 32];
        for (int i = 0; i <= CLK_REST; ++i) atomicAdd(&out[i], (unsigned long long)acc[i]);
        atomicAdd(&out[CLK_WARPS], 1ull);
        atomicAdd(&out[CLK_NS], globaltimer() - ns);
    }
};
#else
struct Clocks {
    __device__ void lap(int) {}
    __device__ void flush() {}
};
#endif

// 128 registers a thread at most: the narrow plans are held by their waves
// or shared memory, not by registers, and spilled at 64
template <int RT, int NS, bool BC_BF16>
__global__ void __launch_bounds__(NT, 2)
ssm_scan_kernel_ring(const Args A) {
    constexpr int EBC = BC_BF16 ? 2 : 4;
    constexpr int GS = BC_BF16 && NS >= 8 ? 8 : 4;     // b or c values a load
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ __align__(8) uint64_t bars[2];
    Clocks clk;
    const Layout ly = layout_of(A, NS, RT, EBC);

    const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
    const int R = 1 << A.lg_r, part = tid & (R - 1);
    const int lg_rbh = A.lg_trh + lg2(RT);
    const int rb0 = (tid >> A.lg_r) * RT;                            // this thread's first row
    const int L = A.L, P = A.P, N = A.N, T = A.T, npad = ly.npad, rbh = ly.rbh, xp = ly.xp;
    const int bh0 = blockIdx.x;
    const int g = bh0 / A.H;
    const int p0 = blockIdx.y * rbh;
    const int rows = min(rbh, P - p0);
    const int ex = A.x_bf16 ? 2 : 4;
    const unsigned char* bsrc = reinterpret_cast<const unsigned char*>(A.b) + (size_t)g * L * N * EBC;
    const unsigned char* csrc = reinterpret_cast<const unsigned char*>(A.c) + (size_t)g * L * N * EBC;
    const unsigned char* xsrc = reinterpret_cast<const unsigned char*>(A.x)
                                + ((size_t)bh0 * L * P + p0) * ex;
    const float* asrc = A.a + (size_t)bh0 * L;
    const int z = blockIdx.z, ts = z * A.chunk, te = min(L, ts + A.chunk);   // this chunk
    const int ntiles = (te - ts + T - 1) / T;
    const int ypitch = ly.ypitch;
    auto slot_of = [&](int k) { return smem + ly.raw + (size_t)(k & 1) * ly.slot; };
    auto yp_of = [&](int k) { return reinterpret_cast<float*>(smem + (size_t)(k & 1) * ly.ybuf); };

    // Stage tile k into its slot: spans a bulk copy takes from lanes of
    // warp j mod the block's warps (a power of two) for b, c, x, a (j = 0,
    // 1, 2, 3), so that no one warp issues them all; thread 0 announces the
    // slot's bytes (a copy may land first: the slot's phase still waits for
    // that arrival).  The rest by all threads.
    auto issue = [&](int k) {
        const int t0 = ts + k * T, tl = min(T, te - t0);
        unsigned char* s = slot_of(k);
        uint64_t* bar = &bars[k & 1];
        const int w = tid >> 5, nw = nt >> 5;
        if (tid == 0) {
            uint32_t bytes = 0;
            if (A.bc_bulk) bytes += 2u * tl * N * EBC;
            if (A.x_bulk) bytes += (uint32_t)tl * rows * ex;
            if (A.a_bulk) bytes += (uint32_t)tl * 4;
            mbar_expect_tx(bar, bytes);
        }
        if (A.bc_bulk)
            for (int j = 0; j < 2; ++j) {
                if (w != (j & (nw - 1))) continue;
                const unsigned char* src = (j ? csrc : bsrc) + (size_t)t0 * N * EBC;
                unsigned char* d = s + j * ly.rc;
                if (npad == N) {
                    if (lane == 0) bulk_copy(d, src, tl * N * EBC, bar);
                } else {
                    for (int tt = lane; tt < tl; tt += 32)
                        bulk_copy(d + tt * npad * EBC, src + (size_t)tt * N * EBC, N * EBC, bar);
                }
            }
        if (A.x_bulk && w == (2 & (nw - 1))) {
            if (ly.row_tiles == 1) {
                if (lane == 0) bulk_copy(s + ly.rx, xsrc + (size_t)t0 * P * ex, tl * P * ex, bar);
            } else {
                for (int tt = lane; tt < tl; tt += 32)
                    bulk_copy(s + ly.rx + tt * rbh * ex, xsrc + (size_t)(t0 + tt) * P * ex,
                              rows * ex, bar);
            }
        }
        if (A.a_bulk && w == (3 & (nw - 1)) && lane == 0) bulk_copy(s + ly.ra, asrc + t0, tl * 4, bar);
        if (!A.bc_bulk)        // into rows of npad, whose ends past N were zeroed up front
            for (int tt = tid >> 5; tt < tl; tt += nt >> 5) {
                const size_t o = (size_t)(t0 + tt) * N * EBC;
                copy_elems(s + tt * npad * EBC, bsrc + o, N, EBC, lane, 32);
                copy_elems(s + ly.rc + tt * npad * EBC, csrc + o, N, EBC, lane, 32);
            }
        if (!A.x_bulk) {
            const unsigned char* src = xsrc + (size_t)t0 * P * ex;
            if (ly.row_tiles == 1) {
                copy_elems(s + ly.rx, src, tl * P, ex, tid, nt);
            } else {
                for (int tt = tid >> 5; tt < tl; tt += nt >> 5)
                    copy_elems(s + ly.rx + tt * rbh * ex, src + (size_t)tt * P * ex, rows, ex, lane, 32);
            }
        }
        if (!A.a_bulk)
            for (int i = tid; i < tl; i += nt) cp_async_4(s + ly.ra + i * 4, asrc + t0 + i);
        cp_async_commit();
    };

    // tile k's outputs: the R partials of each row summed in order, then
    // stored as contiguous rows
    auto store_y = [&](int k) {
        const int t0 = ts + k * T, tl = min(T, te - t0);
        const float* yp = yp_of(k);
        float* y = A.y + ((size_t)bh0 * L + t0) * P + p0;
        if ((P & 3) == 0 && (rbh & 3) == 0) {
            for (int i = tid; i < (tl << (lg_rbh - 2)); i += nt) {
                const int e = i << 2, tt = e >> lg_rbh, r = e & (rbh - 1);
                if (r >= rows) continue;
                const float* src = yp + (size_t)(tt << A.lg_r) * ypitch + r;
                float4 v = *reinterpret_cast<const float4*>(src);
                for (int q = 1; q < R; ++q) {
                    const float4 u = *reinterpret_cast<const float4*>(src + q * ypitch);
                    v.x += u.x; v.y += u.y; v.z += u.z; v.w += u.w;
                }
                *reinterpret_cast<float4*>(y + (size_t)tt * P + r) = v;
            }
        } else {
            for (int i = tid; i < (tl << lg_rbh); i += nt) {
                const int tt = i >> lg_rbh, r = i & (rbh - 1);
                if (r >= rows) continue;
                const float* src = yp + (size_t)(tt << A.lg_r) * ypitch + r;
                float v = src[0];
                for (int q = 1; q < R; ++q) v += src[q * ypitch];
                y[(size_t)tt * P + r] = v;
            }
        }
    };

    if (tid == 0) {
        mbar_init(&bars[0], 1);
        mbar_init(&bars[1], 1);
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    if (npad != N)             // b and c past N stay zero in both slots
        for (int row = tid >> 5; row < 4 * T; row += nt >> 5) {      // slot, b or c, step
            unsigned char* d = slot_of(row / (2 * T)) + ((row / T) & 1) * ly.rc
                               + (row % T) * npad * EBC;
            for (int n = N + lane; n < npad; n += 32) {
                if constexpr (BC_BF16) reinterpret_cast<uint16_t*>(d)[n] = 0;
                else reinterpret_cast<float*>(d)[n] = 0.f;
            }
        }
    __syncthreads();

    // thread `part` owns groups part, part + R, ... of GS entries of each of
    // its rows, so at each step a row's R threads read neighbouring words
    float S[RT][NS];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < NS; ++j) S[r][j] = 0.f;
    bool live[RT];             // rows past P hold x = 0
#pragma unroll
    for (int r = 0; r < RT; ++r) live[r] = rb0 + r < rows;
    const bool x_vec = (xp % RT) == 0 && rows == rbh;   // no row past P to mask
    // chunked: the decay products from the chunk's start, formed step by step
    // forward, leave by one thread a head, once a tile
    float aprod = 1.f;
    float* w_out = A.nc > 1 && blockIdx.y == 0 && tid == 0 ? A.w_scr + (size_t)bh0 * L + ts : nullptr;

    clk.lap(CLK_REST);
    issue(0);
    clk.lap(CLK_STAGE);
    for (int k = 0; k < ntiles; ++k) {
        mbar_wait(&bars[k & 1], (k >> 1) & 1);   // tile k's bulk copies have landed
        cp_async_wait<0>();                      // and its other copies, for this thread
        clk.lap(CLK_WAIT);
        __syncthreads();                         // for all; tile k-1's steps are done
        clk.lap(CLK_SYNC);
        if (k + 1 < ntiles) issue(k + 1);        // into the slot tile k-1 left
        clk.lap(CLK_STAGE);
        if (k > 0) store_y(k - 1);
        clk.lap(CLK_STORE);

        const unsigned char* s = slot_of(k);
        const unsigned char* xs = s + ly.rx;
        const float* as = reinterpret_cast<const float*>(s + ly.ra);
        const int tl = min(T, te - ts - k * T);
        if (w_out)             // the decay products from the chunk's start, step by step
            for (int tt = 0; tt < tl; ++tt) {
                aprod *= as[tt];
                w_out[k * T + tt] = aprod;
            }
        // the steps, with x read one way for the whole tile: XF by bf16
        // pairs (4 live rows, 8-byte aligned), else by element, in bf16 (XB
        // 1), f32 (0) or the dtype A.x_bf16 names (2)
        auto steps = [&](auto x_fast, auto x_kind) {
            constexpr bool XF = decltype(x_fast)::value;
            constexpr int XB = decltype(x_kind)::value;
            const int xb = XB == 2 ? A.x_bf16 : XB;
            const unsigned char* bp = s + part * GS * EBC;           // this thread's groups
            const unsigned char* cp = s + ly.rc + part * GS * EBC;
            const unsigned char* xq = xs + 2 * rb0;
            float* yo = yp_of(k) + (size_t)part * ypitch + rb0;
            for (int tt = 0; tt < tl; ++tt) {
                const float at = as[tt];
                float xt[RT];
                if constexpr (XF) {
                    const uint2 u = *reinterpret_cast<const uint2*>(xq);
                    xt[0] = bf16_lo(u.x); xt[1 % RT] = bf16_hi(u.x);
                    xt[2 % RT] = bf16_lo(u.y); xt[3 % RT] = bf16_hi(u.y);
                } else {
#pragma unroll
                    for (int r = 0; r < RT; ++r)
                        xt[r] = live[r] ? ld_elem(xs, tt * xp + rb0 + r, xb) : 0.f;
                }
                float acc[RT][2];
#pragma unroll
                for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
                for (int q = 0; q < NS / GS; ++q) {
                    float bv[GS], cv[GS];
                    load_group<BC_BF16, GS>(bv, bp + q * R * GS * EBC);
                    load_group<BC_BF16, GS>(cv, cp + q * R * GS * EBC);
#pragma unroll
                    for (int r = 0; r < RT; ++r)
#pragma unroll
                        for (int e = 0; e < GS; ++e) {
                            float& st = S[r][q * GS + e];
                            st = fmaf(xt[r], bv[e], at * st);
                            acc[r][e & 1] = fmaf(st, cv[e], acc[r][e & 1]);
                        }
                }
                // this thread's partial dot products, summed over the row's R
                // threads when the tile's outputs leave: no shuffle in the loop
                if constexpr (RT == 4)
                    st_shared_v4(yo, acc[0][0] + acc[0][1], acc[1][0] + acc[1][1],
                                 acc[2][0] + acc[2][1], acc[3][0] + acc[3][1]);
                else
#pragma unroll
                    for (int r = 0; r < RT; ++r) yo[r] = acc[r][0] + acc[r][1];
                bp += npad * EBC;
                cp += npad * EBC;
                xq += 2 * xp;
                yo += (size_t)R * ypitch;
            }
        };
        using yes = std::true_type;
        using no = std::false_type;
        if constexpr (RT == 4) {     // a third loop here measured slower
            if (A.x_bf16 && x_vec) steps(yes{}, Int<1>{});
            else steps(no{}, Int<2>{});
        } else {                     // latency-bound: no test of x's dtype in the loop
            if (A.x_bf16) steps(no{}, Int<1>{});
            else steps(no{}, Int<0>{});
        }
        clk.lap(CLK_STEPS);
    }
    __syncthreads();
    store_y(ntiles - 1);
    if (A.nc > 1) {            // the chunk's final state, from a zero start
        float* sd = A.s_scr + ((size_t)bh0 * A.nc + z) * P * N;
#pragma unroll
        for (int r = 0; r < RT; ++r) {
            if (!live[r]) continue;
            float* row = sd + (size_t)(p0 + rb0 + r) * N;
#pragma unroll
            for (int q = 0; q < NS / GS; ++q)
#pragma unroll
                for (int e = 0; e < GS; ++e) {
                    const int n = (q * R + part) * GS + e;
                    if (n < N) row[n] = S[r][q * GS + e];
                }
        }
    }
    clk.lap(CLK_REST);
    clk.flush();
}

// Between chunks, in chunk order, for each (bh, state entry): the state a
// chunk starts from, S_in(k+1) = A_k S_in(k) + S_k, with A_k the chunk's
// product of decays (the last of its w).  In place: S_k becomes S_in(k).
__global__ void __launch_bounds__(256)
ssm_scan_kernel_carry(float* s_scr, const float* w, int L, int PN, int chunk, int nc) {
    constexpr int B = 8;       // chunks whose states are loaded at once
    const int e = blockIdx.x * blockDim.x + threadIdx.x, bh = blockIdx.y;
    if (e >= PN) return;
    float* sp = s_scr + (size_t)bh * nc * PN + e;
    const float* wl = w + (size_t)bh * L;
    float s = 0.f;
    for (int k0 = 0; k0 < nc; k0 += B) {
        float sk[B], ak[B];
#pragma unroll
        for (int j = 0; j < B; ++j) {
            const int k = min(k0 + j, nc - 1);
            sk[j] = sp[(size_t)k * PN];
            ak[j] = wl[min(L, (k + 1) * chunk) - 1];
        }
#pragma unroll
        for (int j = 0; j < B; ++j) {
            if (k0 + j >= nc) break;
            sp[(size_t)(k0 + j) * PN] = s;
            s = fmaf(ak[j], s, sk[j]);
        }
    }
}

// Pass 2 of a chunked scan: for chunk k >= 1, y_t += w_t (S_in(k) c_t), w_t
// the product of decays from the chunk's start to t.  One block per (bh,
// chunk, 128 steps x 64 rows): an f32 product over N in tiles of 32, each
// of 64 threads 16 steps x 8 rows.
constexpr int CO_T = 128, CO_P = 64, CO_K = 32, CO_I = CO_T / 8;

__global__ void __launch_bounds__(64)
ssm_scan_kernel_carry_out(const void* c, int c_bf16, const float* s_scr, const float* w,
                          float* y, int L, int P, int N, int H, int chunk, int nc, int p_tiles) {
    __shared__ __align__(16) float Ct[CO_K][CO_T];     // [k][step]
    __shared__ __align__(16) float St[CO_K][CO_P];     // [k][row]
    const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
    const int bh = blockIdx.x, k = blockIdx.y + 1;
    const int t_tile = blockIdx.z / p_tiles, pp0 = (blockIdx.z - t_tile * p_tiles) * CO_P;
    const int ts = k * chunk + t_tile * CO_T, te = min(L, min((k + 1) * chunk, ts + CO_T));
    if (ts >= te) return;
    const int tl = te - ts, g = bh / H;
    const float* sin = s_scr + ((size_t)bh * nc + k) * P * N;
    const unsigned char* cb = reinterpret_cast<const unsigned char*>(c)
                              + ((size_t)g * L + ts) * N * (c_bf16 ? 2 : 4);
    float acc[CO_I][8];
#pragma unroll
    for (int i = 0; i < CO_I; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    // each thread loads two steps' and one row's CO_K values of the k tile
    // at once (16-byte loads where the rows allow) and stores them transposed
    const bool vec = (N % 8) == 0 && (reinterpret_cast<uintptr_t>(c) & 15) == 0;
    for (int n0 = 0; n0 < N; n0 += CO_K) {
        float cv[2][CO_K], sv[CO_K];
        const int pr = pp0 + tid;
        if (vec && n0 + CO_K <= N) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int t = tid + 64 * h;
                if (t >= tl) continue;
                if (c_bf16) {
#pragma unroll
                    for (int q = 0; q < CO_K / 8; ++q) {
                        const uint4 u = *reinterpret_cast<const uint4*>(cb + 2 * ((size_t)t * N + n0 + 8 * q));
                        cv[h][8 * q + 0] = bf16_lo(u.x); cv[h][8 * q + 1] = bf16_hi(u.x);
                        cv[h][8 * q + 2] = bf16_lo(u.y); cv[h][8 * q + 3] = bf16_hi(u.y);
                        cv[h][8 * q + 4] = bf16_lo(u.z); cv[h][8 * q + 5] = bf16_hi(u.z);
                        cv[h][8 * q + 6] = bf16_lo(u.w); cv[h][8 * q + 7] = bf16_hi(u.w);
                    }
                } else {
#pragma unroll
                    for (int q = 0; q < CO_K / 4; ++q) {
                        const float4 f = *reinterpret_cast<const float4*>(cb + 4 * ((size_t)t * N + n0 + 4 * q));
                        cv[h][4 * q] = f.x; cv[h][4 * q + 1] = f.y;
                        cv[h][4 * q + 2] = f.z; cv[h][4 * q + 3] = f.w;
                    }
                }
            }
            if (pr < P) {
#pragma unroll
                for (int q = 0; q < CO_K / 4; ++q) {
                    const float4 f = *reinterpret_cast<const float4*>(sin + (size_t)pr * N + n0 + 4 * q);
                    sv[4 * q] = f.x; sv[4 * q + 1] = f.y; sv[4 * q + 2] = f.z; sv[4 * q + 3] = f.w;
                }
            }
        } else {
#pragma unroll
            for (int kk = 0; kk < CO_K; ++kk) {
                const int n = n0 + kk;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int t = tid + 64 * h;
                    cv[h][kk] = (t < tl && n < N) ? ld_elem(cb, t * N + n, c_bf16) : 0.f;
                }
                sv[kk] = (pr < P && n < N) ? sin[(size_t)pr * N + n] : 0.f;
            }
        }
#pragma unroll
        for (int kk = 0; kk < CO_K; ++kk) {
#pragma unroll
            for (int h = 0; h < 2; ++h) Ct[kk][tid + 64 * h] = tid + 64 * h < tl ? cv[h][kk] : 0.f;
            St[kk][tid] = pr < P ? sv[kk] : 0.f;
        }
        __syncthreads();
#pragma unroll 2
        for (int kk = 0; kk < CO_K; ++kk) {
            float av[CO_I], bv[8];
#pragma unroll
            for (int q = 0; q < CO_I / 4; ++q) {
                const float4 a4 = *reinterpret_cast<const float4*>(&Ct[kk][ty * CO_I + 4 * q]);
                av[4 * q] = a4.x; av[4 * q + 1] = a4.y; av[4 * q + 2] = a4.z; av[4 * q + 3] = a4.w;
            }
            const float4 b0 = *reinterpret_cast<const float4*>(&St[kk][tx * 8]);
            const float4 b1 = *reinterpret_cast<const float4*>(&St[kk][tx * 8 + 4]);
            bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
            bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
            for (int i = 0; i < CO_I; ++i)
#pragma unroll
                for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
        }
        __syncthreads();
    }
    // y += w_t acc: every y value of a step is loaded before it is stored,
    // so that the loads are not held behind stores the compiler cannot tell
    // apart
    const int pc = pp0 + tx * 8;
    const bool yvec = (P & 3) == 0 && pc + 8 <= P;       // rows of y 16-byte aligned
#pragma unroll
    for (int i = 0; i < CO_I; ++i) {
        const int t = ty * CO_I + i;
        if (t >= tl) break;
        const float wt = w[(size_t)bh * L + ts + t];
        float* yr = y + ((size_t)bh * L + ts + t) * P + pc;
        if (yvec) {
            const float4 v0 = *reinterpret_cast<const float4*>(yr);
            const float4 v1 = *reinterpret_cast<const float4*>(yr + 4);
            *reinterpret_cast<float4*>(yr) =
                make_float4(fmaf(wt, acc[i][0], v0.x), fmaf(wt, acc[i][1], v0.y),
                            fmaf(wt, acc[i][2], v0.z), fmaf(wt, acc[i][3], v0.w));
            *reinterpret_cast<float4*>(yr + 4) =
                make_float4(fmaf(wt, acc[i][4], v1.x), fmaf(wt, acc[i][5], v1.y),
                            fmaf(wt, acc[i][6], v1.z), fmaf(wt, acc[i][7], v1.w));
        } else {
            float v[8];
#pragma unroll
            for (int j = 0; j < 8; ++j) v[j] = pc + j < P ? yr[j] : 0.f;
#pragma unroll
            for (int j = 0; j < 8; ++j)
                if (pc + j < P) yr[j] = fmaf(wt, acc[i][j], v[j]);
        }
    }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <int RT, int NS, bool BC_BF16>
int launch_ring(Args args, int BH, cudaStream_t stream) {
    constexpr int EBC = BC_BF16 ? 2 : 4;
    const Layout ly = layout_of(args, NS, RT, EBC);
    if (ly.total > (size_t)SMEM_PER_SM) return (int)cudaErrorInvalidValue;
    const int ex = args.x_bf16 ? 2 : 4;
    // a bulk copy moves 16-byte aligned spans of a multiple of 16 bytes
    args.bc_bulk = aligned16(args.b) && aligned16(args.c) && (args.N * EBC) % 16 == 0 &&
                   (ly.npad == args.N || (ly.npad * EBC) % 16 == 0);
    args.x_bulk = aligned16(args.x) && (args.P * ex) % 16 == 0 &&
                  (ly.row_tiles == 1 || (args.P % ly.rbh == 0 && (ly.rbh * ex) % 16 == 0));
    args.a_bulk = aligned16(args.a) && args.L % 4 == 0;
    // above 48 KB of dynamic shared memory a kernel has to opt in
    cudaError_t e = cudaFuncSetAttribute(ssm_scan_kernel_ring<RT, NS, BC_BF16>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ly.total);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid((unsigned)BH, (unsigned)ly.row_tiles, (unsigned)args.nc);
    const int threads = 1 << (args.lg_r + args.lg_trh);
    ssm_scan_kernel_ring<RT, NS, BC_BF16><<<grid, threads, ly.total, stream>>>(args);
    e = cudaGetLastError();
    if (e != cudaSuccess || args.nc == 1) return (int)e;
    // chunked: carry the states across chunks, then add what they give
    const int PN = args.P * args.N;
    ssm_scan_kernel_carry<<<dim3((unsigned)((PN + 255) / 256), (unsigned)BH), 256, 0, stream>>>(
        args.s_scr, args.w_scr, args.L, PN, args.chunk, args.nc);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    const int p_tiles = (args.P + CO_P - 1) / CO_P;
    const dim3 g2((unsigned)BH, (unsigned)(args.nc - 1),
                  (unsigned)(((args.chunk + CO_T - 1) / CO_T) * p_tiles));
    ssm_scan_kernel_carry_out<<<g2, 64, 0, stream>>>(args.c, BC_BF16, args.s_scr, args.w_scr,
                                                     args.y, args.L, args.P, args.N, args.H,
                                                     args.chunk, args.nc, p_tiles);
    return (int)cudaGetLastError();
}

template <bool BC_BF16>
int launch_variant(int rt, int ns, Args args, int BH, cudaStream_t st) {
    if (rt == 1 && ns == 4) return launch_ring<1, 4, BC_BF16>(args, BH, st);
    if (rt == 1 && ns == 8) return launch_ring<1, 8, BC_BF16>(args, BH, st);
    if (rt == 4 && ns == 16) return launch_ring<4, 16, BC_BF16>(args, BH, st);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// The plan (`kernels/ssm_scan.ssm_plan`) as it arrives: rt rows and ns
// entries a thread (an instantiated pair), 2^lg_r threads a row, 2^lg_trh
// thread rows a block (one head's), t_tile steps a staged tile,
// chunks of `chunk` steps (a multiple of t_tile; chunk >= L: one pass).  With
// more than one chunk, s_scr (BH, chunks, P, N) and w_scr (BH, L) f32 are the
// caller's scratch, and three kernels run: the chunks from a zero state, the
// carry between chunks, and what the carried states add.
// x_bf16, bc_bf16: 1 when x (b and c) hold bf16, 0 when f32; a is f32.  All
// inputs contiguous; b and c (G,L,N) with BH % G == 0.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a plan the kernel does not
// take.
extern "C" int ssm_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               void* y, int BH, int G, int L, int P, int N, int x_bf16,
                               int bc_bf16, int rt, int ns, int lg_r, int lg_trh,
                               int t_tile, int chunk, void* s_scr, void* w_scr, void* stream) {
    if (BH <= 0 || G <= 0 || BH % G || L <= 0 || P <= 0 || N <= 0 || N > MAX_N ||
        t_tile <= 0 || t_tile % 4 || chunk <= 0 || chunk % t_tile)
        return (int)cudaErrorInvalidValue;
    const int nc = (L + chunk - 1) / chunk;
    if (nc > 65535 || (nc > 1 && (s_scr == nullptr || w_scr == nullptr)))
        return (int)cudaErrorInvalidValue;
    const int H = BH / G;
    const int threads_lg = lg_r + lg_trh;
    if (lg_r < 0 || lg_trh < 0 || threads_lg < 5 || threads_lg > 8 || (ns << lg_r) < N)
        return (int)cudaErrorInvalidValue;
    Args args{x, (const float*)a, b, c, (float*)y, L, P, N, H, x_bf16, lg_r, lg_trh,
              t_tile, 0, 0, 0, chunk, nc, (float*)s_scr, (float*)w_scr};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    return bc_bf16 ? launch_variant<true>(rt, ns, args, BH, st)
                   : launch_variant<false>(rt, ns, args, BH, st);
}

#ifdef SSM_SCAN_CLOCKS
// The ring kernel's cycle sums since the last call, into `out` (2 x CLK_N:
// warp 0, then the others), and back to zero.
extern "C" int ssm_scan_clocks(unsigned long long* out) {
    static const unsigned long long zero[2][CLK_N] = {};
    cudaError_t e = cudaMemcpyFromSymbol(out, ssm_clocks, sizeof zero);
    if (e == cudaSuccess) e = cudaMemcpyToSymbol(ssm_clocks, zero, sizeof zero);
    return (int)e;
}
#endif
