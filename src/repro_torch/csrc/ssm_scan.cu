// ssm_scan: selective state-space scan per (batch * head), the Mamba2 / mLSTM
// recurrence with a scalar decay per step and a (P x N) matrix state:
//     S_t = a_t S_{t-1} + x_t (x) b_t          y_t = S_t c_t
//   x (BH,L,P), b,c (BH,L,N), each bf16 or f32 on its own; a (BH,L) f32
//   ->  y (BH,L,P) f32, everything computed in f32.
//
// Replaces the TPU kernel `ssm_scan` (body `_ssm_kernel`) of
// src/repro/kernels/ssm_scan.py.  There the grid's second axis walks the
// chunks in order with S in VMEM, and each chunk is the SSD closed form: two
// MXU products for the intra-chunk term and one for the state update, with
// the decay between steps s <= t formed from cumulative products.  On this
// card that closed form would run on the f32 FMA pipe, because the result
// must be f32 from f32 operands, and it costs (2C(N+P) + 4PN) operations per
// step for chunk C (about 50 GFLOP at zamba2's batch-128 prefill) against
// 5PN for the recurrence itself.  So this kernel runs the recurrence step by
// step, exactly as the sequential oracle `ssm_scan_ref` defines it:
//
//  * One block per (bh, tile of P rows).  Rows of S are independent given a,
//    b and c, so a block owns whole rows and nothing crosses blocks.  The
//    sequential chunk axis of the TPU grid becomes the time loop inside the
//    block, and S never leaves registers: a thread holds 16 entries of each
//    of RT consecutive rows (RT = 4 when P >= 16 and the scan is wide enough
//    to fill the card four times over at one row a thread, else 1), and a row is
//    split over R threads (R a power of two, R*16 >= N).  Each b and c value
//    a thread reads from shared memory serves its RT rows, which keeps the
//    loop on the f32 pipe rather than on shared-memory bandwidth.
//  * Per step a thread does S = a*S + x*b on its entries and partial dots
//    with c; the R partials of a row meet by warp shuffles.  The decay is
//    applied one step at a time, so there is no ratio of cumulative products
//    anywhere: the reference kernel's cum_t / cum_s underflows once a chunk's
//    product of decays falls below about 1e-37, and this kernel has nothing
//    that can.
//  * Time is staged a tile of 8 to 32 steps at a time (as long as the block's
//    share of shared memory, at the occupancy its registers allow, holds it:
//    the four-row kernel takes 128 registers a thread): a, the block's x
//    columns, b and c go to shared memory as f32 (bf16 inputs are widened
//    there, 4 values a load, so mixed dtypes cost no extra pass), outputs
//    collect in shared memory and leave as contiguous rows.  A ragged last
//    tile (any L) is masked; N is zero-padded to R*16 and rows past P idle.
//    P = 1 (mLSTM's normaliser) is a tile of one live row.
//
// What bounds it on an H100: 5*P*N f32 operations per (bh, step) against
// (P + 2N) inputs and P outputs, so at P = N = 64 and above it is the f32
// FMA pipe (67 TFLOP/s), not memory.  Known costs of this first version:
// synchronous tile loads (no cp.async / TMA double buffering), one decay
// multiply per state entry per step, and zamba2's b and c arrive
// materialised 64-fold across heads (`repeat_interleave` in
// `models/layers.apply_mamba`), so each block reads its own copy where a
// head-group stride would read one.  Long sequences at batch 1 have only BH
// blocks of parallel work (64 for zamba2), and the normaliser (P = 1) reads
// 2N values a step for one row: it is bound by its loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NS = 16;        // state entries per thread and row
constexpr int NT = 256;       // most threads a block has
constexpr int MAX_N = 32 * NS;
constexpr int SMEM_PER_SM = 232448;

struct Args {
    const void* x;
    const float* a;
    const void* b;
    const void* c;
    float* y;
    int BH, L, P, N;
    int x_bf16, b_bf16, c_bf16;
    int b_vec, c_vec;   // 1: N % 4 == 0 and aligned, so staging loads 4 values at once
    int lg_r;           // log2 of R, threads per state row
    int lg_tr;          // log2 of the block's thread rows (each holds RT state rows)
    int t_tile;         // time steps staged at once
    int p_tiles;        // ceil(P / rows per block)
};

__device__ __forceinline__ float load_f32(const void* p, long long i, int is_bf16) {
    return is_bf16 ? __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i])
                   : reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ float4 load4_f32(const void* p, long long i, int is_bf16) {
    if (is_bf16) {
        const uint2 u = *reinterpret_cast<const uint2*>(
            reinterpret_cast<const __nv_bfloat16*>(p) + i);
        const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
        const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
        const float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
        return make_float4(l.x, l.y, h.x, h.y);
    }
    return *reinterpret_cast<const float4*>(reinterpret_cast<const float*>(p) + i);
}

// rows [t0, t0 + tl) of a (L, N) slab starting at `base` into dst[T][npad] as
// f32, zero beyond tl and N
__device__ __forceinline__ void stage_bc(float* dst, const void* src, long long base, int is_bf16,
                                         int vec, int t0, int tl, int T, int N, int npad,
                                         int tid, int nt) {
    if (vec) {
        const int q_row = npad >> 2;
        for (int i = tid; i < T * q_row; i += nt) {
            const int tt = i / q_row, n = (i - tt * q_row) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (tt < tl && n < N) v = load4_f32(src, base + (long long)(t0 + tt) * N + n, is_bf16);
            *reinterpret_cast<float4*>(dst + tt * npad + n) = v;
        }
    } else {
        for (int i = tid; i < T * npad; i += nt) {
            const int tt = i / npad, n = i - tt * npad;
            dst[i] = (tt < tl && n < N) ? load_f32(src, base + (long long)(t0 + tt) * N + n, is_bf16)
                                        : 0.f;
        }
    }
}

template <int RT>
__global__ void __launch_bounds__(NT)
ssm_scan_kernel(const Args A) {
    const int R = 1 << A.lg_r;
    const int RB = RT << A.lg_tr;                // state rows per block
    const int npad = R * NS;                     // padded state width
    const int T = A.t_tile;
    extern __shared__ __align__(16) float smem[];
    float* b_s = smem;                  // [T][npad]
    float* c_s = b_s + T * npad;        // [T][npad]
    float* x_s = c_s + T * npad;        // [T][RB]
    float* y_s = x_s + T * RB;          // [T][RB]
    float* a_s = y_s + T * RB;          // [T]

    const int tid = threadIdx.x, nt = blockDim.x;
    const int row0 = (tid >> A.lg_r) * RT;   // this thread's first state row in the block
    const int part = tid & (R - 1);          // its share of those rows
    const int bh = blockIdx.x / A.p_tiles;
    const int p0 = (blockIdx.x % A.p_tiles) * RB;
    const int rows = min(RB, A.P - p0);
    const int L = A.L, P = A.P, N = A.N;

    const long long xo = (long long)bh * L * P;
    const long long bo = (long long)bh * L * N;
    const float* __restrict__ a = A.a + (long long)bh * L;
    float* __restrict__ y = A.y + xo;

    // thread `part` owns float4 groups part, part + R, part + 2R, ... of each
    // row, so at each step the R parts read neighbouring 16-byte words
    float S[RT][NS];
#pragma unroll
    for (int r = 0; r < RT; ++r)
#pragma unroll
        for (int j = 0; j < NS; ++j) S[r][j] = 0.f;

    for (int t0 = 0; t0 < L; t0 += T) {
        const int tl = min(T, L - t0);
        stage_bc(b_s, A.b, bo, A.b_bf16, A.b_vec, t0, tl, T, N, npad, tid, nt);
        stage_bc(c_s, A.c, bo, A.c_bf16, A.c_vec, t0, tl, T, N, npad, tid, nt);
        for (int i = tid; i < T * RB; i += nt) {
            const int tt = i / RB, r = i - tt * RB;
            x_s[i] = (tt < tl && r < rows)
                         ? load_f32(A.x, xo + (long long)(t0 + tt) * P + p0 + r, A.x_bf16)
                         : 0.f;
        }
        for (int i = tid; i < T; i += nt) a_s[i] = i < tl ? a[t0 + i] : 0.f;
        __syncthreads();

        for (int tt = 0; tt < tl; ++tt) {
            const float at = a_s[tt];
            float xt[RT];
            if constexpr (RT == 4) {
                const float4 xv = *reinterpret_cast<const float4*>(x_s + tt * RB + row0);
                xt[0] = xv.x; xt[1] = xv.y; xt[2] = xv.z; xt[3] = xv.w;
            } else {
#pragma unroll
                for (int r = 0; r < RT; ++r) xt[r] = x_s[tt * RB + row0 + r];
            }
            const float4* b4 = reinterpret_cast<const float4*>(b_s + tt * npad);
            const float4* c4 = reinterpret_cast<const float4*>(c_s + tt * npad);
            float acc[RT][2];
#pragma unroll
            for (int r = 0; r < RT; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll
            for (int q = 0; q < NS / 4; ++q) {
                const float4 bv = b4[q * R + part];
                const float4 cv = c4[q * R + part];
#pragma unroll
                for (int r = 0; r < RT; ++r) {
                    S[r][4 * q + 0] = fmaf(xt[r], bv.x, at * S[r][4 * q + 0]);
                    S[r][4 * q + 1] = fmaf(xt[r], bv.y, at * S[r][4 * q + 1]);
                    S[r][4 * q + 2] = fmaf(xt[r], bv.z, at * S[r][4 * q + 2]);
                    S[r][4 * q + 3] = fmaf(xt[r], bv.w, at * S[r][4 * q + 3]);
                    acc[r][0] = fmaf(S[r][4 * q + 0], cv.x, acc[r][0]);
                    acc[r][1] = fmaf(S[r][4 * q + 1], cv.y, acc[r][1]);
                    acc[r][0] = fmaf(S[r][4 * q + 2], cv.z, acc[r][0]);
                    acc[r][1] = fmaf(S[r][4 * q + 3], cv.w, acc[r][1]);
                }
            }
            float sum[RT];
#pragma unroll
            for (int r = 0; r < RT; ++r) sum[r] = acc[r][0] + acc[r][1];
            // blocks are whole warps and a row's R lanes are aligned inside one
            for (int off = R >> 1; off > 0; off >>= 1)
#pragma unroll
                for (int r = 0; r < RT; ++r) sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
            if (part == 0) {
                if constexpr (RT == 4)
                    *reinterpret_cast<float4*>(y_s + tt * RB + row0) =
                        make_float4(sum[0], sum[1], sum[2], sum[3]);
                else
#pragma unroll
                    for (int r = 0; r < RT; ++r) y_s[tt * RB + row0 + r] = sum[r];
            }
        }
        __syncthreads();

        for (int i = tid; i < tl * RB; i += nt) {
            const int tt = i / RB, r = i - tt * RB;
            if (r < rows) y[(long long)(t0 + tt) * P + p0 + r] = y_s[i];
        }
        // the next tile's staging writes b_s, c_s, x_s and a_s only; y_s is
        // written again after the barrier that follows it
    }
}

int log2_ceil(int v) {
    int lg = 0;
    while ((1 << lg) < v) ++lg;
    return lg;
}

bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) % a) == 0; }

template <int RT>
int launch(Args args, cudaStream_t stream) {
    const int R = 1 << args.lg_r;
    int lg_tr = log2_ceil(NT / R);                        // 256 threads ...
    const int need = (args.P + RT - 1) / RT;
    if (need < (1 << lg_tr)) {                            // ... unless P is small:
        lg_tr = log2_ceil(need);                          // whole warps still
        while ((R << lg_tr) < 32) ++lg_tr;
    }
    const int threads = R << lg_tr, RB = RT << lg_tr, npad = R * NS;
    args.lg_tr = lg_tr;
    args.p_tiles = (args.P + RB - 1) / RB;
    const long long blocks = (long long)args.BH * args.p_tiles;
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    // the longest time tile (at least 8 steps) whose shared memory still lets
    // the SM hold as many blocks as the kernel's registers allow
    static const int regs = [] {
        cudaFuncAttributes fa{};
        cudaFuncGetAttributes(&fa, ssm_scan_kernel<RT>);
        return fa.numRegs > 0 ? fa.numRegs : 255;
    }();
    const int resident = std::min(2048, 65536 / (regs * threads) * threads);
    const size_t share = (size_t)SMEM_PER_SM * threads / std::max(resident, threads);
    int T = 32;
    auto smem_of = [&](int t) { return sizeof(float) * (size_t)(2 * t * npad + 2 * t * RB + t); };
    while (T > 8 && smem_of(T) > share) T >>= 1;
    args.t_tile = T;
    const size_t smem = smem_of(T);
    // above 48 KB of dynamic shared memory a kernel has to opt in
    cudaError_t e = cudaFuncSetAttribute(ssm_scan_kernel<RT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    ssm_scan_kernel<RT><<<(unsigned)blocks, threads, smem, stream>>>(args);
    return (int)cudaGetLastError();
}

}  // namespace

// x_bf16, b_bf16, c_bf16: 1 when that input holds bf16, 0 when f32; a is f32.
// All inputs contiguous.  Returns cudaGetLastError() (or the error of a
// refused configuration: N above 512, a grid above 2^31 - 1 blocks).
extern "C" int ssm_scan_launch(const void* x, const void* a, const void* b, const void* c,
                               void* y, int BH, int L, int P, int N, int x_bf16, int b_bf16,
                               int c_bf16, void* stream) {
    if (BH <= 0 || L <= 0 || P <= 0 || N <= 0 || N > MAX_N) return (int)cudaErrorInvalidValue;
    Args args{x, (const float*)a, b, c, (float*)y, BH, L, P, N, x_bf16, b_bf16, c_bf16,
              /*b_vec=*/(N % 4 == 0) && aligned(b, b_bf16 ? 8 : 16),
              /*c_vec=*/(N % 4 == 0) && aligned(c, c_bf16 ? 8 : 16),
              /*lg_r=*/log2_ceil((N + NS - 1) / NS), /*lg_tr=*/0, /*t_tile=*/0, /*p_tiles=*/0};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    // four rows a thread only when that still leaves a full wave of threads
    // on every SM; short, narrow scans (zamba2 at batch 1) need the threads
    int dev = 0, sms = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const long long one_row_threads = (long long)BH * P * (1 << args.lg_r);
    return (P >= 16 && one_row_threads >= 4LL * sms * 2048) ? launch<4>(args, st)
                                                            : launch<1>(args, st);
}
