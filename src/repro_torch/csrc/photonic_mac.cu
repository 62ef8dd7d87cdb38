// photonic_mac: out (M,N) f32 = x (M,K) bf16|f32 @ (w_q (K,N) int8 * scale[K/128, N/128]).
//
// Replaces the TPU kernel `photonic_mac` (body `_mac_kernel`) of
// src/repro/kernels/photonic_mac.py.  There the grid's third axis walks K in
// order and carries an f32 accumulator in VMEM; here one thread block owns a
// 64x64 output tile and loops over K itself, 32 deep per step.  The scale of
// a 128x128 weight bank changes with every K bank, so it cannot be hoisted
// out of the loop.  Two kernels share that shape:
//
//  * `mac_kernel` (f32 activations, and bf16 activations whose shape or
//    alignment the tensor-core kernel does not take): every step dequantises
//    its int8 tile into shared memory, exactly `w_q.astype(f32) * scale` as
//    the reference does, and accumulates with f32 FMAs in registers.  The
//    reference multiplies in true f32, which the tensor cores cannot (TF32
//    keeps 10 mantissa bits).
//  * `mac_kernel_tc` (bf16 activations): int8 levels are exact in bf16, so
//    the tile is converted, not dequantised, and `mma.sync` m16n8k16 forms
//    the exact products x*level and sums them in f32 into a per-bank partial
//    sum; at the end of each 128-deep bank the partial sum is folded in as
//    acc = fma(scale, partial, acc).  That is the reference's sum with
//    other rounding (one multiply by the scale per bank instead of per
//    weight).  Global loads of step t+1 are issued before the products of
//    step t and land in the other of two shared-memory buffers.
//
// What bounds it on an H100: at the serving shapes (M = 128..512 rows against
// 4096..64000-wide weights) the card's least time is set by the bytes at
// M = 128 (int8 weights read once) and by the operations from M = 512 on.
// Neither kernel is near it yet: the FMA kernel is held by the f32 pipe, the
// tensor-core kernel by its synchronous loads (no cp.async/TMA ring, no
// wgmma) and by the int8->bf16 conversion on the way into shared memory.
// The 64x64 tile keeps >= 128 blocks in flight for N = 4096 at M = 128.
//
// The K order of every output element is fixed by the kernel, not by M, so
// rows are bit-identical with and without extra rows below them.  Ragged M,
// K and N are masked here: out-of-range loads give 0, out-of-range stores
// are dropped.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BM = 64;    // output rows per block
constexpr int BN = 64;    // output columns per block (divides the 128-wide bank)
constexpr int BK = 32;    // K depth per step (divides the 128-deep bank)
constexpr int NT = 256;   // threads: 16 x 16, each a 4 x 4 micro-tile
constexpr int BANK = 128; // weight-bank tile edge of the scale grid
constexpr int PAD = 4;

// ---- activation tile: As[k][m] = x[m0+m][k0+k] as f32 --------------------

template <bool VEC>
__device__ __forceinline__ void load_a(const float* __restrict__ x, float (*As)[BM + PAD],
                                       int m0, int k0, int M, int K, int tid) {
    if (VEC) {  // K % 4 == 0 and x 16-byte aligned: one float4 is wholly in or out
#pragma unroll
        for (int i = 0; i < (BM * BK / 4) / NT; ++i) {
            int idx = tid + i * NT;
            int row = idx / (BK / 4), kv = (idx % (BK / 4)) * 4;
            float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
            if (m0 + row < M && k0 + kv < K)
                v = *reinterpret_cast<const float4*>(x + (size_t)(m0 + row) * K + k0 + kv);
            As[kv + 0][row] = v.x; As[kv + 1][row] = v.y;
            As[kv + 2][row] = v.z; As[kv + 3][row] = v.w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < (BM * BK) / NT; ++i) {
            int idx = tid + i * NT;
            int row = idx / BK, kk = idx % BK;
            float v = 0.f;
            if (m0 + row < M && k0 + kk < K) v = x[(size_t)(m0 + row) * K + k0 + kk];
            As[kk][row] = v;
        }
    }
}

template <bool VEC>
__device__ __forceinline__ void load_a(const __nv_bfloat16* __restrict__ x,
                                       float (*As)[BM + PAD],
                                       int m0, int k0, int M, int K, int tid) {
    if (VEC) {  // K % 8 == 0 and x 16-byte aligned: 8 bf16 per load
        static_assert((BM * BK / 8) == NT, "one 8-wide vector per thread");
        int row = tid / (BK / 8), kv = (tid % (BK / 8)) * 8;
        uint4 raw = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + row < M && k0 + kv < K)
            raw = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * K + k0 + kv);
        const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) As[kv + j][row] = __bfloat162float(h[j]);
    } else {
#pragma unroll
        for (int i = 0; i < (BM * BK) / NT; ++i) {
            int idx = tid + i * NT;
            int row = idx / BK, kk = idx % BK;
            float v = 0.f;
            if (m0 + row < M && k0 + kk < K)
                v = __bfloat162float(x[(size_t)(m0 + row) * K + k0 + kk]);
            As[kk][row] = v;
        }
    }
}

// ---- weight tile: Bs[k][n] = float(w_q[k0+k][n0+n]) * s -------------------

template <bool VEC>
__device__ __forceinline__ void load_b(const int8_t* __restrict__ wq, float (*Bs)[BN + PAD],
                                       float s, int k0, int n0, int K, int N, int tid) {
    if (VEC) {  // N % 4 == 0 and w_q 4-byte aligned: 4 levels per load
#pragma unroll
        for (int i = 0; i < (BK * BN / 4) / NT; ++i) {
            int idx = tid + i * NT;
            int kr = idx / (BN / 4), nv = (idx % (BN / 4)) * 4;
            char4 c = make_char4(0, 0, 0, 0);
            if (k0 + kr < K && n0 + nv < N)
                c = *reinterpret_cast<const char4*>(wq + (size_t)(k0 + kr) * N + n0 + nv);
            float4 w = make_float4((float)c.x * s, (float)c.y * s, (float)c.z * s, (float)c.w * s);
            *reinterpret_cast<float4*>(&Bs[kr][nv]) = w;
        }
    } else {
#pragma unroll
        for (int i = 0; i < (BK * BN) / NT; ++i) {
            int idx = tid + i * NT;
            int kr = idx / BN, nn = idx % BN;
            float w = 0.f;
            if (k0 + kr < K && n0 + nn < N)
                w = (float)wq[(size_t)(k0 + kr) * N + n0 + nn] * s;
            Bs[kr][nn] = w;
        }
    }
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(NT)
mac_kernel(const T* __restrict__ x, const int8_t* __restrict__ wq,
           const float* __restrict__ scale, float* __restrict__ out,
           int M, int K, int N, int scale_cols) {
    __shared__ __align__(16) float As[BK][BM + PAD];
    __shared__ __align__(16) float Bs[BK][BN + PAD];

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int sj = n0 / BANK;

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
        const float s = scale[(size_t)(k0 / BANK) * scale_cols + sj];
        load_a<VEC>(x, As, m0, k0, M, K, tid);
        load_b<VEC>(wq, Bs, s, k0, n0, K, N, tid);
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
            const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
        __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        if (row >= M) continue;
        const int col = n0 + tx * 4;
        if (VEC) {  // N % 4 == 0 and out 16-byte aligned
            if (col < N)
                *reinterpret_cast<float4*>(out + (size_t)row * N + col) =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
        } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
                if (col + j < N) out[(size_t)row * N + col + j] = acc[i][j];
        }
    }
}


// ---- bf16 activations on the tensor cores -----------------------------------

constexpr int TNT = 128;          // 4 warps, 2 x 2, each a 32 x 32 warp tile
constexpr int A_LD = BK + 8;      // bf16 row pitch 80 B: ldmatrix rows hit distinct banks
constexpr int B_LD = BN + 8;      // bf16 row pitch 144 B

// Needs K % 8 == 0, N % 16 == 0, x and w_q 16-byte aligned, out 8-byte aligned.
__global__ void __launch_bounds__(TNT)
mac_kernel_tc(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int N, int scale_cols) {
    __shared__ __align__(16) __nv_bfloat16 As[2][BM][A_LD];   // [m][k]
    __shared__ __align__(16) __nv_bfloat16 Bs[2][BK][B_LD];   // [k][n], levels as bf16

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wm = warp / 2, wn = warp % 2;
    const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
    const int sj = n0 / BANK;

    float acc[2][4][4], part[2][4][4];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) { acc[mi][ni][e] = 0.f; part[mi][ni][e] = 0.f; }

    // this thread's share of a tile: two 8-wide bf16 vectors of x, 16 levels of w_q
    const int a_row[2] = {tid / 4, (tid + TNT) / 4};
    const int a_kv = (tid % 4) * 8;
    const int b_kr = tid / 4, b_nv = (tid % 4) * 16;
    uint4 ra[2], rb;

    auto gload = [&](int k0) {
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            ra[i] = make_uint4(0u, 0u, 0u, 0u);
            if (m0 + a_row[i] < M && k0 + a_kv < K)
                ra[i] = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + a_row[i]) * K + k0 + a_kv);
        }
        rb = make_uint4(0u, 0u, 0u, 0u);
        if (k0 + b_kr < K && n0 + b_nv < N)
            rb = *reinterpret_cast<const uint4*>(wq + (size_t)(k0 + b_kr) * N + n0 + b_nv);
    };
    auto sstore = [&](int buf) {
#pragma unroll
        for (int i = 0; i < 2; ++i)
            *reinterpret_cast<uint4*>(&As[buf][a_row[i]][a_kv]) = ra[i];
        const int8_t* c = reinterpret_cast<const int8_t*>(&rb);
        __align__(16) __nv_bfloat16 h[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) h[j] = __float2bfloat16((float)c[j]);   // exact
        *reinterpret_cast<uint4*>(&Bs[buf][b_kr][b_nv]) = *reinterpret_cast<const uint4*>(&h[0]);
        *reinterpret_cast<uint4*>(&Bs[buf][b_kr][b_nv + 8]) = *reinterpret_cast<const uint4*>(&h[8]);
    };

    const int steps = (K + BK - 1) / BK;
    gload(0);
    sstore(0);
    __syncthreads();

    for (int t = 0; t < steps; ++t) {
        const int buf = t & 1;
        if (t + 1 < steps) gload((t + 1) * BK);

#pragma unroll
        for (int kk = 0; kk < BK; kk += 16) {
            uint32_t a[2][4], b[4][2];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
                ldmatrix_x4(a[mi], &As[buf][wm * 32 + mi * 16 + (lane % 16)][kk + (lane / 16) * 8]);
#pragma unroll
            for (int nj = 0; nj < 2; ++nj) {
                uint32_t r[4];
                ldmatrix_x4_trans(r, &Bs[buf][kk + (lane % 8) + 8 * ((lane / 8) % 2)]
                                        [wn * 32 + nj * 16 + 8 * (lane / 16)]);
                b[nj * 2][0] = r[0]; b[nj * 2][1] = r[1];
                b[nj * 2 + 1][0] = r[2]; b[nj * 2 + 1][1] = r[3];
            }
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni) mma_bf16(part[mi][ni], a[mi], b[ni][0], b[ni][1]);
        }

        // end of a 128-deep weight bank (or of K): fold the partial sum in
        if (((t + 1) * BK) % BANK == 0 || t + 1 == steps) {
            const float s = scale[(size_t)((t * BK) / BANK) * scale_cols + sj];
#pragma unroll
            for (int mi = 0; mi < 2; ++mi)
#pragma unroll
                for (int ni = 0; ni < 4; ++ni)
#pragma unroll
                    for (int e = 0; e < 4; ++e) {
                        acc[mi][ni][e] = fmaf(s, part[mi][ni][e], acc[mi][ni][e]);
                        part[mi][ni][e] = 0.f;
                    }
        }

        if (t + 1 < steps) sstore(buf ^ 1);
        __syncthreads();
    }

#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
            const int col = n0 + wn * 32 + ni * 8 + 2 * (lane % 4);
            if (col >= N) continue;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int row = m0 + wm * 32 + mi * 16 + lane / 4 + half * 8;
                if (row < M)
                    *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
                        make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
            }
        }
}

inline bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) % a) == 0; }

template <typename T>
int launch(const void* x, const void* wq, const void* scale, void* out,
           int M, int K, int N, bool tensor_cores, cudaStream_t stream) {
    const int kvec = sizeof(T) == 2 ? 8 : 4;
    const bool vec = (K % kvec == 0) && (N % 4 == 0) && aligned(x, 16) && aligned(wq, 4) &&
                     aligned(out, 16);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const int scale_cols = (N + BANK - 1) / BANK;
    if (sizeof(T) == 2 && tensor_cores && (K % 8 == 0) && (N % 16 == 0) && aligned(x, 16) && aligned(wq, 16) &&
        aligned(out, 8)) {
        mac_kernel_tc<<<grid, TNT, 0, stream>>>(
            (const __nv_bfloat16*)x, (const int8_t*)wq, (const float*)scale, (float*)out,
            M, K, N, scale_cols);
        return (int)cudaGetLastError();
    }
    if (vec)
        mac_kernel<T, true><<<grid, NT, 0, stream>>>(
            (const T*)x, (const int8_t*)wq, (const float*)scale, (float*)out, M, K, N, scale_cols);
    else
        mac_kernel<T, false><<<grid, NT, 0, stream>>>(
            (const T*)x, (const int8_t*)wq, (const float*)scale, (float*)out, M, K, N, scale_cols);
    return (int)cudaGetLastError();
}

}  // namespace

// x_bf16: 1 when x holds bf16, 0 when f32.  tensor_cores: 0 keeps bf16 activations on
// the f32 FMA kernel too.  Returns cudaGetLastError().
extern "C" int photonic_mac_launch(const void* x, const void* wq, const void* scale, void* out,
                                   int M, int K, int N, int x_bf16, int tensor_cores,
                                   void* stream) {
    if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    return x_bf16 ? launch<__nv_bfloat16>(x, wq, scale, out, M, K, N, tensor_cores != 0, s)
                  : launch<float>(x, wq, scale, out, M, K, N, false, s);
}
