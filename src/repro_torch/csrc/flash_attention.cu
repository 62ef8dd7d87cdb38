// flash_attention: forward online-softmax attention with GQA, causal and
// sliding-window masks and a query offset.
//   q (B,Hq,Sq,D), k,v (B,Hk,Sk,D), bf16 or f32  ->  out (B,Hq,Sq,D) f32
//
// Replaces the TPU kernel `flash_attention` (body `_attn_kernel`) of
// src/repro/kernels/flash_attention.py.  There the grid's third axis walks
// the KV blocks in order with (m, l, acc) in VMEM scratch; here one thread
// block owns 64 query rows of one (batch, q head) and loops over 64-row KV
// tiles itself, with m and l in registers and the score tile in shared
// memory, so neither the (Sq,Sk) scores nor the probabilities ever reach
// device memory.  GQA is by index (kv head = q head / (Hq/Hk)): K and V are
// never repeated in memory.  The inputs are addressed through their strides,
// so the (B,S,H,D) layout the model produces is read without a copy.
//
// What bounds it on an H100: 4*Sq*Sk*D operations per head against
// (Sq+2*Sk)*D inputs, so for any prompt longer than a few hundred tokens the
// bound is operations.  Two kernels share the structure above:
//
//  * `attn_kernel` (f32 inputs, and bf16 inputs whose strides or alignment
//    the other kernel does not take) does both products with f32 FMAs:
//    exact enough for f32 inputs at 2e-5, which a TF32 or bf16 tensor-core
//    product is not.  256 threads, each a 4x4 piece of the score tile.
//  * `attn_kernel_tc` (bf16 inputs) runs both products on the tensor cores
//    (`mma.sync` m16n8k16, f32 accumulation): four warps of 16 query rows;
//    S = Q K^T straight from the bf16 tiles in shared memory, softmax in f32
//    registers, and the probabilities, rounded to bf16, go from the score
//    accumulators into the A operand of P V without touching memory.
//
// In both, KV tiles that lie wholly outside the causal / window band are
// skipped, which halves the work of a causal prompt.  Not done yet: loads
// are synchronous (no cp.async/TMA ring), and there is no wgmma.
//
// Skipping is only valid when no query row is masked everywhere: such a row
// yields, in the reference kernel and in `attention_ref` alike, the plain
// average of V over all keys (m stays -1e30 and p = exp(0)), which needs
// every tile.  A fully masked row cannot arise when q_offset + Sq <= Sk; the
// wrapper passes skip = 0 otherwise and the kernel then visits every tile and
// reproduces that average.  Ragged edges are masked here: query rows past Sq
// are not stored, keys past Sk get probability exactly 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // keys per tile
constexpr int NT = 256;   // threads: 16 row groups (ty) x 16 column groups (tx)
constexpr int PAD = 4;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

struct Strides { long long b, h, s; };   // in elements; the last dim has stride 1

struct Args {
    const void *q, *k, *v;
    float* out;
    int B, Hq, Hk, Sq, Sk;
    Strides qs, ks, vs;
    float scale;
    int causal, window, q_offset;
    int skip;    // 1: KV tiles outside the mask's band may be skipped
};

// KV range [begin, end) a block of query rows [q0, q0+BQ) has to visit
__device__ __forceinline__ void kv_range(const Args& a, int q0, int bq, int bkv,
                                         int& kv_begin, int& kv_end) {
    kv_begin = 0;
    kv_end = a.Sk;
    if (!a.skip) return;
    const int q_lo = a.q_offset + q0;
    const int q_hi = a.q_offset + min(q0 + bq, a.Sq) - 1;
    if (a.causal) kv_end = min(a.Sk, q_hi + 1);
    if (a.window > 0) {
        const int lo = q_lo - a.window + 1;
        if (lo > 0) kv_begin = (lo / bkv) * bkv;
    }
}

__device__ __forceinline__ bool visible(const Args& a, int q_pos, int k_pos) {
    bool keep = true;
    if (a.causal) keep = keep && (k_pos <= q_pos);
    if (a.window > 0) keep = keep && (k_pos > q_pos - a.window);
    return keep;
}

template <int D>
constexpr size_t smem_bytes() {
    return sizeof(float) * (size_t)(D * (BQ + PAD) + D * (BKV + PAD) + BKV * D + BQ * (BKV + PAD));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
attn_kernel(const Args a) {
    const int Hq = a.Hq, Hk = a.Hk, Sq = a.Sq, Sk = a.Sk, q_offset = a.q_offset;
    const Strides qs = a.qs, ks = a.ks, vs = a.vs;
    const float scale = a.scale;
    float* __restrict__ out = a.out;
    constexpr int VW = D >= 64 ? 4 : D / 16;   // output columns per thread and chunk
    constexpr int NV = D / (16 * VW);          // chunks: thread tx owns cols c*16*VW + tx*VW ..
    constexpr int QS = BQ + PAD, KS = BKV + PAD, PS = BKV + PAD;

    extern __shared__ __align__(16) float smem[];
    float* Qt = smem;                 // [D][QS]   q * scale, transposed
    float* Kt = Qt + D * QS;          // [D][KS]   k tile, transposed
    float* Vs = Kt + D * KS;          // [BKV][D]
    float* Ps = Vs + BKV * D;         // [BQ][PS]  probabilities of this tile

    const int tid = threadIdx.x;
    const int tx = tid % 16, ty = tid / 16;
    const int n_qt = (Sq + BQ - 1) / BQ;
    const int bh = blockIdx.x / n_qt;
    const int q0 = (blockIdx.x % n_qt) * BQ;
    const int b = bh / Hq, h = bh % Hq;
    const int hk = h / (Hq / Hk);

    const T* __restrict__ qp = (const T*)a.q + (size_t)b * qs.b + (size_t)h * qs.h;
    const T* __restrict__ kp = (const T*)a.k + (size_t)b * ks.b + (size_t)hk * ks.h;
    const T* __restrict__ vp = (const T*)a.v + (size_t)b * vs.b + (size_t)hk * vs.h;

    for (int idx = tid; idx < BQ * D; idx += NT) {
        const int r = idx / D, d = idx % D;
        float val = 0.f;
        if (q0 + r < Sq) val = to_f32(qp[(size_t)(q0 + r) * qs.s + d]) * scale;
        Qt[d * QS + r] = val;
    }

    float m[4], l[4], acc[4][NV][VW];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = NEG_INF;
        l[i] = 0.f;
#pragma unroll
        for (int c = 0; c < NV; ++c)
#pragma unroll
            for (int e = 0; e < VW; ++e) acc[i][c][e] = 0.f;
    }

    // KV range of this block: every tile, or only those that meet the band
    int kv_begin, kv_end;
    kv_range(a, q0, BQ, BKV, kv_begin, kv_end);

    for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
        __syncthreads();   // the previous tile's readers are done (and Qt is written)
        for (int idx = tid; idx < BKV * D; idx += NT) {
            const int r = idx / D, d = idx % D;
            float kval = 0.f, vval = 0.f;
            if (kv0 + r < Sk) {
                kval = to_f32(kp[(size_t)(kv0 + r) * ks.s + d]);
                vval = to_f32(vp[(size_t)(kv0 + r) * vs.s + d]);
            }
            Kt[d * KS + r] = kval;
            Vs[r * D + d] = vval;
        }
        __syncthreads();

        // scores: rows ty*4.., keys tx*4..
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) {
            const float4 a4 = *reinterpret_cast<const float4*>(&Qt[d * QS + ty * 4]);
            const float4 b4 = *reinterpret_cast<const float4*>(&Kt[d * KS + tx * 4]);
            const float a[4] = {a4.x, a4.y, a4.z, a4.w};
            const float bb[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bb[j], s[i][j]);
        }

        // mask, online softmax; the 16 threads that share ty share these rows
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int q_pos = q_offset + q0 + ty * 4 + i;
            float row_max = NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k_pos = kv0 + tx * 4 + j;
                if (!visible(a, q_pos, k_pos)) s[i][j] = NEG_INF;
                if (k_pos < Sk) row_max = fmaxf(row_max, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off, 16));
            const float m_new = fmaxf(m[i], row_max);
            const float alpha = expf(m[i] - m_new);
            float row_sum = 0.f;
            float p[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k_pos = kv0 + tx * 4 + j;
                p[j] = (k_pos < Sk) ? expf(s[i][j] - m_new) : 0.f;
                row_sum += p[j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off, 16);
            l[i] = l[i] * alpha + row_sum;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < NV; ++c)
#pragma unroll
                for (int e = 0; e < VW; ++e) acc[i][c][e] *= alpha;
            *reinterpret_cast<float4*>(&Ps[(ty * 4 + i) * PS + tx * 4]) =
                make_float4(p[0], p[1], p[2], p[3]);
        }
        __syncthreads();

        // acc += P @ V
#pragma unroll 4
        for (int c = 0; c < BKV; ++c) {
            float pv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * PS + c];
#pragma unroll
            for (int ch = 0; ch < NV; ++ch) {
                float vv[VW];
                const float* src = &Vs[c * D + ch * 16 * VW + tx * VW];
                if constexpr (VW == 4) {
                    const float4 t = *reinterpret_cast<const float4*>(src);
                    vv[0] = t.x; vv[1] = t.y; vv[2] = t.z; vv[3] = t.w;
                } else {
#pragma unroll
                    for (int e = 0; e < VW; ++e) vv[e] = src[e];
                }
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int e = 0; e < VW; ++e) acc[i][ch][e] = fmaf(pv[i], vv[e], acc[i][ch][e]);
            }
        }
    }

    float* op = out + ((size_t)bh * Sq) * D;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty * 4 + i;
        if (row >= Sq) continue;
        const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int ch = 0; ch < NV; ++ch)
#pragma unroll
            for (int e = 0; e < VW; ++e)
                op[(size_t)row * D + ch * 16 * VW + tx * VW + e] = acc[i][ch][e] * inv;
    }
}

// ---- bf16 inputs on the tensor cores ----------------------------------------

constexpr int TNT = 128;   // 4 warps, 16 query rows each

template <int D>
constexpr size_t smem_bytes_tc() { return sizeof(__nv_bfloat16) * (size_t)(3 * BQ * (D + 8)); }

// One (rows x D) bf16 tile from global (row stride `rs` elements, 16-byte
// aligned rows) into shared memory with row pitch D+8; rows past `n_valid` are zero.
template <int D>
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                               long long rs, int row0, int n_valid, int tid) {
    constexpr int VPR = D / 8;   // 16-byte vectors per row
    for (int idx = tid; idx < BQ * VPR; idx += TNT) {
        const int r = idx / VPR, c = (idx % VPR) * 8;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (row0 + r < n_valid)
            val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * rs + c);
        *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = val;
    }
}

// Needs q, k, v 16-byte aligned and every stride a multiple of 8 elements.
template <int D>
__global__ void __launch_bounds__(TNT)
attn_kernel_tc(const Args a) {
    static_assert(BQ == 64 && BKV == 64, "tile loads and fragment loops assume 64 x 64");
    constexpr int LD = D + 8;        // bf16 row pitch: ldmatrix rows hit distinct banks
    constexpr int NKT = BKV / 8;     // score n-tiles (8 keys each) per warp row block
    constexpr int NDT = D / 8;       // output n-tiles (8 columns each)

    extern __shared__ __align__(16) unsigned char smem_raw[];
    __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // [BQ][LD]
    __nv_bfloat16* Ks = Qs + BQ * LD;                                 // [BKV][LD]
    __nv_bfloat16* Vs = Ks + BKV * LD;                                // [BKV][LD]

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int n_qt = (a.Sq + BQ - 1) / BQ;
    const int bh = blockIdx.x / n_qt;
    const int q0 = (blockIdx.x % n_qt) * BQ;
    const int b = bh / a.Hq, h = bh % a.Hq;
    const int hk = h / (a.Hq / a.Hk);
    const int Sk = a.Sk;

    const __nv_bfloat16* qp = (const __nv_bfloat16*)a.q + (size_t)b * a.qs.b + (size_t)h * a.qs.h;
    const __nv_bfloat16* kp = (const __nv_bfloat16*)a.k + (size_t)b * a.ks.b + (size_t)hk * a.ks.h;
    const __nv_bfloat16* vp = (const __nv_bfloat16*)a.v + (size_t)b * a.vs.b + (size_t)hk * a.vs.h;

    load_tile_bf16<D>(Qs, qp, a.qs.s, q0, a.Sq, tid);

    // this thread's two rows: warp*16 + g and + 8
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's share of the row sum
    float o[NDT][4];
#pragma unroll
    for (int n = 0; n < NDT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

    int kv_begin, kv_end;
    kv_range(a, q0, BQ, BKV, kv_begin, kv_end);

    for (int kv0 = kv_begin; kv0 < kv_end; kv0 += BKV) {
        __syncthreads();   // the previous tile's readers are done
        load_tile_bf16<D>(Ks, kp, a.ks.s, kv0, Sk, tid);
        load_tile_bf16<D>(Vs, vp, a.vs.s, kv0, Sk, tid);
        __syncthreads();

        // S = Q K^T for this warp's 16 rows
        float s[NKT][4];
#pragma unroll
        for (int n = 0; n < NKT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int dk = 0; dk < D; dk += 16) {
            uint32_t qa[4];
            ldmatrix_x4(qa, Qs + (warp * 16 + (lane % 16)) * LD + dk + (lane / 16) * 8);
#pragma unroll
            for (int np = 0; np < NKT / 2; ++np) {
                uint32_t r[4];   // K is [key][d]: already the "col" operand, no transpose
                ldmatrix_x4(r, Ks + (np * 16 + (lane % 8) + 8 * (lane / 16)) * LD
                                   + dk + 8 * ((lane / 8) % 2));
                mma_bf16(s[2 * np], qa, r[0], r[1]);
                mma_bf16(s[2 * np + 1], qa, r[2], r[3]);
            }
        }

        // scale, mask, online softmax (rows g and g+8 of this warp's block)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int q_pos = a.q_offset + q0 + warp * 16 + g + half * 8;
            float row_max = NEG_INF;
#pragma unroll
            for (int n = 0; n < NKT; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k_pos = kv0 + n * 8 + 2 * t + e;
                    float val = s[n][half * 2 + e] * a.scale;
                    if (!visible(a, q_pos, k_pos)) val = NEG_INF;
                    s[n][half * 2 + e] = val;
                    if (k_pos < Sk) row_max = fmaxf(row_max, val);
                }
            row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
            row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
            const float m_new = fmaxf(m[half], row_max);
            const float alpha = expf(m[half] - m_new);
            float part = 0.f;
#pragma unroll
            for (int n = 0; n < NKT; ++n)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int k_pos = kv0 + n * 8 + 2 * t + e;
                    const float p = (k_pos < Sk) ? expf(s[n][half * 2 + e] - m_new) : 0.f;
                    s[n][half * 2 + e] = p;
                    part += p;
                }
            l[half] = l[half] * alpha + part;
            m[half] = m_new;
#pragma unroll
            for (int n = 0; n < NDT; ++n) {
                o[n][half * 2] *= alpha;
                o[n][half * 2 + 1] *= alpha;
            }
        }

        // O += P V: the score accumulators, as bf16, are the A operand
#pragma unroll
        for (int ks = 0; ks < BKV / 16; ++ks) {
            uint32_t pa[4];
            pa[0] = pack_bf16(s[2 * ks][0], s[2 * ks][1]);
            pa[1] = pack_bf16(s[2 * ks][2], s[2 * ks][3]);
            pa[2] = pack_bf16(s[2 * ks + 1][0], s[2 * ks + 1][1]);
            pa[3] = pack_bf16(s[2 * ks + 1][2], s[2 * ks + 1][3]);
#pragma unroll
            for (int dp = 0; dp < NDT / 2; ++dp) {
                uint32_t r[4];   // V is [key][d] = [k][n]: transpose on load
                ldmatrix_x4_trans(r, Vs + (ks * 16 + (lane % 8) + 8 * ((lane / 8) % 2)) * LD
                                         + dp * 16 + 8 * (lane / 16));
                mma_bf16(o[2 * dp], pa, r[0], r[1]);
                mma_bf16(o[2 * dp + 1], pa, r[2], r[3]);
            }
        }
    }

    float* op = a.out + ((size_t)bh * a.Sq) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float sum = l[half];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        const int row = q0 + warp * 16 + g + half * 8;
        if (row >= a.Sq) continue;
        const float inv = 1.f / fmaxf(sum, 1e-30f);
#pragma unroll
        for (int n = 0; n < NDT; ++n)
            *reinterpret_cast<float2*>(op + (size_t)row * D + n * 8 + 2 * t) =
                make_float2(o[n][half * 2] * inv, o[n][half * 2 + 1] * inv);
    }
}

// ---- launch ----------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }
inline bool mult8(const Strides& s) { return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0; }

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const Args& a, cudaStream_t stream) {
    // above 48 KB of dynamic shared memory a kernel has to opt in
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    const long long blocks = (long long)a.B * a.Hq * ((a.Sq + BQ - 1) / BQ);
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <int D>
int dispatch(const Args& a, bool is_bf16, bool tensor_cores, cudaStream_t st) {
    if (!is_bf16) return launch(attn_kernel<float, D>, smem_bytes<D>(), NT, a, st);
    if (tensor_cores && aligned16(a.q) && aligned16(a.k) && aligned16(a.v) && mult8(a.qs) &&
        mult8(a.ks) && mult8(a.vs))
        return launch(attn_kernel_tc<D>, smem_bytes_tc<D>(), TNT, a, st);
    return launch(attn_kernel<__nv_bfloat16, D>, smem_bytes<D>(), NT, a, st);
}

}  // namespace

// strides: nine element strides, (batch, head, seq) of q, then k, then v.
// is_bf16: 1 when q, k, v hold bf16, 0 when f32.  tensor_cores: 0 keeps bf16 inputs on
// the f32 FMA kernel too.  Returns cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hk, int Sq, int Sk, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int q_offset, int skip, int is_bf16,
                                      int tensor_cores, void* stream) {
    if (B <= 0 || Hq <= 0 || Hk <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hk != 0)
        return (int)cudaErrorInvalidValue;
    const Args a{q, k, v, (float*)out, B, Hq, Hk, Sq, Sk,
                 Strides{strides[0], strides[1], strides[2]},
                 Strides{strides[3], strides[4], strides[5]},
                 Strides{strides[6], strides[7], strides[8]},
                 scale, causal, window, q_offset, skip};
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    const bool bf = is_bf16 != 0, tc = tensor_cores != 0;
    switch (D) {
        case 16:  return dispatch<16>(a, bf, tc, st);
        case 32:  return dispatch<32>(a, bf, tc, st);
        case 64:  return dispatch<64>(a, bf, tc, st);
        case 128: return dispatch<128>(a, bf, tc, st);
        default:  return (int)cudaErrorInvalidValue;
    }
}
