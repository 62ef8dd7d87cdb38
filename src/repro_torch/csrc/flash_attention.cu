// flash_attention: forward online-softmax attention with GQA, causal and
// sliding-window masks and a query offset.
//   q (B,Hq,Sq,D), k,v (B,Hk,Sk,D), bf16 or f32  ->  out (B,Hq,Sq,D) f32
//
// Replaces the TPU kernel `flash_attention` (body `_attn_kernel`) of
// src/repro/kernels/flash_attention.py.  There the grid's third axis walks
// the KV blocks in order with (m, l, acc) in VMEM scratch; here one thread
// block owns a tile of query rows of one (batch, q head) and loops over KV
// tiles itself, with m and l in registers, so neither the (Sq,Sk) scores nor
// the probabilities ever reach device memory.  GQA is by index (kv head = q
// head / (Hq/Hk)): K and V are never repeated in memory.  The inputs are
// addressed through their strides, so the (B,S,H,D) layout the model
// produces is read without a copy.
//
// What bounds it on an H100: 4*Sq*Sk*D operations per head against
// (Sq+2*Sk)*D inputs and Sq*D f32 outputs, so a short prompt (or a batch of
// them) is bound by bytes, and one longer than a few hundred tokens by
// operations.  Two kernels:
//
//  * `attn_kernel_sm90` (bf16 inputs, D = 64 or 128, 16-byte aligned storage
//    and strides that are multiples of 8: every attention of the serving
//    paths).  A block is one warpgroup and 64 query rows; two (D = 128) or
//    three (D = 64) blocks share an SM, and one block's softmax overlaps
//    another's products.  What the design does about each bound:
//      - bytes and latency: Q is copied once, K and V through rings of 3
//        (D = 128) or 2 slots of 64 keys each, by 16-byte cp.async in the
//        128-byte swizzle; a tile's copies are issued two or one tiles ahead
//        of its use, and every slot is filled at the start, so a prompt of
//        up to 128 keys waits for one round of copies.
//      - operations: both products run on `wgmma`.  S = Q K^T reads Q and
//        K from shared memory (both K-major); the softmax works in f32
//        registers on the product's fragment (exp2, with the scale and
//        log2(e) folded into one factor, maxima and sums as four chains),
//        and the probabilities, packed to bf16, are the register operand A
//        of O += P V, whose V tile ([key][d]) is read MN-major.  The next
//        tile's S = Q K^T is issued before this tile's softmax and runs
//        under it.
//      - causal work is uneven (a block visits 1 to Sq/64 tiles): the plan
//        puts the query tiles with the most KV tiles first in the grid.
//  * `attn_kernel` (f32 inputs, bf16 inputs the other kernel does not take,
//    and `tensor_cores=False`) does both products with f32 FMAs: exact
//    enough for f32 inputs at 2e-5, which a TF32 or bf16 tensor-core
//    product is not.  256 threads, each a 4x4 piece of a 64x64 score tile,
//    synchronous loads.
//
// In both, KV tiles that lie wholly outside the causal / window band are
// skipped, which halves the work of a causal prompt.
//
// Skipping is only valid when no query row is masked everywhere: such a row
// yields, in the reference kernel and in `attention_ref` alike, the plain
// average of V over all keys (masked scores are -1e30, not -inf: m stays
// -1e30 and p = exp(0)), which needs every tile.  The wrapper passes
// skip = 0 exactly when such a row exists (`attn_skip`), and the kernel then
// visits every tile and reproduces that average.  Ragged edges are masked
// here: query rows past Sq are not stored, keys past Sk (zero-filled by the
// copies, so their score is 0, not -1e30) get probability exactly 0.

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
    int skip;         // 1: KV tiles outside the mask's band may be skipped
    int heavy_first;  // attn_kernel_sm90: query tiles in the grid by decreasing work
};

// KV range [begin, end) a block of query rows [q0, q0+bq) has to visit
// (`attn_plan` in kernels/flash_attention.py mirrors it)
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

// ---- bf16 inputs on the tensor cores: attn_kernel_sm90 ----------------------

constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Sm90 {
    static constexpr int BQ = 64;                   // query rows per block: one warpgroup
    static constexpr int BKV = 64;                  // keys per tile
    static constexpr int NT = 128;
    // slots of the K ring and of the V ring: a copy has R - 1 tiles' time to
    // land (3 measured faster at D = 128, 2 at D = 64, where three blocks
    // an SM hide the copies and each ring slot costs shared memory)
    static constexpr int RING = D == 128 ? 3 : 2;
    static constexpr int Q_BYTES = BQ * D * 2;
    static constexpr int KV_BYTES = BKV * D * 2;    // one tile of K or of V
    // Q, then the K slots, then the V slots
    static constexpr int SMEM = Q_BYTES + 2 * RING * KV_BYTES + 1024;   // + room to align to 1024
    // blocks an SM must hold, which caps the registers a thread may use
    // (168 at D = 64, 255 at D = 128)
    static constexpr int MIN_BLOCKS = D == 64 ? 3 : 2;
    static_assert(D == 64 || D == 128, "one or two 64-wide panels");
    // an SM has 228 KB of shared memory, and keeps 1 KB of it for each block
    static_assert(MIN_BLOCKS * (SMEM + 1024) <= 228 * 1024, "the blocks fit an SM");
};

// Byte offset of 16-byte chunk c (of D/8) of row r in a tile of ROWS rows,
// stored as D/64 panels of [ROWS][128 bytes] in the 128-byte swizzle.
template <int ROWS>
__device__ __forceinline__ int sw_off(int r, int c) {
    return (c / 8) * (ROWS * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// ROWS x D bf16 rows from global (row stride `rs` elements) into a swizzled
// tile by cp.async; rows at or past `n_valid` are zero-filled.
template <int D, int ROWS, int NTH>
__device__ __forceinline__ void copy_tile(unsigned char* dst, const __nv_bfloat16* src,
                                          long long rs, int row0, int n_valid, int tid) {
    constexpr int CPR = D / 8;   // 16-byte chunks per row
    static_assert((ROWS * CPR) % NTH == 0, "whole chunks per thread");
#pragma unroll
    for (int i = 0; i < ROWS * CPR / NTH; ++i) {
        const int idx = tid + i * NTH, r = idx / CPR, c = idx % CPR;
        const bool in = row0 + r < n_valid;
        cp_async_16(dst + sw_off<ROWS>(r, c), src + (size_t)(in ? row0 + r : 0) * rs + c * 8,
                    in ? 16 : 0);
    }
}

// True when every (query, key) pair of rows [q0, q0+bq) and keys
// [kv0, kv0+bkv) is visible and every key exists: the tile needs no mask.
__device__ __forceinline__ bool tile_unmasked(const Args& a, int q0, int bq, int kv0, int bkv) {
    if (kv0 + bkv > a.Sk) return false;
    if (a.causal && kv0 + bkv - 1 > a.q_offset + q0) return false;
    if (a.window > 0 && kv0 <= a.q_offset + q0 + bq - 1 - a.window) return false;
    return true;
}

// 2^x on the SFU; results below 2^-126 flush to 0.
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// Scores of one tile in log2 units, w = s * scale * log2(e); with MASKED,
// pairs outside the mask become -1e30 and keys past Sk -inf (so that exp2
// gives them exactly 0 and the max never sees them).  Thread (g, t) holds
// query rows q_pos and q_pos + 8 and keys kv0 + 8n + 2t + e.
template <bool MASKED, int N>
__device__ __forceinline__ void scale_scores(const float (&s)[N], float (&w)[N], const Args& a,
                                             float sl2, int q_pos, int kv0, int t) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float val = s[i] * sl2;
        if (MASKED) {
            const int k_pos = kv0 + (i / 4) * 8 + 2 * t + i % 2;
            if (!visible(a, q_pos + ((i / 2) % 2) * 8, k_pos)) val = NEG_INF;
            if (k_pos >= a.Sk) val = __uint_as_float(0xff800000u);   // -inf
        }
        w[i] = val;
    }
}

// Online softmax of one tile of log2-unit scores (rows g and g+8 of the
// thread's warp): the new row maxima, p = exp2(s - m) in place, the running
// sums l (this thread's share) and the accumulators o rescaled.  Maxima and
// sums run as four independent chains each, then a tree.
template <int NSC, int NOC>
__device__ __forceinline__ void online_softmax(float (&s)[NSC], float (&m)[2], float (&l)[2],
                                               float (&o)[NOC]) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float mx[4] = {NEG_INF, NEG_INF, NEG_INF, NEG_INF};
#pragma unroll
        for (int n = 0; n < NSC / 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e)
                mx[(2 * n + e) % 4] = fmaxf(mx[(2 * n + e) % 4], s[4 * n + 2 * half + e]);
        float row_max = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 1));
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, 2));
        const float m_new = fmaxf(m[half], row_max);
        const float alpha = ex2(m[half] - m_new);
        float sum[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int n = 0; n < NSC / 4; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float p = ex2(s[4 * n + 2 * half + e] - m_new);
                s[4 * n + 2 * half + e] = p;
                sum[(2 * n + e) % 4] += p;
            }
        l[half] = l[half] * alpha + ((sum[0] + sum[1]) + (sum[2] + sum[3]));
        m[half] = m_new;
#pragma unroll
        for (int n = 0; n < NOC / 4; ++n) {
            o[4 * n + 2 * half] *= alpha;
            o[4 * n + 2 * half + 1] *= alpha;
        }
    }
}

// Needs q, k, v 16-byte aligned and every stride a multiple of 8 elements.
// A block is one warpgroup and 64 query rows; warp w owns rows 16w .. 16w+15
// and its thread (g, t) rows g and g+8 of them and, per 8 columns j,
// s[4j+e] / o[4j+e] = (row g, column 8j+2t+e) and s[4j+2+e] / o[4j+2+e] =
// (row g+8, the same): the D fragment of wgmma.
//
// The KV loop, tile j (K_j in K slot j % R, V_j in V slot j % R, R = RING):
//   wait for K_{j+1} and V_j (one commit group, issued R - 1 tiles earlier,
//   or at the start), then a barrier, after which every warp is done with
//   S_j's and P_{j-1} V_{j-1}'s reads;
//   copy K_{j+R} and V_{j+R-1} into the slots K_j and V_{j-1} held;
//   issue S_{j+1} = Q K_{j+1}^T, which runs while the softmax of S_j does;
//   O += P_j V_j; wait for both products.
template <int D>
__global__ void __launch_bounds__(Sm90<D>::NT, Sm90<D>::MIN_BLOCKS)
attn_kernel_sm90(const Args a) {
    using C = Sm90<D>;
    constexpr int BQ = C::BQ, BKV = C::BKV, NT = C::NT;
    constexpr int NS = BKV / 8;      // score column tiles
    constexpr int NO = D / 8;        // output column tiles
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);
    unsigned char* Qs = smem;
    constexpr int R = C::RING;
    auto k_slot = [&](int s) { return smem + C::Q_BYTES + s * C::KV_BYTES; };
    auto v_slot = [&](int s) { return smem + C::Q_BYTES + (R + s) * C::KV_BYTES; };

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int g = lane / 4, t = lane % 4;
    const int n_qt = (a.Sq + BQ - 1) / BQ, n_bh = a.B * a.Hq;
    const int qt = a.heavy_first ? n_qt - 1 - (int)(blockIdx.x / n_bh) : (int)(blockIdx.x % n_qt);
    const int bh = a.heavy_first ? (int)(blockIdx.x % n_bh) : (int)(blockIdx.x / n_qt);
    const int q0 = qt * BQ;
    const int b = bh / a.Hq, h = bh % a.Hq;
    const int hk = h / (a.Hq / a.Hk);
    const int Sk = a.Sk;

    const __nv_bfloat16* qp = (const __nv_bfloat16*)a.q + (size_t)b * a.qs.b + (size_t)h * a.qs.h;
    const __nv_bfloat16* kp = (const __nv_bfloat16*)a.k + (size_t)b * a.ks.b + (size_t)hk * a.ks.h;
    const __nv_bfloat16* vp = (const __nv_bfloat16*)a.v + (size_t)b * a.vs.b + (size_t)hk * a.vs.h;

    int kv_begin, kv_end;
    kv_range(a, q0, BQ, BKV, kv_begin, kv_end);
    const int n_tiles = (kv_end - kv_begin + BKV - 1) / BKV;
    auto copy_k = [&](int j) {
        if (j < n_tiles)
            copy_tile<D, BKV, NT>(k_slot(j % R), kp, a.ks.s, kv_begin + j * BKV, Sk, tid);
    };
    auto copy_v = [&](int j) {
        if (j < n_tiles)
            copy_tile<D, BKV, NT>(v_slot(j % R), vp, a.vs.s, kv_begin + j * BKV, Sk, tid);
    };

    // S = Q K_j^T: Q and K both K-major
    const uint32_t q_addr = (uint32_t)__cvta_generic_to_shared(Qs);
    auto issue_s = [&](float (&s)[4 * NS], int j) {
        const uint32_t k_addr = (uint32_t)__cvta_generic_to_shared(k_slot(j % R));
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss(s, sw128_desc(q_addr + (kk / 4) * (BQ * 128) + (kk % 4) * 32),
                     sw128_desc(k_addr + (kk / 4) * (BKV * 128) + (kk % 4) * 32), kk > 0);
        wgmma_commit();
        wgmma_keep(s);
    };

    // groups [Q, K_0], [K_1, V_0], ..., [K_{R-1}, V_{R-2}, V_{R-1}] (every
    // slot is free yet); S_0
    copy_tile<D, BQ, NT>(Qs, qp, a.qs.s, q0, a.Sq, tid);
    copy_k(0);
    cp_async_commit();
#pragma unroll
    for (int i = 1; i < R; ++i) {
        copy_k(i);
        copy_v(i - 1);
        if (i == R - 1) copy_v(i);
        cp_async_commit();
    }
    cp_async_wait<R - 1>();
    fence_proxy_async();
    __syncthreads();
    float s_even[4 * NS];
    issue_s(s_even, 0);
    wgmma_wait<0>();
    wgmma_keep(s_even);

    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // l: this thread's share of the row sum
    float o[4 * NO];
#pragma unroll
    for (int i = 0; i < 4 * NO; ++i) o[i] = 0.f;
    const float sl2 = a.scale * LOG2E;   // scores in log2 units: p = exp2(s * sl2 - m)
    const int row_a = q0 + warp * 16 + g;   // this thread's rows row_a and row_a + 8

    // Tile j with its scores in sc, tile j+1's into sn.  Only wgmma writes
    // sc and sn (the softmax works on a copy, w): an accumulator that other
    // instructions write makes ptxas serialize every wgmma of the kernel.
    auto step = [&](int j, const float (&sc)[4 * NS], float (&sn)[4 * NS]) {
        const int kv0 = kv_begin + j * BKV;
        cp_async_wait<R - 2>();            // K_{j+1}, V_j landed for this thread,
        fence_proxy_async();               // are visible to the tensor cores' reads,
        __syncthreads();                   // and for all
        copy_k(j + R);
        if (j > 0) copy_v(j + R - 1);      // (V_{R-1} came with V_{R-2})
        cp_async_commit();
        if (j + 1 < n_tiles) issue_s(sn, j + 1);

        const int q_pos = a.q_offset + row_a;
        float w[4 * NS];
        if (tile_unmasked(a, q0, BQ, kv0, BKV))
            scale_scores<false>(sc, w, a, sl2, q_pos, kv0, t);
        else
            scale_scores<true>(sc, w, a, sl2, q_pos, kv0, t);
        online_softmax(w, m, l, o);

        // O += P V: the probabilities, as bf16, are the register operand A;
        // V ([key][d], d contiguous) is the MN-major operand B
        uint32_t pa[BKV / 16][4];
#pragma unroll
        for (int ks = 0; ks < BKV / 16; ++ks) {
            pa[ks][0] = pack_bf16(w[8 * ks], w[8 * ks + 1]);
            pa[ks][1] = pack_bf16(w[8 * ks + 2], w[8 * ks + 3]);
            pa[ks][2] = pack_bf16(w[8 * ks + 4], w[8 * ks + 5]);
            pa[ks][3] = pack_bf16(w[8 * ks + 6], w[8 * ks + 7]);
        }
        const uint32_t v_addr = (uint32_t)__cvta_generic_to_shared(v_slot(j % R));
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < BKV / 16; ++ks)
            wgmma_rs<1>(o, pa[ks], sw128_mn_desc(v_addr + ks * 16 * 128, BKV * 128), 1);
        wgmma_commit();
        wgmma_wait<0>();
        wgmma_keep(o);
        wgmma_keep(sn);
#pragma unroll
        for (int ks = 0; ks < BKV / 16; ++ks) wgmma_keep(pa[ks]);
    };
    // Two steps a pass, so that the score buffers keep their places; each
    // product's buffer is declared afresh, so no other instruction defines
    // the accumulators it starts from (they are scaled by 0).
    for (int j = 0;; j += 2) {
        float s_odd[4 * NS];
        step(j, s_even, s_odd);
        if (j + 1 >= n_tiles) break;
        float s_next[4 * NS];
        step(j + 1, s_odd, s_next);
        if (j + 2 >= n_tiles) break;
#pragma unroll
        for (int i = 0; i < 4 * NS; ++i) s_even[i] = s_next[i];
    }
    cp_async_wait<0>();

    float inv[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        float sum = l[half];
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        inv[half] = 1.f / fmaxf(sum, 1e-30f);
    }
    float* op = a.out + ((size_t)bh * a.Sq) * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
        const int row = row_a + half * 8;
        if (row >= a.Sq) continue;
#pragma unroll
        for (int n = 0; n < NO; ++n)
            *reinterpret_cast<float2*>(op + (size_t)row * D + n * 8 + 2 * t) =
                make_float2(o[4 * n + 2 * half] * inv[half], o[4 * n + 2 * half + 1] * inv[half]);
    }
}

// ---- launch ----------------------------------------------------------------

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) % 16) == 0; }
inline bool mult8(const Strides& s) { return s.b % 8 == 0 && s.h % 8 == 0 && s.s % 8 == 0; }

// One launch; the shared-memory attribute is set once per kernel instance
// (above 48 KB of dynamic shared memory a kernel has to opt in).
template <typename Kernel>
int launch(Kernel kernel, bool& configured, size_t smem, int threads, long long blocks,
           const Args& a, cudaStream_t stream) {
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e == cudaSuccess)   // all of the SM's shared memory, so that blocks fit side by side
            e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                     (int)cudaSharedmemCarveoutMaxShared);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    if (blocks > 2147483647LL) return (int)cudaErrorInvalidConfiguration;
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(a);
    return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_fma(const Args& a, cudaStream_t st) {
    static bool configured = false;
    return launch(attn_kernel<T, D>, configured, smem_bytes<D>(), NT,
                  (long long)a.B * a.Hq * ((a.Sq + BQ - 1) / BQ), a, st);
}

template <int D>
int launch_sm90(const Args& a, cudaStream_t st) {
    using C = Sm90<D>;
    static bool configured = false;
    return launch(attn_kernel_sm90<D>, configured, C::SMEM, C::NT,
                  (long long)a.B * a.Hq * ((a.Sq + C::BQ - 1) / C::BQ), a, st);
}

Args make_args(const void* q, const void* k, const void* v, void* out, int B, int Hq, int Hk,
               int Sq, int Sk, const long long* strides, float scale, int causal, int window,
               int q_offset, int skip, int heavy_first) {
    return Args{q, k, v, (float*)out, B, Hq, Hk, Sq, Sk,
                Strides{strides[0], strides[1], strides[2]},
                Strides{strides[3], strides[4], strides[5]},
                Strides{strides[6], strides[7], strides[8]},
                scale, causal, window, q_offset, skip, heavy_first};
}

bool bad_sizes(int B, int Hq, int Hk, int Sq, int Sk) {
    return B <= 0 || Hq <= 0 || Hk <= 0 || Sq <= 0 || Sk <= 0 || Hq % Hk != 0;
}

}  // namespace

// The f32 FMA kernel.  strides: nine element strides, (batch, head, seq) of
// q, then k, then v.  is_bf16: 1 when q, k, v hold bf16, 0 when f32.  skip:
// 1 when no query row is masked everywhere (see the note above).  Returns
// cudaGetLastError().
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int B, int Hq, int Hk, int Sq, int Sk, int D,
                                      const long long* strides, float scale, int causal,
                                      int window, int q_offset, int skip, int is_bf16,
                                      void* stream) {
    if (bad_sizes(B, Hq, Hk, Sq, Sk)) return (int)cudaErrorInvalidValue;
    const Args a = make_args(q, k, v, out, B, Hq, Hk, Sq, Sk, strides, scale, causal, window,
                             q_offset, skip, 0);
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define FMA_D(D) (is_bf16 ? launch_fma<__nv_bfloat16, D>(a, st) : launch_fma<float, D>(a, st))
    switch (D) {
        case 16:  return FMA_D(16);
        case 32:  return FMA_D(32);
        case 64:  return FMA_D(64);
        case 128: return FMA_D(128);
        default:  return (int)cudaErrorInvalidValue;
    }
#undef FMA_D
}

// The bf16 tensor-core kernel on the plan `attn_plan` of
// kernels/flash_attention.py gives: query tiles by decreasing work when
// heavy_first, tile skipping when skip.  Refuses what it cannot take (D not
// 64 or 128, storage not 16-byte aligned, a stride not a multiple of 8)
// with cudaErrorInvalidValue.
extern "C" int flash_attention_sm90_launch(const void* q, const void* k, const void* v,
                                           void* out, int B, int Hq, int Hk, int Sq, int Sk,
                                           int D, const long long* strides, float scale,
                                           int causal, int window, int q_offset, int skip,
                                           int heavy_first, void* stream) {
    if (bad_sizes(B, Hq, Hk, Sq, Sk)) return (int)cudaErrorInvalidValue;
    const Args a = make_args(q, k, v, out, B, Hq, Hk, Sq, Sk, strides, scale, causal, window,
                             q_offset, skip, heavy_first);
    if (!aligned16(q) || !aligned16(k) || !aligned16(v) || !aligned16(out) || !mult8(a.qs) ||
        !mult8(a.ks) || !mult8(a.vs))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
    switch (D) {
        case 64:  return launch_sm90<64>(a, st);
        case 128: return launch_sm90<128>(a, st);
        default:  return (int)cudaErrorInvalidValue;
    }
}
