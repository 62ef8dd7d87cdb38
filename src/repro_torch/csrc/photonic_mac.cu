// photonic_mac: out (M,N) f32 = x (M,K) bf16|f32 @ (w_q (K,N) int8 * scale[K/128, N/128]).
//
// Replaces the TPU kernel `photonic_mac` (body `_mac_kernel`) of
// src/repro/kernels/photonic_mac.py.  There the grid's third axis walks K in
// order and carries an f32 accumulator in VMEM; here a thread block loops
// over K itself.  The scale of a 128x128 weight bank changes with every K
// bank, so it cannot be hoisted out of the loop.  Two kernels:
//
//  * `mac_kernel_sm90` (bf16 activations, K and N multiples of 128: every
//    shape the serving path sends).  What bounds it on an H100: at M = 128
//    the bytes (int8 weights read once, 1 byte a product column), from
//    M = 512 on the bf16 operations.  What the design does about each:
//      - bytes: a ring of 3-4 shared-memory stages, each one weight bank deep
//        (128 K rows: 16 KB of int8 weights and TM x 128 of x), filled with
//        16-byte cp.async copies two or three banks ahead, one barrier a
//        stage.  The weights stay int8 in shared memory and are read raw by
//        `ldmatrix.trans` (a b16 pair is two neighbouring columns of one K
//        row), then widened in registers with a byte-permute and bias trick
//        that is exact for every level.
//      - too few blocks at M = 128 (N/128 column tiles): K is split into S
//        bank-aligned ranges, S a function of K and N only, run by the S
//        blocks of one thread-block cluster; their f32 tiles meet in
//        distributed shared memory and are summed in rank order, so the
//        partials never reach device memory.  Where the row tiles alone
//        give the card enough blocks (large M), one block walks the same S
//        ranges in turn and adds their sums in the same order (a running
//        total in shared memory), so large M pays no ring fills or cluster
//        reduction for a split chosen for few rows.
//      - operations: the warpgroup product, `wgmma`, run transposed
//        (out^T = w_q^T x^T) so that the widened weights are its register
//        operand A and x, in the 128-byte swizzle cp.async writes it in, is
//        its shared-memory operand B; a block is 128 weight columns (two
//        warpgroups of 64) by TM = 128, 64 or 32 rows of x.
//    Inside each bank the exact products x*level are summed in f32 into a
//    partial sum (`wgmma` with scale-d = 0 starts it), folded in at the
//    bank's end as acc = fma(scale, part, acc), in bank order; the scale
//    never meets a bf16 operand.
//  * `mac_kernel` (f32 activations, bf16 activations of other shapes, and
//    `tensor_cores=False`): every 32-deep step dequantises its int8 tile into
//    shared memory, exactly `w_q.astype(f32) * scale` as the reference does,
//    and accumulates with f32 FMAs in registers (64x64 tiles).  The reference
//    multiplies in true f32, which the tensor cores cannot (TF32 keeps 10
//    mantissa bits).  Held by the f32 pipe.
//
// The K order of every output element is fixed by K and N alone (the tile
// height and the number of row tiles may follow M, the split may not), so
// rows are bit-identical with and without extra rows below them.  Ragged M
// is masked in both kernels (out-of-range rows load 0, their stores are
// dropped); `mac_kernel` masks ragged K and N too.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

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

// ---- bf16 activations, bank-aligned K and N: mac_kernel_sm90 ----------------

constexpr int S_NT = 256;                 // two warpgroups, each 64 weight columns x TM rows
constexpr int S_BN = BANK;                // one bank wide: one scale per block and bank
constexpr int S_BK = BANK;                // one bank deep per ring stage
constexpr int B_PITCH = S_BN + 16;        // bytes per w_q row of a stage (144: the 8 rows of an
                                          // ldmatrix land on distinct banks)
constexpr int B_STAGE = S_BK * B_PITCH;
constexpr int RED_PITCH = S_BN + 4;       // f32 per row of the tile a split block hands over
constexpr int SMEM_MAX = 227 * 1024;      // dynamic shared memory a block may have on an H100
constexpr int MAX_SPLITS = 16;            // non-portable cluster size limit of an H100

template <int TM>
struct SmCfg {
    static constexpr int STAGES = TM == 32 ? 4 : 3;
    static constexpr int X_STAGE = TM * 256;              // x: two 64-deep halves, 128B-swizzled
    static constexpr int STAGE = X_STAGE + B_STAGE;       // 51200 / 34816 / 26624 bytes
    static constexpr int SMEM = STAGES * STAGE + 1024;    // + room to align the ring to 1024
    static constexpr int TOTAL = TM * S_BN * 4;           // a sequential split's running total
    static constexpr int MIN_BLOCKS = TM == 128 ? 1 : 2;  // blocks an SM must hold (registers)
    static_assert(STAGE % 1024 == 0, "the swizzle atoms of every stage stay 1024-aligned");
    static_assert(TM * RED_PITCH * 4 <= STAGES * STAGE, "the hand-over tile reuses the ring");
    static_assert(SMEM + TOTAL <= SMEM_MAX, "ring and running total fit one block");
};

// The product runs transposed, out^T = w_q^T x^T, as wgmma m64nTMk16: A is
// 64 weight columns of the bank (from registers: int8 levels widened there),
// B is TM rows of x (from shared memory, K-major, 128-byte swizzle), D is
// (weight column, x row).  Warp w of warpgroup v owns weight columns
// 64v + 16w .. +15 of the tile; its A rows g and g+8 are columns 2g and 2g+1
// of that span (the transposed ldmatrix hands over column pairs).
//
// K is summed as `splits` ranges of whole banks, range q being banks
// [q * banks / splits, (q + 1) * banks / splits), and the ranges' sums are
// added in range order.  grid (cluster, row tiles, column tiles) when
// m_fast, else (cluster, column tiles, row tiles); cluster (cluster, 1, 1):
// without SEQ, cluster == splits (a block's cluster rank is blockIdx.x and
// the range it sums; 1 for no split); with SEQ, cluster == 1 and each block
// sums the ranges in turn.  Needs K % 128 == N % 128 == 0 and x, w_q, out
// 16-byte aligned.
template <int TM, bool SEQ>
__global__ void __launch_bounds__(S_NT, SmCfg<TM>::MIN_BLOCKS)
mac_kernel_sm90(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ wq,
                const float* __restrict__ scale, float* __restrict__ out,
                int M, int K, int N, int splits, int m_fast) {
    using C = SmCfg<TM>;
    constexpr int NR = TM / 2;            // f32 accumulators a thread holds, per set
    extern __shared__ __align__(1024) unsigned char smem_raw[];
    unsigned char* smem =
        smem_raw + ((1024 - ((uint32_t)__cvta_generic_to_shared(smem_raw) & 1023)) & 1023);

    const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
    const int wg = warp / 4, wi = warp % 4;
    const int g = lane / 4, t = lane % 4;
    const int cluster = gridDim.x, rank = blockIdx.x;
    const int ti = m_fast ? blockIdx.y : blockIdx.z, tj = m_fast ? blockIdx.z : blockIdx.y;
    const int m0 = ti * TM, n0 = tj * S_BN;
    const int banks = K / BANK, scale_cols = N / BANK;
    const int b_lo = SEQ ? 0 : rank * banks / splits;   // this block's banks: [b_lo, b_lo + nb)
    const int nb = SEQ ? banks : (rank + 1) * banks / splits - b_lo;
    int q = 0, q_end = banks / splits;                  // SEQ: the range summed, its end
    float4* total = reinterpret_cast<float4*>(smem + C::STAGES * C::STAGE);  // SEQ: ranges done

    // copy bank b_lo + b into ring slot s: TM rows of x into two swizzled
    // 64-deep halves (rows past M read as zeros), 128 rows of w_q as they
    // lie, int8
    auto issue = [&](int b, int s) {
        const int k0 = (b_lo + b) * BANK;
        unsigned char* xs = smem + s * C::STAGE;
        unsigned char* ws = xs + C::X_STAGE;
#pragma unroll
        for (int i = 0; i < TM * 16 / S_NT; ++i) {
            const int idx = tid + i * S_NT, r = idx / 16, c = idx % 16;
            const bool in = m0 + r < M;
            cp_async_16(xs + (c / 8) * (TM * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4),
                        x + (size_t)(in ? m0 + r : 0) * K + k0 + c * 8, in ? 16 : 0);
        }
#pragma unroll
        for (int i = 0; i < S_BK * 8 / S_NT; ++i) {
            const int idx = tid + i * S_NT, r = idx / 8, c = idx % 8;
            cp_async_16(ws + r * B_PITCH + c * 16, wq + (size_t)(k0 + r) * N + n0 + c * 16, 16);
        }
    };

    float acc[NR], part[NR];
#pragma unroll
    for (int i = 0; i < NR; ++i) { acc[i] = 0.f; part[i] = 0.f; }

#pragma unroll
    for (int s = 0; s < C::STAGES - 1; ++s) {
        if (s < nb) issue(s, s);
        cp_async_commit();               // one group per bank, empty past the end
    }
    cp_async_wait<C::STAGES - 2>();      // bank 0 has landed for this thread,
    fence_proxy_async();                 // is visible to the tensor cores' reads,
    __syncthreads();                     // and has landed for all

    // Per 32 K rows of the bank in ring slot `slot`: the warp's 32 x 16 int8
    // slice as four 8x8 b16 matrices (K rows 0-7, 8-15, 16-23, 24-31; a b16
    // is two neighbouring columns).  Transposed, lane 4g+t holds levels
    // (k 2t, 2t+1) x (columns 2g, 2g+1) of each: widened, the A fragments of
    // two 16-deep products, A row g = column 2g and row g+8 = column 2g+1.
    auto load_a = [&](int slot, int q, uint32_t (&lo)[4], uint32_t (&hi)[4]) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, smem + slot * C::STAGE + C::X_STAGE + (q * 32 + lane) * B_PITCH +
                                 wg * 64 + wi * 16);
        i8x4_to_bf16x2(r[0], lo[0], lo[1]);
        i8x4_to_bf16x2(r[1], lo[2], lo[3]);
        i8x4_to_bf16x2(r[2], hi[0], hi[1]);
        i8x4_to_bf16x2(r[3], hi[2], hi[3]);
    };
    uint32_t next[2][4];                 // the next bank's first 32 rows
    load_a(0, 0, next[0], next[1]);

    for (int b = 0; b < nb; ++b) {
        const int slot = b % C::STAGES;
        const float s = __ldg(scale + (size_t)(b_lo + b) * scale_cols + tj);
        const uint32_t xa = (uint32_t)__cvta_generic_to_shared(smem + slot * C::STAGE);

        // the bank's eight 16-deep products into `part` (the first starts it
        // from 0), two 32-row steps of A fragments in flight
        uint32_t af[2][2][4];
#pragma unroll
        for (int i = 0; i < 4; ++i) { af[0][0][i] = next[0][i]; af[0][1][i] = next[1][i]; }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q >= 2) {                // the products that read af[q % 2] are done
                wgmma_wait<1>();
                wgmma_keep(af[q % 2][0]);
                wgmma_keep(af[q % 2][1]);
            }
            if (q > 0) load_a(slot, q, af[q % 2][0], af[q % 2][1]);
            wgmma_fence();
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int step = 2 * q + h;
                wgmma_rs(part, af[q % 2][h],
                         sw128_desc(xa + (step / 4) * (TM * 128) + (step % 4) * 32), step > 0);
            }
            wgmma_commit();
        }

        // while they run: wait for the next bank, refill the slot bank b-1
        // held (its products finished before this barrier), and widen the
        // next bank's first fragments
        if (b + 1 < nb) {
            cp_async_wait<C::STAGES - 3>();
            fence_proxy_async();
            __syncthreads();
            if (b + C::STAGES - 1 < nb) issue(b + C::STAGES - 1, (b + C::STAGES - 1) % C::STAGES);
            cp_async_commit();
            load_a((b + 1) % C::STAGES, 0, next[0], next[1]);
        }
        wgmma_wait<0>();
        wgmma_keep(part);
#pragma unroll
        for (int q = 0; q < 2; ++q) { wgmma_keep(af[q][0]); wgmma_keep(af[q][1]); }

        // end of the bank: fold its exact partial sum in
#pragma unroll
        for (int i = 0; i < NR; ++i) acc[i] = fmaf(s, part[i], acc[i]);

        // SEQ, end of a range but not the last: add its sum to the ranges'
        // before it (each thread its own slots), start the next at 0
        if (SEQ && b + 1 == q_end && b + 1 < nb) {
#pragma unroll
            for (int i = 0; i < NR / 4; ++i) {
                float4 v = make_float4(acc[4 * i], acc[4 * i + 1], acc[4 * i + 2], acc[4 * i + 3]);
                if (q > 0) {
                    const float4 o = total[i * S_NT + tid];
                    v.x = o.x + v.x; v.y = o.y + v.y; v.z = o.z + v.z; v.w = o.w + v.w;
                }
                total[i * S_NT + tid] = v;
                acc[4 * i] = acc[4 * i + 1] = acc[4 * i + 2] = acc[4 * i + 3] = 0.f;
            }
            ++q;
            q_end = (q + 1) * banks / splits;
        }
    }
    cp_async_wait<0>();
    if (SEQ) {                           // the last range joins the total
#pragma unroll
        for (int i = 0; i < NR / 4; ++i) {
            const float4 o = total[i * S_NT + tid];
            acc[4 * i] = o.x + acc[4 * i];
            acc[4 * i + 1] = o.y + acc[4 * i + 1];
            acc[4 * i + 2] = o.z + acc[4 * i + 2];
            acc[4 * i + 3] = o.w + acc[4 * i + 3];
        }
    }

    // Thread (g, t) holds weight columns c0, c0 + 1 of x rows 8j + 2t + e:
    // acc[4j + e] and acc[4j + 2 + e].
    const int c0 = wg * 64 + wi * 16 + 2 * g;
    if (cluster == 1) {
#pragma unroll
        for (int j = 0; j < TM / 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int row = m0 + 8 * j + 2 * t + e;
                if (row < M)
                    *reinterpret_cast<float2*>(out + (size_t)row * N + n0 + c0) =
                        make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
            }
        return;
    }

    // Split over a cluster: each block lays its tile in its own shared
    // memory; block q then sums a 1/cluster share of the tile over ranks 0,
    // 1, ... in order and stores it.
    __syncthreads();                     // every warp is done with the ring
    float* red = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int j = 0; j < TM / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            *reinterpret_cast<float2*>(red + (8 * j + 2 * t + e) * RED_PITCH + c0) =
                make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();
    constexpr int VECS = TM * S_BN / 4;
    const int per = (VECS + cluster - 1) / cluster;
    const int e_hi = min(VECS, (rank + 1) * per);
    for (int e = rank * per + tid; e < e_hi; e += S_NT) {
        const int row = e / (S_BN / 4), col = (e % (S_BN / 4)) * 4;
        if (m0 + row >= M) continue;
        const int off = row * RED_PITCH + col;
        float4 v = *reinterpret_cast<const float4*>(cl.map_shared_rank(red, 0) + off);
        for (int r = 1; r < cluster; ++r) {
            const float4 w = *reinterpret_cast<const float4*>(cl.map_shared_rank(red, r) + off);
            v.x += w.x; v.y += w.y; v.z += w.z; v.w += w.w;
        }
        *reinterpret_cast<float4*>(out + (size_t)(m0 + row) * N + n0 + col) = v;
    }
    cl.sync();                           // no block leaves while another reads its tile
}

inline bool aligned(const void* p, uintptr_t a) { return (reinterpret_cast<uintptr_t>(p) % a) == 0; }

template <typename T>
int launch_fma(const void* x, const void* wq, const void* scale, void* out,
               int M, int K, int N, cudaStream_t stream) {
    const int kvec = sizeof(T) == 2 ? 8 : 4;
    const bool vec = (K % kvec == 0) && (N % 4 == 0) && aligned(x, 16) && aligned(wq, 4) &&
                     aligned(out, 16);
    dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
    const int scale_cols = (N + BANK - 1) / BANK;
    if (vec)
        mac_kernel<T, true><<<grid, NT, 0, stream>>>(
            (const T*)x, (const int8_t*)wq, (const float*)scale, (float*)out, M, K, N, scale_cols);
    else
        mac_kernel<T, false><<<grid, NT, 0, stream>>>(
            (const T*)x, (const int8_t*)wq, (const float*)scale, (float*)out, M, K, N, scale_cols);
    return (int)cudaGetLastError();
}

template <int TM, bool SEQ>
int launch_sm90(const void* x, const void* wq, const void* scale, void* out,
                int M, int K, int N, int splits, int cluster, int m_fast, cudaStream_t stream) {
    using C = SmCfg<TM>;
    constexpr int SMEM = C::SMEM + (SEQ ? C::TOTAL : 0);
    static bool configured = false;      // the attributes, once per process
    if (!configured) {
        cudaError_t e = cudaFuncSetAttribute(mac_kernel_sm90<TM, SEQ>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(mac_kernel_sm90<TM, SEQ>,
                                     cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return (int)e;
        configured = true;
    }
    const int mt = (M + TM - 1) / TM, nt = N / S_BN;
    if (mt > 65535 || nt > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = m_fast ? dim3(cluster, mt, nt) : dim3(cluster, nt, mt);
    cfg.blockDim = dim3(S_NT);
    cfg.dynamicSmemBytes = SMEM;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, mac_kernel_sm90<TM, SEQ>,
                                             (const __nv_bfloat16*)x, (const int8_t*)wq,
                                             (const float*)scale, (float*)out, M, K, N, splits,
                                             m_fast);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// The f32 FMA kernel.  x_bf16: 1 when x holds bf16, 0 when f32.  Returns
// cudaGetLastError().
extern "C" int photonic_mac_launch(const void* x, const void* wq, const void* scale, void* out,
                                   int M, int K, int N, int x_bf16, void* stream) {
    if (M <= 0 || K <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
    if ((M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidConfiguration;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    return x_bf16 ? launch_fma<__nv_bfloat16>(x, wq, scale, out, M, K, N, s)
                  : launch_fma<float>(x, wq, scale, out, M, K, N, s);
}

// The bf16 tensor-core kernel, on the plan `mac_plan` of
// kernels/photonic_mac.py gives: row tile bm (128, 64 or 32), `splits` K
// ranges (1..16, at most K/128) summed by a cluster of `cluster` blocks
// (`splits`, or 1 to sum them in turn), row tiles fastest in the grid when
// m_fast.  Refuses what it cannot take with cudaErrorInvalidValue.
extern "C" int photonic_mac_sm90_launch(const void* x, const void* wq, const void* scale,
                                        void* out, int M, int K, int N, int bm, int splits,
                                        int cluster, int m_fast, void* stream) {
    if (M <= 0 || K <= 0 || N <= 0 || K % BANK || N % BANK || splits < 1 ||
        splits > MAX_SPLITS || splits > K / BANK || (cluster != 1 && cluster != splits) ||
        !aligned(x, 16) || !aligned(wq, 16) || !aligned(out, 16))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const bool seq = cluster == 1 && splits > 1;
#define MAC_SM90(TM)                                                                   \
    (seq ? launch_sm90<TM, true>(x, wq, scale, out, M, K, N, splits, cluster, m_fast, s) \
         : launch_sm90<TM, false>(x, wq, scale, out, M, K, N, splits, cluster, m_fast, s))
    switch (bm) {
        case 128: return MAC_SM90(128);
        case 64: return MAC_SM90(64);
        case 32: return MAC_SM90(32);
        default: return (int)cudaErrorInvalidValue;
    }
#undef MAC_SM90
}
