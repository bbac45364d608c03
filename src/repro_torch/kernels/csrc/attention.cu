// Flash attention for Hopper (sm_90a): causal online-softmax attention with
// grouped-query heads and an optional sliding window, in f32.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (body _flash_kernel): query head h of batch b
// reads KV head h / G (G = H / Hkv), the mask is k_pos <= q_pos,
// k_pos < Sk and (q_pos - k_pos) < window on absolute indices 0..Sq-1 and
// 0..Sk-1, the scale is hd^-0.5, masked scores are -1e30 with p = 0 after
// the exponential, and the denominator has a floor of 1e-30.
//
// Layout. q, k, v and o are read and written through their batch,
// position and head strides (in floats; hd contiguous, rows 16-byte
// aligned), so one launch serves the model's (B, S, H, hd) tensors and the
// folded (B*H, S, hd) ones alike, with no copy on either side. v has a
// head dim of its own, HDV <= HD (MLA: q/k 192 and v 128 for
// DeepSeek-V2-Lite, 96 and 64 for MiniCPM3-4B), and strides of its own,
// so P V runs on v's own columns; the output has v's head dim.
//
// Instances (HD, HDV, BK keys per KV tile): (32, 32), (64, 64), (128, 64)
// and (128, 128) with BK 64, and (192, 128), (192, 192) and (256, 256)
// with BK 32. The reference pads any head dim to a multiple of 128; the
// H100 gives a block 232,448 bytes of shared memory, and Q, a two-stage
// ring of 64-key K/V tiles and P take (64 + 4 * 64) * (HD + 4) * 4 +
// 64 * 80 * 4 bytes: 271,360 at HD 192. The wide instances halve the KV
// tile instead: 162,816 bytes at (192, 192), 146,432 at (192, 128) and
// 211,968 at (256, 256), one block an SM, with the ring kept.
//
// Grid. One block (256 threads) owns one tile of FA_ROWS = 64 consecutive
// query positions of one query head. The grid is (batch x head, position
// tile), heads fastest, so the G heads of a KV head run side by side and
// read its K/V tiles from L2 together; the position tile is walked from
// the last to the first: blocks are handed out x-fastest, so the longest
// causal KV walks of every head start first. Where one block per tile
// would put more than one block on some SM (the 512-token headline: 256
// tiles on 132 SMs, whose pairs of blocks would walk from 5 to 12 KV
// tiles), the launch pairs tile n - 1 - y with tile y in block y: every
// block then walks about as far as every other, in one wave. A smaller
// grid keeps one tile per block, the shortest latency; so do a window
// shorter than the queries (the walks are about equal) and a grid of
// several waves (the heavy-first order balances it).
//
// Ring. The block walks the KV tiles of BK keys from the first one the
// window reaches to the one holding its last position's diagonal (tiles
// wholly outside are skipped: a fully masked tile adds p = 0 and leaves the
// running max where it was). K and V tiles sit in a ring of two stages of
// shared memory, filled by 16-byte cp.async copies (zero-filled past Sk),
// so tile t + 1 is in flight while tile t is computed; one block barrier
// per tile hands a stage back to the copies. K is stored as it lies in
// memory (key-major, rows of hd + 4 floats): thread tx reads keys tx,
// tx + 16, ..., tx + BK - 16, so the 16 lanes of a row group read 16
// rows 4 banks apart and Q K^T runs without bank conflicts.
//
// Rows. Thread (ty, tx) of the 16 x 16 grid owns the four query rows
// ty + 16 i (a warp, ty = 2w and 2w + 1, owns 8 whole rows): their scores
// with its BK/16 keys, and HDV/16 output columns (64 at HDV 256, within
// the 255 registers of one block an SM). The two half-warps
// read rows r and r + 1, 4 banks apart in Q (broadcast within each half)
// and 16 apart in P. The running max, the denominator (a per-lane partial,
// summed over the row's 16 lanes once at the end) and the accumulator live
// in registers; the row max is combined by an xor butterfly inside the
// warp. The warp's tile of P is its own: it is written and read back by
// the same warp after a __syncwarp, never by another warp. Tiles that the
// mask leaves whole (all keys valid for every row) skip the mask
// arithmetic.
//
// Arithmetic is IEEE f32 on the FMA units: no TF32, no tensor cores and no
// fast-math exponentials. Every sum runs in a fixed order with no atomics
// (scores over d in order, P V over the keys 0..BK-1 of each tile in order,
// the denominator's lane partials by a butterfly), so a rerun is
// bit-identical.
//
// Bound on the H100: operations. A causal prefill of S tokens costs about
// 2 * 2 * hd * S^2 / 2 flops per head against 4 * S * hd * (2 + 2 / G)
// bytes, hundreds of flops per byte at S = 512, so the 67 TFLOP/s FP32 rate
// bounds it. What the design does about that: each thread does 64 FMAs per
// eight 16-byte shared-memory loads in Q K^T and in P V (the four of Q or
// P are broadcasts within each half-warp), the copies of the next tile
// overlap the arithmetic of this one, and the blocks of one wave walk
// equal lengths. On an H100 it reaches about a third of the bound at
// Llama-3.2-1B's 512-token prefill and half of it at 8192 tokens
// (PERF.md). At BK 32 a thread does 32 FMAs per six loads in Q K^T, half
// the narrow instances' ratio, and one block an SM hides less latency:
// the wide instances are the simple tiling that fits, not a fast one.
// Tensor cores (wgmma, split f32) and bf16 are later work.
//
// Plain C interface (see aggregation.cu): the caller passes the pointers,
// strides and the stream; the entry point returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

#include <type_traits>

#include "async_copy.cuh"

namespace {

constexpr int FA_ROWS = 64;        // query rows per tile (BLOCK_Q)
constexpr int RPT = 4;             // query rows per thread
constexpr int FA_GROUPS = FA_ROWS / RPT;   // row groups: ty
constexpr int FA_THREADS = 16 * FA_GROUPS; // FA_GROUPS x 16: tx key group
constexpr float FA_NEG_INF = -1e30f;

constexpr int STAGES = 2;           // K/V ring depth

// keys per KV tile (BLOCK_K) of the instance for q/k head dim HD
constexpr int fa_block_k(int hd) { return hd <= 128 ? 64 : 32; }

template <int HD, int HDV>
struct FaTile {
    static constexpr int BK = fa_block_k(HD);       // keys per KV tile
    static constexpr int KPT = BK / 16;             // keys per thread
    static constexpr int LDP = BK + 16;             // row stride of P: rows
                                                    // r, r + 1 16 banks apart
    static constexpr int LD = HD + 4;               // row stride of Q, K
    static constexpr int LDV = HDV + 4;             // row stride of V
    static constexpr int CPR = HD / 4;              // 16-byte chunks per row
    static constexpr int CPRV = HDV / 4;            // ... of a V row
    static constexpr int DPT = HDV / 16;            // output columns/thread
    static constexpr int VEC = DPT < 4 ? DPT : 4;   // columns per vector load
    static constexpr int NG = DPT / VEC;            // vector groups/thread
    static constexpr int Q = FA_ROWS * LD;          // Q[r][d]
    static constexpr int K = BK * LD;               // K[c][d]
    static constexpr int V = BK * LDV;              // V[c][d]
    static constexpr int P = FA_ROWS * LDP;         // P[r][c]
    static constexpr size_t BYTES =
        sizeof(float) * (Q + STAGES * (K + V) + P);
    static constexpr int MIN_BLOCKS = HD <= 64 ? 2 : 1;
    static_assert(HDV <= HD && HDV % 32 == 0, "v's head dim: 32k, <= HD");
    static_assert(FA_ROWS * CPR % FA_THREADS == 0
                  && BK * CPR % FA_THREADS == 0
                  && BK * CPRV % FA_THREADS == 0, "whole copy rounds");
    static_assert(BYTES <= 232448, "one block's shared memory on an H100");
};

struct FaParams {
    const float* q;
    const float* k;
    const float* v;
    float* o;
    long long q_sb, q_ss, q_sh;      // strides in floats: batch, position,
    long long k_sb, k_ss, k_sh;      // head
    long long v_sb, v_ss, v_sh;
    long long o_sb, o_ss, o_sh;
    int sq, sk, n_heads, group, window;
    float scale;
    int n_qt, paired;                // query tiles; two per block or one
};

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float* out) {
    if constexpr (VEC == 4) {
        const float4 t = *reinterpret_cast<const float4*>(p);
        out[0] = t.x; out[1] = t.y; out[2] = t.z; out[3] = t.w;
    } else {
        const float2 t = *reinterpret_cast<const float2*>(p);
        out[0] = t.x; out[1] = t.y;
    }
}

template <int VEC>
__device__ __forceinline__ void store_vec(float* p, const float* in) {
    if constexpr (VEC == 4)
        *reinterpret_cast<float4*>(p) = make_float4(in[0], in[1], in[2],
                                                    in[3]);
    else
        *reinterpret_cast<float2*>(p) = make_float2(in[0], in[1]);
}

template <int HD, int HDV>
__global__ void __launch_bounds__(FA_THREADS, FaTile<HD, HDV>::MIN_BLOCKS)
flash_attention_kernel(const FaParams a) {
    using T = FaTile<HD, HDV>;
    constexpr int BK = T::BK;
    extern __shared__ __align__(16) float smem[];
    float* q_s = smem;                       // Q tile
    float* kv_s = q_s + T::Q;                // ring: K then V per stage
    float* p_s = kv_s + STAGES * (T::K + T::V);  // probabilities of the tile

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int h = blockIdx.x % a.n_heads;
    const long long b = blockIdx.x / a.n_heads;
    const int kvh = h / a.group;
    const float* qb = a.q + b * a.q_sb + h * a.q_sh;
    const float* kb = a.k + b * a.k_sb + kvh * a.k_sh;
    const float* vb = a.v + b * a.v_sb + kvh * a.v_sh;

    // one query tile: its KV walk, then its rows of o
    auto run_tile = [&](int qtile) {
        const int q0 = qtile * FA_ROWS;
        // keys any row of the tile may see: k <= q_last, k < sk and
        // k > q0 - window
        const int q_last = min(q0 + FA_ROWS, a.sq) - 1;
        const int win = a.window > 0 ? a.window : INT_MAX;
        const int k_lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
        const int k_hi = min(q_last, a.sk - 1);
        const int kt_begin = k_lo / BK;
        const int n_tiles = k_hi >= k_lo ? k_hi / BK - kt_begin + 1 : 0;

        auto load_q = [&]() {
#pragma unroll
            for (int it = 0; it < FA_ROWS * T::CPR / FA_THREADS; ++it) {
                const int idx = tid + it * FA_THREADS;
                const int r = idx / T::CPR, e = idx % T::CPR;
                const bool in = q0 + r < a.sq;
                const float* src = in ? qb + (q0 + r) * a.q_ss + 4 * e : qb;
                cp_async16(q_s + r * T::LD + 4 * e, src, in);
            }
        };
        auto load_kv = [&](int kt, int stage) {
            float* ks = kv_s + stage * (T::K + T::V);
            float* vs = ks + T::K;
            const int k0 = kt * BK;
#pragma unroll
            for (int it = 0; it < BK * T::CPR / FA_THREADS; ++it) {
                const int idx = tid + it * FA_THREADS;
                const int c = idx / T::CPR, e = idx % T::CPR;
                const bool in = k0 + c < a.sk;
                const long long off = in ? (k0 + c) * a.k_ss + 4 * e : 0;
                cp_async16(ks + c * T::LD + 4 * e, kb + off, in);
            }
#pragma unroll
            for (int it = 0; it < BK * T::CPRV / FA_THREADS; ++it) {
                const int idx = tid + it * FA_THREADS;
                const int c = idx / T::CPRV, e = idx % T::CPRV;
                const bool in = k0 + c < a.sk;
                const long long off = in ? (k0 + c) * a.v_ss + 4 * e : 0;
                cp_async16(vs + c * T::LDV + 4 * e, vb + off, in);
            }
        };

        int qpos[RPT];                       // positions of this thread's rows
        float m[RPT], l[RPT], acc[RPT][T::DPT];
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            qpos[i] = q0 + ty + FA_GROUPS * i;
            m[i] = FA_NEG_INF;
            l[i] = 0.0f;
#pragma unroll
            for (int c = 0; c < T::DPT; ++c) acc[i][c] = 0.0f;
        }

        // one KV tile: S = Q K^T (rows ty + FA_GROUPS i, keys tx + 16j),
        // the online softmax, then acc += P V; MASK is false where every
        // key is valid for every row
        auto step = [&](const float* ks, const float* vs, int k0, auto mask) {
            constexpr bool MASK = decltype(mask)::value;
            constexpr int KPT = T::KPT;
            float s[RPT][KPT];
#pragma unroll
            for (int i = 0; i < RPT; ++i)
#pragma unroll
                for (int j = 0; j < KPT; ++j) s[i][j] = 0.0f;
#pragma unroll 4
            for (int d = 0; d < HD; d += 4) {
                float qa[RPT][4], kc[KPT][4];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    load_vec<4>(q_s + (ty + FA_GROUPS * i) * T::LD + d,
                                qa[i]);
#pragma unroll
                for (int j = 0; j < KPT; ++j)
                    load_vec<4>(ks + (tx + 16 * j) * T::LD + d, kc[j]);
#pragma unroll
                for (int e = 0; e < 4; ++e)
#pragma unroll
                    for (int i = 0; i < RPT; ++i)
#pragma unroll
                        for (int j = 0; j < KPT; ++j)
                            s[i][j] = fmaf(qa[i][e], kc[j][e], s[i][j]);
            }

#pragma unroll
            for (int i = 0; i < RPT; ++i) {
                bool valid[KPT];
                float mt = FA_NEG_INF;
#pragma unroll
                for (int j = 0; j < KPT; ++j) {
                    const int kp = k0 + tx + 16 * j;
                    valid[j] = !MASK || (kp <= qpos[i] && kp < a.sk
                                         && qpos[i] - kp < win);
                    s[i][j] = valid[j] ? s[i][j] * a.scale : FA_NEG_INF;
                    mt = fmaxf(mt, s[i][j]);
                }
#pragma unroll
                for (int off = 8; off > 0; off >>= 1)
                    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
                const float m_new = fmaxf(m[i], mt);
                const float alpha = expf(m[i] - m_new);
                float ls = 0.0f;
                float* prow = p_s + (ty + FA_GROUPS * i) * T::LDP + tx;
#pragma unroll
                for (int j = 0; j < KPT; ++j) {
                    const float p = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
                    ls += p;
                    prow[16 * j] = p;
                }
                l[i] = alpha * l[i] + ls;
                m[i] = m_new;
#pragma unroll
                for (int c = 0; c < T::DPT; ++c) acc[i][c] *= alpha;
            }
            __syncwarp();                        // P rows are the warp's own

#pragma unroll 2
            for (int c0 = 0; c0 < BK; c0 += 4) {
                float p[RPT][4];
#pragma unroll
                for (int i = 0; i < RPT; ++i)
                    load_vec<4>(p_s + (ty + FA_GROUPS * i) * T::LDP + c0,
                                p[i]);
#pragma unroll
                for (int cc = 0; cc < 4; ++cc) {
                    float vv[T::DPT];
#pragma unroll
                    for (int g = 0; g < T::NG; ++g)
                        load_vec<T::VEC>(vs + (c0 + cc) * T::LDV
                                         + g * 16 * T::VEC + tx * T::VEC,
                                         vv + g * T::VEC);
#pragma unroll
                    for (int i = 0; i < RPT; ++i)
#pragma unroll
                        for (int c = 0; c < T::DPT; ++c)
                            acc[i][c] = fmaf(p[i][cc], vv[c], acc[i][c]);
                }
            }
        };

        if (n_tiles > 0) {
            load_q();                            // rides with the first tile
#pragma unroll
            for (int t = 0; t < STAGES - 1; ++t) {
                if (t < n_tiles) load_kv(kt_begin + t, t);
                cp_async_commit();
            }
        }
        for (int t = 0; t < n_tiles; ++t) {
            cp_async_wait<STAGES - 2>();         // tile t has landed
            __syncthreads();                     // ... for every thread, and
                                                 // tile t - 1 is consumed
            const int tn = t + STAGES - 1;
            if (tn < n_tiles) load_kv(kt_begin + tn, tn % STAGES);
            cp_async_commit();
            const int k0 = (kt_begin + t) * BK;
            const float* ks = kv_s + (t % STAGES) * (T::K + T::V);
            const float* vs = ks + T::K;
            const bool whole = k0 + BK - 1 <= q0 && k0 + BK <= a.sk
                               && q_last - k0 < win;
            if (whole)
                step(ks, vs, k0, std::false_type{});
            else
                step(ks, vs, k0, std::true_type{});
        }
        cp_async_wait<0>();

        float* ob = a.o + b * a.o_sb + h * a.o_sh;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            float den = l[i];
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                den += __shfl_xor_sync(0xffffffffu, den, off);
            if (qpos[i] >= a.sq) continue;
            const float inv_den = 1.0f / fmaxf(den, 1e-30f);
            float* orow = ob + qpos[i] * a.o_ss;
#pragma unroll
            for (int g = 0; g < T::NG; ++g) {
                float out[T::VEC];
#pragma unroll
                for (int e = 0; e < T::VEC; ++e)
                    out[e] = acc[i][g * T::VEC + e] * inv_den;
                store_vec<T::VEC>(orow + g * 16 * T::VEC + tx * T::VEC, out);
            }
        }
    };

    // the block's query tiles: the one the grid row counts from the end
    // (the longest causal walk first) and, when the launch pairs tiles,
    // the one as far from the start, so that every block walks as many
    // KV tiles as any other
    const int y = blockIdx.y;
    run_tile(a.n_qt - 1 - y);
    if (a.paired && y < a.n_qt - 1 - y) {
        __syncthreads();                     // Q and the ring are free
        run_tile(y);
    }
}

// SMs of the current device, read once per device
int sm_count() {
    static int counts[64];
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (counts[dev] == 0)
        cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return counts[dev];
}

// blocks of flash_attention_kernel<HD, HDV> an SM holds at once, read once
template <int HD, int HDV>
int blocks_per_sm() {
    static int n = 0;
    if (n == 0)
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n, flash_attention_kernel<HD, HDV>, FA_THREADS,
            FaTile<HD, HDV>::BYTES);
    return n;
}

template <int HD, int HDV>
int launch_flash(FaParams a, int batch, cudaStream_t stream) {
    constexpr size_t bytes = FaTile<HD, HDV>::BYTES;
    auto kernel = flash_attention_kernel<HD, HDV>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    a.n_qt = (a.sq + FA_ROWS - 1) / FA_ROWS;
    const long long nx = (long long)batch * a.n_heads;
    if (nx > INT_MAX || a.n_qt > 65535) return (int)cudaErrorInvalidValue;
    // pair the tiles of a causal walk that no window cuts short where one
    // block per tile would put two or more blocks on some SM within one
    // wave (their walks differ up to 2x): a wave of blocks with equal walks
    // replaces them. A window makes the walks about equal, and a grid of
    // several waves is balanced by the heavy-first order; both keep one
    // tile per block (pairing was slower there on an H100, PERF.md).
    const long long blocks = nx * a.n_qt;
    const int sms = sm_count();
    a.paired = (a.window <= 0 || a.window >= a.sq)
               && blocks > sms
               && blocks <= (long long)sms * blocks_per_sm<HD, HDV>();
    const int ny = a.paired ? (a.n_qt + 1) / 2 : a.n_qt;
    kernel<<<dim3((unsigned)nx, (unsigned)ny), FA_THREADS, bytes,
             stream>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// the compiled (q/k head dim, v head dim) pairs; flash_attention.py's
// KERNEL_INSTANCES lists the same
#define FA_INSTANCES(X) \
    X(32, 32) X(64, 64) X(128, 64) X(128, 128) X(192, 128) X(192, 192) \
    X(256, 256)

extern "C" {

// Strides are in floats, (batch, position, head) for q, k, v and o; the
// head dim is contiguous. window <= 0 means no window; scale is hd^-0.5 of
// the true q/k head dim, rounded to f32 by the caller, as the reference
// rounds it. (hd, hd_v) must be one of FA_INSTANCES.
int repro_flash_attention_f32(
        const float* q, const float* k, const float* v, float* o,
        long long q_sb, long long q_ss, long long q_sh, long long k_sb,
        long long k_ss, long long k_sh, long long v_sb, long long v_ss,
        long long v_sh, long long o_sb, long long o_ss, long long o_sh,
        int batch, int sq, int sk, int hd, int hd_v, int n_heads, int n_kv,
        int window, float scale, cudaStream_t stream) {
    if (n_kv < 1 || n_heads % n_kv || batch < 1 || sq < 1 || sk < 1)
        return (int)cudaErrorInvalidValue;
    const FaParams a{q, k, v, o, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                     v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, sq, sk, n_heads,
                     n_heads / n_kv, window, scale, 0, 0};
#define FA_LAUNCH(HD, HDV) \
    if (hd == HD && hd_v == HDV) return launch_flash<HD, HDV>(a, batch, stream);
    FA_INSTANCES(FA_LAUNCH)
#undef FA_LAUNCH
    return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the (hd, hd_v) instance (-1 if not
// compiled).
int repro_flash_attention_shared_bytes(int hd, int hd_v) {
#define FA_BYTES(HD, HDV) \
    if (hd == HD && hd_v == HDV) return (int)FaTile<HD, HDV>::BYTES;
    FA_INSTANCES(FA_BYTES)
#undef FA_BYTES
    return -1;
}

}  // extern "C"
