// Robust-aggregation kernels for Hopper (sm_90a): Gram matrix, Gram-space
// smoothed-Weiszfeld weights and the weighted sum z = w^T X (Krum scores
// and the coordinate-wise reduces are in cw_reduce.cu).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/_build.py). Every entry point takes its
// pointers and the CUDA stream from the caller, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper, which raises.
//
// The aggregation kernels take a leading batch dimension: the JAX package
// vmaps these calls over receivers (one bucketing permutation, or one MDA
// round, per receiver), and one launch here covers the whole batch.
//
// Arithmetic is IEEE f32 (no fast-math): RFA's distances come from the Gram
// identity, and only the smoothing floor nu bounds their cancellation, so
// neither reduced-precision math nor TF32 tensor cores are used. Every sum
// is taken in a fixed order with no atomics, so a rerun is bit-identical.

#include <cuda_runtime.h>

#include <cstdint>
#include <utility>

#include "async_copy.cuh"
#include "fixed_sums.cuh"

namespace {

// ---------------------------------------------------------------------------
// gram: x (bt, k, d) -> g (bt, k, k), g[b, i, j] = sum_c x[b, i, c] x[b, j, c]
//
// Replaces src/repro/kernels/pairwise_dist/pairwise_dist.py::gram
// (_gram_kernel), the d-tiled MXU accumulation with K padded to 8, whose
// sequential grid carries the (K, K) sum across the d tiles.
//
// Bound on the H100: bytes. The stack is read once (4 bt k d bytes) for
// k(k+1)/2 FMA per coordinate: 4.1 FMA per byte read at k = 32 against
// the card's FP32 ratio of about 10 (67 TFLOP/s over 3.35 TB/s), so a
// kernel that reads each byte once and computes each pair once stays
// bound by bytes for every k <= 32. At the main path's (13, 13, 386) the
// whole call moves 260 KB, so the launch bounds it.
//
// Design. d is cut into chunks by the caller's plan (chunk length and
// count, from gram_chunks in pairwise_dist.py, which depends on d alone and
// never on the SM count), so a result's bits depend only on the input, and
// gram_plain follows the same plan. One block per (batch, chunk) reads its
// chunk of all k rows once:
//   * bulk route (d % 4 == 0, chunk % 4 == 0 and a 16-byte aligned base):
//     one warp keeps a ring of shared-memory stages filled with 1-D bulk
//     async copies (cp.async.bulk, one per row segment, one lane per row,
//     completing on an mbarrier), so bytes stay in flight without spending
//     registers; 3 stages deep where two blocks share an SM, 6 where one
//     block does;
//   * direct route (any other d, e.g. 386, whose rows start 8 bytes off a
//     16-byte boundary): threads load their coordinates' k values straight
//     from device memory, coalesced across the warp.
// The kernel is compiled for a few stack heights (GramBuckets); a stack of k
// rows runs on the smallest bucket KB >= k, with k fixed at compile time
// when it is KB and read at run time when it is less. Its pad rows k..KB-1
// are never copied (the bulk route leaves their stage rows as they are, the
// direct route reads row k-1 again), and the pairs they make are summed and
// dropped: no pair of the stack's own rows reads them. Each pair (i <= j) is
// computed once and written to g[i, j] and g[j, i], so G is exactly
// symmetric. Threads hold their pairs in registers (GramPairs<KB>: all pairs
// for KB <= 16, one of four parts of the triangle up to 32), and every warp
// reads the same staged tile, so device memory still sees each byte once.
// Both routes visit a thread's coordinates in the same order, so they give
// the same bits, and so do the buckets up to 16 (one role each). A block
// reduces each pair with a shuffle-down tree per warp, stores the warp sums
// to shared memory, then sums each role's warps in a fixed order. With one
// chunk (the main path) the block writes G itself: one launch. With more,
// blocks write a (bt, k(k+1)/2, n_chunks) workspace and gram_reduce_kernel
// sums it in one fixed order: lane l of a warp sums chunks l, l + 32, ... in
// sequence, then a xor butterfly over the lanes. No atomics anywhere, so a
// rerun is bit-identical.
// ---------------------------------------------------------------------------
constexpr int GRAM_MAX_STAGES = 6;       // shared-memory ring of the bulk route
constexpr int GRAM_REDUCE_WARPS = 8;     // pairs per block of the second pass
// the stack heights gram_chunk_kernel is compiled for (the last, 32, is
// the largest stack the kernels take)
// (7 and 13, the main path's stacks, ran up to 35% slower on an H100 on the
// next larger height)
using GramBuckets = std::integer_sequence<int, 4, 7, 8, 13, 16, 24, 32>;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
    return v;
}

// pair index of (i, j), i <= j < k, row-major over the upper triangle
__device__ __forceinline__ int pair_index(int i, int j, int k) {
    return i * k - i * (i - 1) / 2 + (j - i);
}

// The pairs of K rows (a bucket's height) and the threads that sum them.
// For K <= 16 one role:
// every thread holds all K(K+1)/2 pairs of its coordinates (at most 136
// accumulators) and the 8 warps split the coordinates. For K > 16 the rows
// split into A = [0, H) and B = [H, K), H = ceil(K/2), B into B1 and B2, and
// four roles of two warps each take the triangles AxA and BxB and the
// rectangles AxB1 and AxB2: each pair is computed once, every role holds at
// most 136 accumulators and loads at most 24 rows, and the roles' work
// differs by a few pairs. A role's two warps split the coordinates.
template <int K>
struct GramPairs {
    static constexpr bool SPLIT = K > 16;
    static constexpr int ROLES = SPLIT ? 4 : 1;
    static constexpr int THREADS = 256;
    static constexpr int ROLE_THREADS = THREADS / ROLES;
    static constexpr int H = (K + 1) / 2, B = K - H, B1 = (B + 1) / 2,
                         B2 = B - B1;
    static constexpr int MAXP = SPLIT ? H * (H + 1) / 2 : K * (K + 1) / 2;
    static constexpr int ROLE_ROWS = SPLIT ? H + B1 : K;
    static constexpr int MIN_BLOCKS = MAXP + ROLE_ROWS <= 104 ? 2 : 1;
    static constexpr int TILE = SPLIT ? 256 : 512;   // coordinates a stage
    // ring depth: a block alone on its SM keeps more bytes in flight
    static constexpr int STAGES = MIN_BLOCKS == 1 ? GRAM_MAX_STAGES : 3;
    static constexpr int SCRATCH_BYTES = (THREADS / 32) * MAXP * 4;
    float acc[MAXP];

    __device__ GramPairs() {
#pragma unroll
        for (int p = 0; p < MAXP; ++p) acc[p] = 0.0f;
    }

    // rows [i0, i0 + N) against themselves (TRI) or against [j0, j0 + M)
    template <int N, int M, bool TRI, class Src>
    __device__ void run(const Src& src, int i0, int j0, int len) {
        for (int c = threadIdx.x % ROLE_THREADS; c < len;
             c += ROLE_THREADS) {
            float a[N], b[TRI ? 1 : M];
#pragma unroll
            for (int r = 0; r < N; ++r) a[r] = src(i0 + r, c);
            if constexpr (TRI) {
                int p = 0;
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int j = i; j < N; ++j, ++p)
                        acc[p] = fmaf(a[i], a[j], acc[p]);
                }
            } else {
#pragma unroll
                for (int r = 0; r < M; ++r) b[r] = src(j0 + r, c);
#pragma unroll
                for (int i = 0; i < N; ++i) {
#pragma unroll
                    for (int j = 0; j < M; ++j)
                        acc[i * M + j] = fmaf(a[i], b[j], acc[i * M + j]);
                }
            }
        }
    }

    template <class Src>
    __device__ void consume(const Src& src, int len) {
        if constexpr (!SPLIT) {
            run<K, K, true>(src, 0, 0, len);
        } else {
            switch (threadIdx.x / ROLE_THREADS) {
                case 0: run<H, H, true>(src, 0, 0, len); break;
                case 1: run<B, B, true>(src, H, H, len); break;
                case 2: run<H, B1, false>(src, 0, H, len); break;
                default: run<H, B2, false>(src, 0, H + B1, len); break;
            }
        }
    }

    // warp sums (a shuffle-down tree per pair), then a fixed-order sum over
    // each role's warps; out(i, j, value) for every pair, i <= j
    template <class Out>
    __device__ void finish(float* scratch, const Out& out) {
        const int lane = threadIdx.x & 31;
        const int warp = threadIdx.x >> 5;
        // one pair at a time, so the sums need no registers beyond acc
#pragma unroll
        for (int p = 0; p < MAXP; ++p) {
            float v = acc[p];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, off);
            if (lane == 0) scratch[warp * MAXP + p] = v;
            __syncwarp();
        }
        __syncthreads();
        constexpr int WARPS = ROLE_THREADS / 32;
        for (int idx = threadIdx.x; idx < ROLES * MAXP; idx += THREADS) {
            const int role = idx / MAXP, p = idx - role * MAXP;
            // the role's rows [i0, i0 + n) and columns [j0, j0 + m)
            const int i0 = role == 1 ? H : 0;
            const int n = !SPLIT ? K : role == 1 ? B : H;
            const int j0 = role == 2 ? H : role == 3 ? H + B1 : i0;
            const int m = !SPLIT ? K : role == 2 ? B1 : role == 3 ? B2 : n;
            const bool tri = role < 2;
            if (p >= (tri ? n * (n + 1) / 2 : n * m)) continue;
            float s = 0.0f;
#pragma unroll
            for (int w = 0; w < WARPS; ++w)
                s += scratch[(role * WARPS + w) * MAXP + p];
            int i, j;
            if (tri) {
                int rem = p;
                i = 0;
                while (rem >= n - i) { rem -= n - i; ++i; }
                j = i + rem;
                i += i0;
                j += i0;
            } else {
                i = i0 + p / m;
                j = j0 + p % m;
            }
            out(i, j, s);
        }
    }
};

// First pass: block (chunk, b) sums its chunk's products for a stack of
// k <= K rows; without PAD, k is K at compile time (an exact height runs
// the code of a kernel built for its k alone). `bulk` picks the route (the
// launcher checks alignment); `ws` is null when n_chunks == 1.
template <int K, bool PAD>
__global__ void __launch_bounds__(GramPairs<K>::THREADS,
                                  GramPairs<K>::MIN_BLOCKS)
gram_chunk_kernel(const float* __restrict__ x, float* __restrict__ g,
                  float* __restrict__ ws, int k_rows, long long d,
                  int chunk_len, int n_chunks, int bulk) {
    using Acc = GramPairs<K>;
    const int k = PAD ? k_rows : K;
    extern __shared__ __align__(128) float smem[];
    __shared__ __align__(8) uint64_t full[GRAM_MAX_STAGES];
    constexpr int TILE = Acc::TILE, STAGES = Acc::STAGES;
    constexpr int STAGE = K * TILE;              // floats per stage
    const int chunk = blockIdx.x;
    const long long b = blockIdx.y;
    const long long c0 = (long long)chunk * chunk_len;
    const int len = (int)min((long long)chunk_len, d - c0);
    const float* xb = x + b * k * d + c0;
    Acc acc;

    if (bulk) {
        const int n_tiles = (len + TILE - 1) / TILE;
        if (threadIdx.x == 0) {
            for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
            asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
        }
        __syncthreads();
        // warp 0 fills a stage: lane 0 arms the barrier with the stage's
        // bytes, then lane r < k copies row r (k <= 32)
        const int lane = threadIdx.x & 31;
        auto issue = [&](int t) {
            const int s = t % STAGES;
            const int tlen = min(TILE, len - t * TILE);
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            if (lane == 0) mbar_expect_tx(&full[s], (uint32_t)(k * tlen * 4));
            __syncwarp();
            if (lane < k)
                bulk_load(smem + s * STAGE + lane * TILE,
                          xb + (long long)lane * d + (long long)t * TILE,
                          (uint32_t)(tlen * 4), &full[s]);
        };
        if (threadIdx.x < 32) {
            for (int t = 0; t < STAGES && t < n_tiles; ++t) issue(t);
        }
        for (int t = 0; t < n_tiles; ++t) {
            const int s = t % STAGES;
            mbar_wait(&full[s], (uint32_t)((t / STAGES) & 1));
            const float* xs = smem + s * STAGE;
            acc.consume([xs](int r, int c) { return xs[r * TILE + c]; },
                        min(TILE, len - t * TILE));
            __syncthreads();                     // stage s is free again
            if (threadIdx.x < 32 && t + STAGES < n_tiles)
                issue(t + STAGES);
        }
    } else {
        acc.consume([xb, k, d](int r, int c) {      // pad rows repeat row k-1
            return __ldg(xb + (long long)min(r, k - 1) * d + c);
        }, len);
    }

    const int n_pairs = k * (k + 1) / 2;
    acc.finish(smem, [=](int i, int j, float v) {
        if (j >= k) return;                      // a pair with a pad row
        if (n_chunks == 1) {
            g[(b * k + i) * k + j] = v;
            g[(b * k + j) * k + i] = v;
        } else {
            ws[(b * n_pairs + pair_index(i, j, k)) * n_chunks + chunk] = v;
        }
    });
}

// Second pass: warp (pair p, batch b) sums the n_chunks partials of p in
// one fixed order and writes both triangles.
__global__ void __launch_bounds__(32 * GRAM_REDUCE_WARPS)
gram_reduce_kernel(const float* __restrict__ ws, float* __restrict__ g,
                   int k, int n_chunks) {
    const int n_pairs = k * (k + 1) / 2;
    const int p = blockIdx.x * GRAM_REDUCE_WARPS + (threadIdx.x >> 5);
    if (p >= n_pairs) return;                    // the whole warp leaves
    const int lane = threadIdx.x & 31;
    const long long b = blockIdx.y;
    const float* row = ws + (b * n_pairs + p) * n_chunks;
    float s = 0.0f;
    for (int c = lane; c < n_chunks; c += 32) s += row[c];
    s = warp_sum(s);
    if (lane == 0) {
        int i = 0, rem = p;
        while (rem >= k - i) { rem -= k - i; ++i; }
        const int j = i + rem;
        g[(b * k + i) * k + j] = s;
        g[(b * k + j) * k + i] = s;
    }
}

template <int K, bool PAD>
int launch_gram(const float* x, float* g, float* ws, int bt, int k,
                long long d, int chunk_len, int n_chunks,
                cudaStream_t stream) {
    using Acc = GramPairs<K>;
    const int bulk = d % 4 == 0 && chunk_len % 4 == 0
        && reinterpret_cast<uintptr_t>(x) % 16 == 0;
    const int bulk_bytes = Acc::STAGES * K * Acc::TILE * 4;
    static bool attr_set[64] = {};   // per instantiation and device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
        e = cudaFuncSetAttribute(gram_chunk_kernel<K, PAD>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 bulk_bytes);
        if (e != cudaSuccess) return (int)e;
        attr_set[dev] = true;
    }
    gram_chunk_kernel<K, PAD><<<dim3((unsigned)n_chunks, bt), Acc::THREADS,
                                bulk ? bulk_bytes : Acc::SCRATCH_BYTES,
                                stream>>>(
        x, g, ws, k, d, chunk_len, n_chunks, bulk);
    e = cudaGetLastError();
    if (e != cudaSuccess || n_chunks == 1) return (int)e;
    const int n_pairs = k * (k + 1) / 2;
    gram_reduce_kernel<<<dim3((n_pairs + GRAM_REDUCE_WARPS - 1)
                              / GRAM_REDUCE_WARPS, bt),
                         32 * GRAM_REDUCE_WARPS, 0, stream>>>(
        ws, g, k, n_chunks);
    return (int)cudaGetLastError();
}

// launches the smallest bucket that holds k rows
template <int... KBs>
int gram_for_k(const float* x, float* g, float* ws, int bt, int k,
               long long d, int chunk_len, int n_chunks, cudaStream_t stream,
               std::integer_sequence<int, KBs...>) {
    int status = (int)cudaErrorInvalidValue;      // k outside [1, 32]
    bool done = k < 1;
    ((!done && k <= KBs
      ? (done = true,
         status = k == KBs
             ? launch_gram<KBs, false>(x, g, ws, bt, k, d, chunk_len,
                                       n_chunks, stream)
             : launch_gram<KBs, true>(x, g, ws, bt, k, d, chunk_len,
                                      n_chunks, stream),
         0) : 0), ...);
    return status;
}

// ---------------------------------------------------------------------------
// weiszfeld: g (bt, k, k), nu (bt,), n_iter -> w (bt, k)
//
// Replaces src/repro/kernels/rfa/rfa.py::rfa_pallas, first pallas_call
// (_weiszfeld_kernel): n_iter smoothed-Weiszfeld steps in weight space,
//   gw = G w,  d2 = max(diag - 2 gw + w^T gw, 0),  iw = 1 / sqrt(d2 + nu),
//   w  = iw / sum(iw),                              from w0 = 1/k,
// with the smoothing floor nu of batch element b read from nu[b]: one
// value for a whole batch (the caller fills the array), or one per row of
// a lane group that sweeps rfa(nu=...).
//
// Bound on the H100: k <= 32 and n_iter of about 32 make this a chain of
// n_iter dependent steps of one warp, each a few hundred cycles of latency
// (shuffles, IEEE sqrt and divisions) on a few hundred FLOP: latency, not
// bytes or operations, bounds it, whatever the batch.
//
// Design: one warp per batch element; lane j holds row j of G in H
// registers, loaded once, so a step reads no memory. The kernel is
// compiled for heights H = 8, 16 and 32 with k <= H read at run time, and
// the caller's plan (rfa.py::weiszfeld_instance) picks the smallest that
// holds k (exact instances for k = 7 and 13 ran within 1.4% of heights 8
// and 16 on an H100, PERF.md). In a step the H weights reach every lane
// through H independent __shfl_syncs, issued together (no shared memory,
// no __syncwarp: a float4 broadcast through shared memory ran 2-5% slower
// at heights 8 and 16, 3% faster at 32). Each of the three sums (gw_j
// over l, w^T gw over j, sum(iw) over j) is a halving tree over the H
// slots, slot i += slot i + h for h = H/2 .. 1 (fixed_sums.cuh), with -0.0
// in the pad slots (x + -0 is x for every x, so the bits do not depend on
// H); the two sums over lanes are xor butterflies, which leave the tree's
// bits in every lane. Every operation is an IEEE intrinsic (__fmul_rn, __fadd_rn, __fsqrt_rn, __fdiv_rn: no
// contraction into FMA, no fast math), so rfa.py::weiszfeld_plain, which
// does the same operations in the same order, gives the same bits. The
// clamp keeps NaN, as the reference's jnp.maximum does.
// ---------------------------------------------------------------------------
template <int H>
__global__ void __launch_bounds__(32)
weiszfeld_kernel(const float* __restrict__ g, const float* __restrict__ nus,
                 float* __restrict__ w_out, int k, int n_iter) {
    static_assert(H == pow2_at_least(H), "a height is a power of two");
    const long long b = blockIdx.x;
    const int j = threadIdx.x;
    const bool valid = j < k;
    const float* gb = g + b * k * k;
    const float nu = __ldg(nus + b);
    // pad entries (columns >= k of a row, and pad rows) hold -0.0: a pad
    // lane's weight is +0, so every product with a pad is -0.0, which adds
    // exactly, and no step needs a per-slot test of k
    float row[H];
#pragma unroll
    for (int l = 0; l < H; ++l)
        row[l] = valid && l < k ? __ldg(gb + j * k + l) : -0.0f;
    const float diag = valid ? __ldg(gb + j * k + j) : 0.0f;
    float w = valid ? __fdiv_rn(1.0f, (float)k) : 0.0f;

    for (int it = 0; it < n_iter; ++it) {
        float p[H];
#pragma unroll
        for (int l = 0; l < H; ++l)
            p[l] = __fmul_rn(row[l], __shfl_sync(0xffffffffu, w, l));
        const float gw = tree_sum(p);     // a pad lane's gw is -0.0
        const float wgw = lane_sum<H>(__fmul_rn(w, gw));
        const float d2 = clamp0(
            __fadd_rn(__fsub_rn(diag, __fmul_rn(2.0f, gw)), wgw));
        const float iw = valid
            ? __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(d2, nu))) : -0.0f;
        // every lane takes part in the butterfly (outside the select: a
        // shuffle under `valid` would leave the pad lanes out of it)
        const float tot = lane_sum<H>(iw);
        w = valid ? __fdiv_rn(iw, tot) : 0.0f;
    }
    if (valid) w_out[b * k + j] = w;
}

// ---------------------------------------------------------------------------
// wsum: x (bt, k, d), w (bt, k) -> z (bt, d), z[b, c] = sum_j w[b, j] x[b, j, c]
//
// Replaces src/repro/kernels/rfa/rfa.py::rfa_pallas, second pallas_call
// (_wsum_kernel), the d-tiled (1, Kp) x (Kp, block_d) product.
//
// Bound on the H100: bytes, (k + 1) floats moved per 2k FLOP; the launch at
// the main path's d = 386.
//
// Design: each thread owns 4 neighbouring coordinates and reads them as one
// 16-byte load per row (vector route: d % 4 == 0, 16-byte aligned x and z,
// and at least WSUM_VEC_MIN coordinates in all), or one coordinate with
// 4-byte loads (scalar route, any other stack). Rows are read in groups
// whose loads are issued together (16 rows on the scalar route, 8 on the
// vector route), and the sum over j keeps one fixed order, j = 0 .. k-1,
// so every route gives the same bits. The weights are read through the
// read-only cache, in the same group as the rows, so no load waits for
// them. The grid covers a large d in
// about two waves of resident blocks and threads stride over the rest; the
// result does not depend on the grid.
// ---------------------------------------------------------------------------
constexpr int WSUM_THREADS = 256;
// smallest stack (bt * d) for the vector route: from here a quarter as many
// threads still fill every SM; below it, one coordinate a thread spreads a
// small stack over more SMs (the vector route ran 10% slower at
// (13, 13, 4868) on the H100)
constexpr long long WSUM_VEC_MIN = 1LL << 20;

template <class V>
__device__ __forceinline__ void fma_into(V& s, float w, const V& v);

template <>
__device__ __forceinline__ void fma_into<float>(float& s, float w,
                                                const float& v) {
    s = fmaf(w, v, s);
}

template <>
__device__ __forceinline__ void fma_into<float4>(float4& s, float w,
                                                 const float4& v) {
    s.x = fmaf(w, v.x, s.x);
    s.y = fmaf(w, v.y, s.y);
    s.z = fmaf(w, v.z, s.z);
    s.w = fmaf(w, v.w, s.w);
}

// V is float (one coordinate a unit) or float4 (four); n = d / (units of V)
template <class V>
__global__ void __launch_bounds__(WSUM_THREADS)
wsum_kernel(const float* __restrict__ x, const float* __restrict__ w,
            float* __restrict__ z, int k, long long d, long long n) {
    const long long b = blockIdx.y;
    const float* wb = w + b * k;
    const V* xb = reinterpret_cast<const V*>(x + b * k * d);
    V* zb = reinterpret_cast<V*>(z + b * d);
    const long long row = d * sizeof(float) / sizeof(V);
    const long long stride = (long long)gridDim.x * WSUM_THREADS;
    for (long long q = (long long)blockIdx.x * WSUM_THREADS + threadIdx.x;
         q < n; q += stride) {
        V s{};
        // rows whose loads a thread issues together: every row of a
        // stack of K <= 16 in one group on the scalar route
        constexpr int WSUM_ROWS = sizeof(V) == sizeof(float) ? 16 : 8;
        for (int j0 = 0; j0 < k; j0 += WSUM_ROWS) {
            V v[WSUM_ROWS];
#pragma unroll
            for (int u = 0; u < WSUM_ROWS; ++u) {
                if (j0 + u < k) v[u] = __ldg(xb + (j0 + u) * row + q);
            }
#pragma unroll
            for (int u = 0; u < WSUM_ROWS; ++u) {
                if (j0 + u < k) fma_into(s, __ldg(wb + j0 + u), v[u]);
            }
        }
        zb[q] = s;
    }
}

template <class V>
int launch_wsum(const float* x, const float* w, float* z, int bt, int k,
                long long d, cudaStream_t stream) {
    static int resident[64] = {};   // blocks resident on the card, per device
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (resident[dev] == 0) {
        int n_sm = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                   dev);
        if (e == cudaSuccess)
            e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, wsum_kernel<V>, WSUM_THREADS, 0);
        if (e != cudaSuccess) return (int)e;
        resident[dev] = n_sm * per_sm > 0 ? n_sm * per_sm : 1;
    }
    const long long n = d * (long long)sizeof(float) / (long long)sizeof(V);
    const long long need = (n + WSUM_THREADS - 1) / WSUM_THREADS;
    const long long waves2 = (2LL * resident[dev] + bt - 1) / bt;
    const long long blocks = need < waves2 ? need : waves2;
    wsum_kernel<V><<<dim3((unsigned)blocks, bt), WSUM_THREADS, 0, stream>>>(
        x, w, z, k, d, n);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The plan: n_chunks chunks of chunk_len coordinates, the last one ragged
// (pairwise_dist.py::gram_chunks). ws: a (bt, k(k+1)/2, n_chunks) workspace
// when n_chunks > 1, else unused (may be null).
int repro_gram_f32(const float* x, float* g, float* ws, int bt, int k,
                   long long d, int chunk_len, int n_chunks,
                   cudaStream_t stream) {
    if (chunk_len < 1 || n_chunks < 1
        || (long long)(n_chunks - 1) * chunk_len >= d
        || (long long)n_chunks * chunk_len < d
        || (n_chunks > 1 && ws == nullptr))
        return (int)cudaErrorInvalidValue;       // not a plan that covers d
    return gram_for_k(x, g, ws, bt, k, d, chunk_len, n_chunks, stream,
                      GramBuckets{});
}

// `height` is the instance (rfa.py::weiszfeld_instance(k)): 8, 16 or 32,
// holding k. `nu` holds bt floats, one per batch element.
int repro_weiszfeld_f32(const float* g, const float* nu, float* w, int bt,
                        int k, int n_iter, int height, cudaStream_t stream) {
    if (bt < 1 || n_iter < 0 || k < 1 || k > height)
        return (int)cudaErrorInvalidValue;
    switch (height) {
        case 8:
            weiszfeld_kernel<8><<<bt, 32, 0, stream>>>(g, nu, w, k, n_iter);
            break;
        case 16:
            weiszfeld_kernel<16><<<bt, 32, 0, stream>>>(g, nu, w, k, n_iter);
            break;
        case 32:
            weiszfeld_kernel<32><<<bt, 32, 0, stream>>>(g, nu, w, k, n_iter);
            break;
        default: return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

int repro_wsum_f32(const float* x, const float* w, float* z, int bt, int k,
                   long long d, cudaStream_t stream) {
    const bool vec = d % 4 == 0 && (long long)bt * d >= WSUM_VEC_MIN
        && reinterpret_cast<uintptr_t>(x) % 16 == 0
        && reinterpret_cast<uintptr_t>(z) % 16 == 0;
    return vec ? launch_wsum<float4>(x, w, z, bt, k, d, stream)
               : launch_wsum<float>(x, w, z, bt, k, d, stream);
}

const char* repro_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
