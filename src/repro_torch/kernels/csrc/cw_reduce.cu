// The coordinate-wise reduces for Hopper (sm_90a): the trimmed mean over a
// stack's agents and the gossip reduces of the cw* agreement rounds, all
// through one rank network specialised on the slot count, and Krum's
// scores, which rank each row of D^2 through the same network.
//
// Plain C interface, built with nvcc into the port's shared library and
// loaded with ctypes (repro_torch/kernels/_build.py). Every entry point
// takes its pointers and the CUDA stream from the caller, allocates
// nothing, does not synchronise, and returns cudaGetLastError(), or
// cudaErrorInvalidValue for an instance it does not have.
//
// Arithmetic is IEEE f32 (no fast-math). Each sum is taken in slot order
// with no atomics, so a rerun is bit-identical and the plain versions
// (kernels/gossip_reduce/cw_reduce.py::cw_reduce_plain) give the same bits.

#include <cuda_runtime.h>

#include <type_traits>

#include "fixed_sums.cuh"

namespace {

constexpr float PAD_BIG = 3.4e38f;
// threads a block of the gossip reduces: at the main path's d = 386, 128
// spread the 13 receivers' coordinates over 52 blocks, and ran 6-20% faster
// there than 256 on an H100 (PERF.md), as fast at 2^22
constexpr int CW_THREADS = 128;
// the trimmed mean keeps its launch (256 threads a block) and changes only
// its reduce
constexpr int TM_THREADS = 256;
enum : int { CW_MEAN = 0, CW_MEDIAN = 1, CW_TRIMMED = 2 };

// ---------------------------------------------------------------------------
// The reduce: the counterpart of the JAX package's
// kernels/gossip_reduce/ref.py::cw_reduce, which its three Pallas kernels
// share. Over P slots of one coordinate, n of them valid (slots >= n are
// pad, ranked last and never kept), the rank of a valid slot b is
//   rank_b = sum_a [xv_a < v_b  or  (xv_a == v_b and a < b)],
// with xv the values whose pad slots hold 3.4e38 (the masked xv on the
// left of <, the unmasked v on the right), and the kept values are summed
// in slot order:
//   mean     sum_{a<n} v_a / n
//   median   (v at rank (n-1)/2 + v at rank n/2) / 2
//   trimmed  sum of v at ranks [n_trim, n - n_trim), / (n - 2 n_trim)
// For finite values the ranks are a permutation of [0, n), so no sort is
// needed; a NaN ranks 0 and counts before nothing.
//
// Instances. The network is compiled for a height H: exact (n = H fixed at
// compile time, no guard) for the P the main path runs, 5 (ring(k=4)) and
// 13 (the complete graph at K = 13), and padded (n <= H read at run time)
// for H in {8, 16, 32}, which cover every P <= 32. The caller's plan picks
// the smallest instance that holds n (cw_reduce.py::cw_instance). Inside an
// instance the slots [n, H) hold +inf, which no valid slot counts before
// (+inf < v is false, and v <= +inf holds, see cw_ranks), and their ranks
// are never used. The pad slots of a P > n ranking (the trimmed mean's,
// n = k padded to a multiple of 8) are counted in closed form: a pad a >= n
// > b counts before a valid b exactly when PAD_BIG < v_b (a < b is false),
// so rank_b gains (P - n) [v_b > PAD_BIG], which is only v_b = +inf.
//
// Bound on the H100: P^2 compares per coordinate (one operation each, the
// bound chip_smoke.py writes) against (P + 1) floats moved; at P = 13 the
// compares bound it. Each pair of slots costs one FSET and two FADDs.
// ---------------------------------------------------------------------------

// 1.0f when a <= b, else 0.0f (also for a NaN on either side).
// One FSET each: the rank network counts in f32, whose adds run on the FMA
// pipe beside the compares (counts up to 32 are exact); int masks took an
// FSETP, a SEL and an IADD3 a step, 1.459 against 1.116 ms at (13, 2^22),
// P 13, on an H100 (PERF.md).
__device__ __forceinline__ float le_one(float a, float b) {
    float c;
    asm("set.le.f32.f32 %0, %1, %2;" : "=f"(c) : "f"(a), "f"(b));
    return c;
}

// What a mode keeps of the slots, by rank (held in f32), summed in slot
// order, and the result.
struct CwKeep {
    int mode, n;
    float lo, hi;           // median: ranks lo and hi; trimmed: [lo, hi]

    __device__ CwKeep(int mode_, int n_, int n_trim) : mode(mode_), n(n_) {
        const bool median = mode == CW_MEDIAN;
        lo = (float)(median ? (n - 1) / 2 : n_trim);
        hi = (float)(median ? n / 2 : n - n_trim - 1);
    }

    // rank(b) and value(b) for the slots b < n (all H when EXACT)
    template <int H, bool EXACT, class Rank, class Value>
    __device__ __forceinline__ float reduce(const Rank& rank,
                                            const Value& value) const {
        float s = 0.0f, s_hi = 0.0f;
        if (mode == CW_MEAN) {
#pragma unroll
            for (int b = 0; b < H; ++b) {
                if (EXACT || b < n) s += value(b);
            }
            return s / (float)n;
        }
        if (mode == CW_MEDIAN) {
#pragma unroll
            for (int b = 0; b < H; ++b) {
                if (EXACT || b < n) {
                    const float r = rank(b), v = value(b);
                    s += r == lo ? v : 0.0f;
                    s_hi += r == hi ? v : 0.0f;
                }
            }
            return 0.5f * (s + s_hi);
        }
#pragma unroll
        for (int b = 0; b < H; ++b) {
            if (EXACT || b < n) {
                const float r = rank(b);
                s += (r >= lo && r <= hi) ? value(b) : 0.0f;
            }
        }
        return s / (float)(n - 2 * (int)lo);
    }
};

// The ranks of H slots, each pair (i < j) compared once: c = [v_i <= v_j]
// counts slot i before j, and, when neither is NaN, 1 - c counts j before
// i ([v_j < v_i]); the tie term folds away because i < j is known at
// compile time. A NaN slot is repaired by the caller (cw_fix_nan).
template <int H>
__device__ __forceinline__ void cw_ranks(const float (&v)[H],
                                         float (&r)[H]) {
#pragma unroll
    for (int i = 0; i < H; ++i) r[i] = (float)(H - 1 - i);
#pragma unroll
    for (int i = 0; i < H; ++i) {
#pragma unroll
        for (int j = i + 1; j < H; ++j) {
            const float c = le_one(v[i], v[j]);
            r[j] += c;
            r[i] -= c;
        }
    }
}

// cw_ranks assumed no NaN: a NaN slot's rank is 0, and every other slot
// counted each NaN j after it once too often.
template <int H>
__device__ __forceinline__ void cw_fix_nan(const float (&v)[H],
                                           float (&r)[H]) {
    float after = 0.0f;
#pragma unroll
    for (int i = H - 1; i >= 0; --i) {
        const bool nan = v[i] != v[i];
        r[i] = nan ? 0.0f : r[i] - after;
        after += nan ? 1.0f : 0.0f;
    }
}

// One thread reduces one coordinate: load(j) reads slot j < n; pads = P - n.
template <int H, bool EXACT, class Load>
__device__ __forceinline__ float cw_reduce_thread(const Load& load, int n,
                                                  int pads, int mode,
                                                  int n_trim) {
    if (EXACT) n = H;
    float v[H];
    float t = 0.0f;                  // NaN when a valid slot is NaN or inf
#pragma unroll
    for (int j = 0; j < H; ++j) {
        const bool valid = EXACT || j < n;
        v[j] = valid ? load(j) : __int_as_float(0x7f800000);
        if (valid) t = fmaf(v[j], 0.0f, t);
    }
    const CwKeep keep(mode, n, n_trim);
    const auto value = [&](int b) { return v[b]; };
    float r[H];
    if (mode != CW_MEAN) {
        cw_ranks(v, r);
        if (t != t) cw_fix_nan(v, r);
        if (pads) {
#pragma unroll
            for (int j = 0; j < H; ++j) {
                r[j] += v[j] > PAD_BIG ? (float)pads : 0.0f;
            }
        }
    }
    return keep.reduce<H, EXACT>([&](int b) { return r[b]; }, value);
}

// ---------------------------------------------------------------------------
// trimmed_mean: x (bt, k, d), n_trim -> out (bt, d), per coordinate the mean
// of ranks [n_trim, k - n_trim) over the k agents.
//
// Replaces src/repro/kernels/trimmed_mean/trimmed_mean.py::trimmed_mean_pallas
// (_tm_kernel): cw_reduce(..., "trimmed", n_valid=K) over a K-padded,
// d-tiled block. The agent axis is ranked as the Pallas kernel ranks it,
// padded to kp = K rounded up to 8 with pad slots last (in closed form).
//
// Design: one thread per (b, c); thread c reads x[b, j, c] for j < k, so a
// warp's loads of one row are coalesced, and every byte is read once.
//
// Bound on the H100: k^2 compares per coordinate against k + 1 floats
// moved: at k = 13 the compares bound it. Launch latency at the main
// path's d = 386.
// ---------------------------------------------------------------------------
template <int H, bool EXACT>
__global__ void __launch_bounds__(TM_THREADS)
trimmed_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int k, long long d, int n_trim) {
    const long long c = (long long)blockIdx.x * TM_THREADS + threadIdx.x;
    const long long b = blockIdx.y;
    if (c >= d) return;
    const float* xb = x + b * k * d + c;
    const int kp = (k + 7) & ~7;
    out[b * d + c] = cw_reduce_thread<H, EXACT>(
        [=](int j) { return xb[(long long)j * d]; }, k, kp - k, CW_TRIMMED,
        n_trim);
}

// ---------------------------------------------------------------------------
// gossip_reduce: msgs (k, d), nbr (k, p) int64, mode, n_trim -> out (k, d),
// out[r, c] = reduce over p of msgs[nbr[r, p], c].
//
// Replaces src/repro/kernels/gossip_reduce/gossip_reduce.py::
// gossip_reduce_pallas (_gather_reduce_kernel), which gathers the
// neighbour rows with p one-hot (K, K) matmuls on the MXU because row
// gathers lower poorly on a TPU. Hopper loads indexed rows directly, so the
// one-hot products are gone, and the gathered (k, p, d) tensor never exists
// in device memory.
//
// Design: blockIdx.y is the receiver r, and the block reads nbr[r, :] into
// shared memory once; thread c reads msgs[nbr[r, q], c] for q < p,
// coalesced across c, and reduces in registers. An index outside [0, k) is
// not followed: the receiver's row comes out NaN instead. One thread per
// coordinate: a layout that spread each coordinate's P^2 compares over P
// warps (one warp per slot, ranks through shared memory) ran 10% slower at
// the main path's (13, 386) and 4.7x slower at (13, 2^22) on an H100
// (PERF.md), since the one-thread kernel is already at the launch's floor
// where the other would gain from more SMs.
//
// Bound on the H100: the messages are read p times each, from L2 where
// they fit, so the device-memory bytes are one read of msgs and one write
// of out, and the p^2 compares per coordinate bound it. Launch latency at
// the main path's sizes.
// ---------------------------------------------------------------------------
template <int H, bool EXACT>
__global__ void __launch_bounds__(CW_THREADS)
gossip_reduce_kernel(const float* __restrict__ msgs,
                     const long long* __restrict__ nbr,
                     float* __restrict__ out, int k, int p, long long d,
                     int mode, int n_trim) {
    __shared__ long long rows[H];
    const long long r = blockIdx.y;
    int bad = 0;
    if (threadIdx.x < p) {
        const long long q = nbr[r * p + threadIdx.x];
        bad = q < 0 || q >= k;
        rows[threadIdx.x] = bad ? 0 : q;
    }
    bad = __syncthreads_or(bad);
    const long long c = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
    if (c >= d) return;
    const float v = cw_reduce_thread<H, EXACT>(
        [&](int j) { return msgs[rows[j] * d + c]; }, p, 0, mode, n_trim);
    out[r * d + c] = bad ? __int_as_float(0x7fc00000) : v;
}

// ---------------------------------------------------------------------------
// neighbor_reduce: recv (k, p, d), mode, n_trim -> out (k, d), the reduce
// over an already gathered tensor (the per-receiver equivocation path).
//
// Replaces src/repro/kernels/gossip_reduce/gossip_reduce.py::
// neighbor_reduce_pallas (_reduce_kernel).
//
// Design: as gossip_reduce's: thread (r, c) reads recv[r, q, c] for q < p,
// coalesced across c.
//
// Bound on the H100: p^2 compares per coordinate against p + 1 floats
// moved: the compares at p = 13. Launch latency at the main path's sizes.
// ---------------------------------------------------------------------------
template <int H, bool EXACT>
__global__ void __launch_bounds__(CW_THREADS)
neighbor_reduce_kernel(const float* __restrict__ recv,
                       float* __restrict__ out, int p, long long d, int mode,
                       int n_trim) {
    const long long c = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
    const long long r = blockIdx.y;
    if (c >= d) return;
    const float* rr = recv + r * p * d + c;
    out[r * d + c] = cw_reduce_thread<H, EXACT>(
        [=](int j) { return rr[(long long)j * d]; }, p, 0, mode, n_trim);
}

// ---------------------------------------------------------------------------
// krum_score: g (bt, k, k) Gram matrices, n_near -> scores (bt, k),
// score_i = the sum of the n_near smallest off-self squared distances of
// row i.
//
// Replaces src/repro/kernels/krum_score/krum_score.py::krum_scores_pallas
// (_score_kernel), which ranks each row of the K-padded D^2 with an O(K^2)
// comparison network and sums ranks [1, n_near] (rank 0 is the self
// distance, exactly 0 from the Gram identity).
//
// Design: one thread per row (b, i), through the rank network of height
// H = cw_instance(k) (exact 5 and 13, padded 8, 16, 32). The thread forms
// d2_ij = max((G_ii + G_jj) - 2 G_ij, 0) in registers, as the reference
// does outside its kernel, so D^2 is never written; the clamp keeps NaN.
// It ranks the row with cw_ranks (each pair once, f32 counts), repairs NaN
// with cw_fix_nan, and counts the kp - k pad columns (k rounded up to 8,
// at 3.4e38, as in the Pallas layout) in closed form, as trimmed_mean
// does. The entries at ranks [1, n_near] are summed by a halving tree over
// P = H rounded up to a power of two (fixed_sums.cuh), +0 elsewhere: the
// bits of krum_score.py::krum_score_plain's 32-wide butterfly, since no
// kept value is -0 where the sum is 0 (a +0 adds exactly to anything
// else). Each thread reads its row and the diagonal straight from device
// memory through the read-only cache: a warp's rows are contiguous, so the
// lines a load touches serve the next loads from L1. Staging whole
// matrices in shared memory first (coalesced 16-byte loads, a block
// barrier) ran 35% slower at 2^20 matrices of 13 on an H100 (PERF.md).
//
// Bound on the H100: bytes, 4 (bt k^2 + bt k); the k(k-1)/2 compares a row
// (an FSET and two FADDs each) come close at k = 13.
// ---------------------------------------------------------------------------
constexpr int KRUM_THREADS = 128;

template <int H, bool EXACT, class Row, class Diag>
__device__ __forceinline__ float krum_row(const Row& row, const Diag& diag,
                                          int i, int k, int n_near) {
    constexpr int P = pow2_at_least(H);
    if (EXACT) k = H;
    const float gii = diag(i);
    float v[H];
    float t = 0.0f;                  // NaN when a distance is NaN or inf
#pragma unroll
    for (int j = 0; j < H; ++j) {
        if (EXACT || j < k) {
            v[j] = clamp0(__fsub_rn(__fadd_rn(gii, diag(j)),
                                    __fmul_rn(2.0f, row(j))));
            t = fmaf(v[j], 0.0f, t);
        } else {
            v[j] = __int_as_float(0x7f800000);
        }
    }
    float r[H];
    cw_ranks(v, r);
    if (t != t) cw_fix_nan(v, r);
    const int pads = ((k + 7) & ~7) - k;
    if (pads) {
#pragma unroll
        for (int j = 0; j < H; ++j)
            r[j] += v[j] > PAD_BIG ? (float)pads : 0.0f;
    }
    const float hi = (float)n_near;
    float kept[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
        kept[j] = j < H && (EXACT || j < k) && r[j] >= 1.0f && r[j] <= hi
            ? v[j] : 0.0f;
    }
    return tree_sum(kept);
}

// Thread x KRUM_THREADS + t owns row x KRUM_THREADS + t of all bt k rows.
template <int H, bool EXACT>
__global__ void __launch_bounds__(KRUM_THREADS)
krum_score_kernel(const float* __restrict__ g, float* __restrict__ scores,
                  long long bt, int k_rows, int n_near) {
    const int k = EXACT ? H : k_rows;
    const long long row = (long long)blockIdx.x * KRUM_THREADS + threadIdx.x;
    if (row >= bt * k) return;
    const long long b = row / k;
    const int i = (int)(row - b * k);
    const float* gb = g + b * k * k;
    scores[row] = krum_row<H, EXACT>(
        [=](int j) { return __ldg(gb + i * k + j); },
        [=](int j) { return __ldg(gb + j * k + j); }, i, k, n_near);
}

// Calls f(height, exact) for the instance (height, n): exact instances
// 5 and 13 need n == height, padded ones 8, 16 and 32 take 1 <= n <= height.
template <class F>
int cw_instance(int height, int n, const F& f) {
    using std::integral_constant;
    using E = std::true_type;
    using P = std::false_type;
    if (n < 1 || n > height) return (int)cudaErrorInvalidValue;
    switch (height) {
        case 5:
            if (n != 5) break;
            return f(integral_constant<int, 5>{}, E{});
        case 13:
            if (n != 13) break;
            return f(integral_constant<int, 13>{}, E{});
        case 8: return f(integral_constant<int, 8>{}, P{});
        case 16: return f(integral_constant<int, 16>{}, P{});
        case 32: return f(integral_constant<int, 32>{}, P{});
        default: break;
    }
    return (int)cudaErrorInvalidValue;
}

unsigned cw_blocks(long long d, int threads) {
    return (unsigned)((d + threads - 1) / threads);
}

}  // namespace

extern "C" {

// `height` is the instance (cw_reduce.py::cw_instance(k)); the agent axis
// is ranked padded to k rounded up to 8.
int repro_trimmed_mean_f32(const float* x, float* out, int bt, int k,
                           long long d, int n_trim, int height,
                           cudaStream_t stream) {
    return cw_instance(height, k, [&](auto h, auto exact) {
        constexpr int H = decltype(h)::value;
        constexpr bool EXACT = decltype(exact)::value;
        trimmed_mean_kernel<H, EXACT>
            <<<dim3(cw_blocks(d, TM_THREADS), bt), TM_THREADS, 0,
               stream>>>(x, out, k, d, n_trim);
        return (int)cudaGetLastError();
    });
}

// `height` is cw_instance(p).
int repro_gossip_reduce_f32(const float* msgs, const long long* nbr,
                            float* out, int k, int p, long long d, int mode,
                            int n_trim, int height, cudaStream_t stream) {
    return cw_instance(height, p, [&](auto h, auto exact) {
        constexpr int H = decltype(h)::value;
        constexpr bool EXACT = decltype(exact)::value;
        gossip_reduce_kernel<H, EXACT>
            <<<dim3(cw_blocks(d, CW_THREADS), k), CW_THREADS, 0, stream>>>(
                msgs, nbr, out, k, p, d, mode, n_trim);
        return (int)cudaGetLastError();
    });
}

int repro_neighbor_reduce_f32(const float* recv, float* out, int k, int p,
                              long long d, int mode, int n_trim, int height,
                              cudaStream_t stream) {
    return cw_instance(height, p, [&](auto h, auto exact) {
        constexpr int H = decltype(h)::value;
        constexpr bool EXACT = decltype(exact)::value;
        neighbor_reduce_kernel<H, EXACT>
            <<<dim3(cw_blocks(d, CW_THREADS), k), CW_THREADS, 0, stream>>>(
                recv, out, p, d, mode, n_trim);
        return (int)cudaGetLastError();
    });
}

// `height` is cw_instance(k); the row is ranked padded to k rounded up to 8.
int repro_krum_score_f32(const float* g, float* scores, long long bt, int k,
                         int n_near, int height, cudaStream_t stream) {
    if (bt < 1) return (int)cudaErrorInvalidValue;
    return cw_instance(height, k, [&](auto h, auto exact) {
        constexpr int H = decltype(h)::value;
        constexpr bool EXACT = decltype(exact)::value;
        const long long blocks = (bt * k + KRUM_THREADS - 1) / KRUM_THREADS;
        krum_score_kernel<H, EXACT>
            <<<(unsigned)blocks, KRUM_THREADS, 0, stream>>>(
                g, scores, bt, k, n_near);
        return (int)cudaGetLastError();
    });
}

}  // extern "C"
