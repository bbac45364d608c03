// Robust-aggregation kernels for Hopper (sm_90a): Gram matrix, Gram-space
// smoothed-Weiszfeld weights, the weighted sum z = w^T X, Krum scores,
// and the coordinate-wise reduces (trimmed mean over agents, and the
// gossip reduces of the cw* agreement rounds).
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/_build.py). Every entry point takes its
// pointers and the CUDA stream from the caller, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper, which raises.
//
// The aggregation kernels take a leading batch dimension: the JAX package
// vmaps these calls over receivers (one bucketing permutation, or one MDA
// round, per receiver), and one launch here covers the whole batch. The
// gossip reduces cover all receivers of one agreement round in one launch.
//
// Arithmetic is IEEE f32 (no fast-math): RFA's distances come from the Gram
// identity, and only the smoothing floor nu bounds their cancellation, so
// neither reduced-precision math nor TF32 tensor cores are used. Every sum
// is taken in a fixed order with no atomics, so a rerun is bit-identical.

#include <cuda_runtime.h>

namespace {

constexpr int KMAX = 32;          // largest stack the kernels take
constexpr int GRAM_THREADS = 256;

// ---------------------------------------------------------------------------
// gram: x (bt, k, d) -> g (bt, k, k), g[b, i, j] = sum_c x[b, i, c] x[b, j, c]
//
// Replaces src/repro/kernels/pairwise_dist/pairwise_dist.py::gram
// (_gram_kernel), the d-tiled MXU accumulation with K padded to 8.
//
// Design: one block per (batch, row i). Each thread strides over d and keeps
// k running sums in registers (the loop over j is unrolled to KMAX with a
// uniform guard, so acc[] stays in registers); the block then reduces with
// warp shuffles and a fixed-order pass over the per-warp partials in shared
// memory. g[i, j] and g[j, i] see the same products in the same order, so
// the result is exactly symmetric.
//
// Bound on the H100: at the main path's d = 386 the whole call moves a few
// tens of KB, so launch latency bounds it. At large d it is bytes: the block
// for row i reads all k rows, so the stack is read k times (from L2 while
// it fits in 50 MB), and with only bt*k blocks a single stack (bt = 1)
// leaves most of the 132 SMs idle. Splitting d across blocks with a second
// fixed-order reduction pass is later work.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(GRAM_THREADS)
gram_kernel(const float* __restrict__ x, float* __restrict__ g, int k,
            long long d) {
    const int i = blockIdx.x;
    const long long b = blockIdx.y;
    const float* xb = x + b * k * d;
    const float* xi = xb + (long long)i * d;

    float acc[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) acc[j] = 0.0f;

    for (long long c = threadIdx.x; c < d; c += GRAM_THREADS) {
        const float a = xi[c];
#pragma unroll
        for (int j = 0; j < KMAX; ++j) {
            if (j < k) acc[j] = fmaf(a, xb[(long long)j * d + c], acc[j]);
        }
    }

#pragma unroll
    for (int j = 0; j < KMAX; ++j) {
        if (j < k) {
            float v = acc[j];
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                v += __shfl_down_sync(0xffffffffu, v, off);
            acc[j] = v;
        }
    }

    __shared__ float part[GRAM_THREADS / 32][KMAX];
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    if (lane == 0) {
#pragma unroll
        for (int j = 0; j < KMAX; ++j) part[warp][j] = acc[j];
    }
    __syncthreads();
    if (threadIdx.x < k) {
        float s = 0.0f;
#pragma unroll
        for (int w = 0; w < GRAM_THREADS / 32; ++w) s += part[w][threadIdx.x];
        g[(b * k + i) * k + threadIdx.x] = s;
    }
}

// ---------------------------------------------------------------------------
// weiszfeld: g (bt, k, k), nu, n_iter -> w (bt, k)
//
// Replaces src/repro/kernels/rfa/rfa.py::rfa_pallas, first pallas_call
// (_weiszfeld_kernel): n_iter smoothed-Weiszfeld steps in weight space,
//   d2 = max(diag - 2 G w + w^T G w, 0),  iw = 1 / sqrt(d2 + nu),
//   w  = iw / sum(iw),                      from w0 = 1/k.
//
// Design: one warp per batch element, lane j owns row j, G sits in shared
// memory. The two sums per step (w^T G w and sum(iw)) are xor butterflies,
// which leave the same bits in every lane. There are no pad rows, so no
// valid mask beyond lane < k.
//
// Bound on the H100: k <= 32 and n_iter of about 32 make this a few
// thousand dependent shared-memory operations per warp: latency, not bytes
// or FLOPs. Folding it into the Gram or weighted-sum launch is later work.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(32)
weiszfeld_kernel(const float* __restrict__ g, float* __restrict__ w_out,
                 int k, float nu, int n_iter) {
    __shared__ float gs[KMAX][KMAX + 1];
    __shared__ float ws[KMAX];
    const long long b = blockIdx.x;
    const int j = threadIdx.x;
    const float* gb = g + b * k * k;

    for (int idx = j; idx < k * k; idx += 32) gs[idx / k][idx % k] = gb[idx];
    const bool valid = j < k;
    float w = valid ? 1.0f / (float)k : 0.0f;
    ws[j] = w;
    __syncwarp();
    const float diag = valid ? gs[j][j] : 0.0f;

    for (int it = 0; it < n_iter; ++it) {
        float gw = 0.0f;
        if (valid) {
            for (int l = 0; l < k; ++l) gw = fmaf(gs[j][l], ws[l], gw);
        }
        float wgw = w * gw;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            wgw += __shfl_xor_sync(0xffffffffu, wgw, off);
        const float d2 = fmaxf(diag - 2.0f * gw + wgw, 0.0f);
        const float iw = valid ? 1.0f / sqrtf(d2 + nu) : 0.0f;
        float tot = iw;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            tot += __shfl_xor_sync(0xffffffffu, tot, off);
        w = iw / tot;
        __syncwarp();
        ws[j] = w;
        __syncwarp();
    }
    if (valid) w_out[b * k + j] = w;
}

// ---------------------------------------------------------------------------
// wsum: x (bt, k, d), w (bt, k) -> z (bt, d), z[b, c] = sum_j w[b, j] x[b, j, c]
//
// Replaces src/repro/kernels/rfa/rfa.py::rfa_pallas, second pallas_call
// (_wsum_kernel), the d-tiled (1, Kp) x (Kp, block_d) product.
//
// Design: one thread per coordinate, summing over j in a fixed order; the
// d-tiling of the TPU kernel does not carry over. Neighbouring threads read
// neighbouring addresses, so every row is read once, coalesced.
//
// Bound on the H100: bytes (k + 1 floats moved per 2k FLOP); launch latency
// at the main path's d = 386. Wider loads per thread are later work.
// ---------------------------------------------------------------------------
__global__ void wsum_kernel(const float* __restrict__ x,
                            const float* __restrict__ w,
                            float* __restrict__ z, int k, long long d) {
    const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long b = blockIdx.y;
    if (c >= d) return;
    const float* xb = x + b * k * d;
    const float* wb = w + b * k;
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s = fmaf(wb[j], xb[(long long)j * d + c], s);
    z[b * d + c] = s;
}

// ---------------------------------------------------------------------------
// The coordinate-wise reduce shared by trimmed_mean, gossip_reduce and
// neighbor_reduce: the counterpart of the JAX package's
// kernels/gossip_reduce/ref.py::cw_reduce, which its three Pallas kernels
// share.
//
// One thread reduces one coordinate over p <= KMAX values v[0..p), held in
// a register array (every loop is unrolled to KMAX with a uniform guard, so
// nothing is indexed dynamically). Slots >= n are pad: ranked last, never
// kept. The rank of a valid slot b is the number of slots a ordered before
// it,
//   rank_b = sum_a [xv_a < v_b  or  (xv_a == v_b and a < b)],
// with xv the values whose pad slots hold 3.4e38, as the reference writes
// it (the masked xv on the left of <, the unmasked v on the right). For
// finite values the ranks of the valid slots are a permutation of [0, n),
// so a sort is not needed. Each rank is used as soon as it is formed and
// never stored. The guards are run-time values, so every call executes all
// KMAX^2 predicated steps; specialising on p is later work. Kept values
// are summed in slot order:
//   mean     sum_{a<n} v_a / n
//   median   (v at rank (n-1)/2 + v at rank n/2) / 2
//   trimmed  sum of v at ranks [n_trim, n - n_trim), / (n - 2 n_trim)
// ---------------------------------------------------------------------------
constexpr int CW_THREADS = 256;
constexpr float PAD_BIG = 3.4e38f;
enum : int { CW_MEAN = 0, CW_MEDIAN = 1, CW_TRIMMED = 2 };

__device__ __forceinline__ float cw_reduce_one(const float (&v)[KMAX], int p,
                                               int n, int mode, int n_trim) {
    float s = 0.0f;
    if (mode == CW_MEAN) {
#pragma unroll
        for (int a = 0; a < KMAX; ++a) {
            if (a < n) s += v[a];
        }
        return s / (float)n;
    }
    const bool median = mode == CW_MEDIAN;
    const int lo = median ? (n - 1) / 2 : n_trim;
    const int hi = median ? n / 2 : n - n_trim - 1;
    float s_hi = 0.0f;
#pragma unroll
    for (int b = 0; b < KMAX; ++b) {
        if (b < n) {
            int r = 0;
#pragma unroll
            for (int a = 0; a < KMAX; ++a) {
                if (a < p) {
                    const float xa = a < n ? v[a] : PAD_BIG;
                    r += (xa < v[b]) | ((xa == v[b]) & (a < b));
                }
            }
            if (median) {
                s += r == lo ? v[b] : 0.0f;
                s_hi += r == hi ? v[b] : 0.0f;
            } else {
                s += (r >= lo && r <= hi) ? v[b] : 0.0f;
            }
        }
    }
    return median ? 0.5f * (s + s_hi) : s / (float)(n - 2 * n_trim);
}

// ---------------------------------------------------------------------------
// trimmed_mean: x (bt, k, d), n_trim -> out (bt, d), per coordinate the mean
// of ranks [n_trim, k - n_trim) over the k agents.
//
// Replaces src/repro/kernels/trimmed_mean/trimmed_mean.py::trimmed_mean_pallas
// (_tm_kernel): cw_reduce(..., "trimmed", n_valid=K) over a K-padded,
// d-tiled block. The agent axis is ranked as the Pallas kernel ranks it,
// padded to kp = K rounded up to 8 with pad slots last.
//
// Design: one thread per (b, c); thread c reads x[b, j, c] for j < k, so a
// warp's loads of one row are coalesced, and every byte is read once.
//
// Bound on the H100: bytes (k + 1 floats per coordinate) by the roofline,
// since k^2 comparisons at the FP32 rate take less time. But the
// comparisons are instructions, and cw_reduce_one executes KMAX^2 guarded
// steps whatever k is: at (1, 13, 2^24) that, not bandwidth, sets the
// time (6.6x the bytes bound). Launch latency at the main path's d = 386.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CW_THREADS)
trimmed_mean_kernel(const float* __restrict__ x, float* __restrict__ out,
                    int k, long long d, int n_trim) {
    const long long c = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
    const long long b = blockIdx.y;
    if (c >= d) return;
    const float* xb = x + b * k * d + c;
    float v[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) v[j] = j < k ? xb[(long long)j * d] : 0.0f;
    const int kp = (k + 7) & ~7;
    out[b * d + c] = cw_reduce_one(v, kp, k, CW_TRIMMED, n_trim);
}

// ---------------------------------------------------------------------------
// gossip_reduce: msgs (k, d), nbr (k, p) int64, mode, n_trim -> out (k, d),
// out[r, c] = reduce over p of msgs[nbr[r, p], c].
//
// Replaces src/repro/kernels/gossip_reduce/gossip_reduce.py::
// gossip_reduce_pallas (_gather_reduce_kernel), which gathers the
// neighbour rows with p one-hot (K, K) matmuls on the MXU because row
// gathers lower poorly on a TPU. Hopper loads indexed rows directly, so the
// one-hot products are gone.
//
// Design: blockIdx.y is the receiver r; the block loads nbr[r, :] into
// shared memory once, then thread c reads msgs[nbr[r, q], c] for q < p
// (coalesced across c) and reduces in registers; the gathered (k, p, d)
// tensor never exists in device memory. An index outside [0, k) is not
// followed: the receiver's row comes out NaN instead.
//
// Bound on the H100: the messages are read p times each from L2 (k * d *
// 4 bytes, 20 KB at the main path's d = 386, stay in the 50 MB L2), so the
// device-memory bytes are one read of msgs and one write of out, and the
// p^2 comparisons per coordinate bound it. The KMAX^2 guarded steps of
// cw_reduce_one set the time at large d. Launch latency at the main
// path's sizes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CW_THREADS)
gossip_reduce_kernel(const float* __restrict__ msgs,
                     const long long* __restrict__ nbr,
                     float* __restrict__ out, int k, int p, long long d,
                     int mode, int n_trim) {
    __shared__ long long rows[KMAX];
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
    float v[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) v[j] = j < p ? msgs[rows[j] * d + c] : 0.0f;
    out[r * d + c] = bad ? __int_as_float(0x7fc00000)
                         : cw_reduce_one(v, p, p, mode, n_trim);
}

// ---------------------------------------------------------------------------
// neighbor_reduce: recv (k, p, d), mode, n_trim -> out (k, d), the reduce
// over an already gathered tensor (the per-receiver equivocation path).
//
// Replaces src/repro/kernels/gossip_reduce/gossip_reduce.py::
// neighbor_reduce_pallas (_reduce_kernel).
//
// Design: thread (r, c) reads recv[r, q, c] for q < p, coalesced across c.
//
// Bound on the H100: bytes (p + 1 floats moved per coordinate) by the
// roofline; the KMAX^2 guarded steps of cw_reduce_one set the time at
// large d. Launch latency at the main path's sizes.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(CW_THREADS)
neighbor_reduce_kernel(const float* __restrict__ recv,
                       float* __restrict__ out, int p, long long d, int mode,
                       int n_trim) {
    const long long c = (long long)blockIdx.x * CW_THREADS + threadIdx.x;
    const long long r = blockIdx.y;
    if (c >= d) return;
    const float* rr = recv + r * p * d + c;
    float v[KMAX];
#pragma unroll
    for (int j = 0; j < KMAX; ++j) v[j] = j < p ? rr[(long long)j * d] : 0.0f;
    out[r * d + c] = cw_reduce_one(v, p, p, mode, n_trim);
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
// Design: one warp per (b, i). Lane j forms d2_ij = max(G_ii + G_jj -
// 2 G_ij, 0) from G, as the reference does outside its kernel, so D^2 is
// never written; lanes [k, kp) are pad columns (3.4e38, ranked last), with
// kp = k rounded up to 8 as in the Pallas layout. Each lane ranks its entry
// against the others through __shfl_sync (ties by column), and the kept
// entries are summed with a fixed xor butterfly, which leaves the same bits
// in every lane.
//
// Bound on the H100: k^2 comparisons per row and k^2 floats read per
// matrix; at k = 13 it is a few hundred dependent shuffles per warp, so
// latency, not bytes or operations, bounds it.
// ---------------------------------------------------------------------------
constexpr int KRUM_WARPS = 4;

__global__ void __launch_bounds__(32 * KRUM_WARPS)
krum_score_kernel(const float* __restrict__ g, float* __restrict__ scores,
                  long long n_rows, int k, int n_near) {
    const long long row = (long long)blockIdx.x * KRUM_WARPS
        + (threadIdx.x >> 5);
    if (row >= n_rows) return;               // the whole warp leaves
    const int lane = threadIdx.x & 31;
    const long long b = row / k;
    const int i = (int)(row - b * k);
    const float* gb = g + b * k * k;
    const bool valid = lane < k;
    const int kp = (k + 7) & ~7;
    float d2 = 0.0f;
    if (valid) {
        d2 = fmaxf(gb[i * k + i] + gb[lane * k + lane]
                   - 2.0f * gb[i * k + lane], 0.0f);
    }
    const float xv = valid ? d2 : PAD_BIG;
    int r = 0;
#pragma unroll
    for (int a = 0; a < KMAX; ++a) {
        const float xa = __shfl_sync(0xffffffffu, xv, a);
        if (a < kp) r += (xa < xv) | ((xa == xv) & (a < lane));
    }
    float s = (valid && r >= 1 && r <= n_near) ? d2 : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) scores[row] = s;
}

}  // namespace

extern "C" {

int repro_gram_f32(const float* x, float* g, int bt, int k, long long d,
                   cudaStream_t stream) {
    gram_kernel<<<dim3(k, bt), GRAM_THREADS, 0, stream>>>(x, g, k, d);
    return (int)cudaGetLastError();
}

int repro_weiszfeld_f32(const float* g, float* w, int bt, int k, float nu,
                        int n_iter, cudaStream_t stream) {
    weiszfeld_kernel<<<bt, 32, 0, stream>>>(g, w, k, nu, n_iter);
    return (int)cudaGetLastError();
}

int repro_wsum_f32(const float* x, const float* w, float* z, int bt, int k,
                   long long d, cudaStream_t stream) {
    const int threads = 256;
    const long long blocks = (d + threads - 1) / threads;
    wsum_kernel<<<dim3((unsigned)blocks, bt), threads, 0, stream>>>(x, w, z,
                                                                    k, d);
    return (int)cudaGetLastError();
}

int repro_trimmed_mean_f32(const float* x, float* out, int bt, int k,
                           long long d, int n_trim, cudaStream_t stream) {
    const long long blocks = (d + CW_THREADS - 1) / CW_THREADS;
    trimmed_mean_kernel<<<dim3((unsigned)blocks, bt), CW_THREADS, 0,
                          stream>>>(x, out, k, d, n_trim);
    return (int)cudaGetLastError();
}

int repro_gossip_reduce_f32(const float* msgs, const long long* nbr,
                            float* out, int k, int p, long long d, int mode,
                            int n_trim, cudaStream_t stream) {
    const long long blocks = (d + CW_THREADS - 1) / CW_THREADS;
    gossip_reduce_kernel<<<dim3((unsigned)blocks, k), CW_THREADS, 0,
                           stream>>>(msgs, nbr, out, k, p, d, mode, n_trim);
    return (int)cudaGetLastError();
}

int repro_neighbor_reduce_f32(const float* recv, float* out, int k, int p,
                              long long d, int mode, int n_trim,
                              cudaStream_t stream) {
    const long long blocks = (d + CW_THREADS - 1) / CW_THREADS;
    neighbor_reduce_kernel<<<dim3((unsigned)blocks, k), CW_THREADS, 0,
                             stream>>>(recv, out, p, d, mode, n_trim);
    return (int)cudaGetLastError();
}

int repro_krum_score_f32(const float* g, float* scores, long long bt, int k,
                         int n_near, cudaStream_t stream) {
    const long long n_rows = bt * k;
    const long long blocks = (n_rows + KRUM_WARPS - 1) / KRUM_WARPS;
    krum_score_kernel<<<(unsigned)blocks, 32 * KRUM_WARPS, 0, stream>>>(
        g, scores, n_rows, k, n_near);
    return (int)cudaGetLastError();
}

const char* repro_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
