// Robust-aggregation kernels for Hopper (sm_90a): Gram matrix, Gram-space
// smoothed-Weiszfeld weights, and the weighted sum z = w^T X.
//
// Plain C interface, built with nvcc into a shared library and loaded with
// ctypes (repro_torch/kernels/_build.py). Every entry point takes its
// pointers and the CUDA stream from the caller, allocates nothing, does not
// synchronise, and returns cudaGetLastError() so that a refused launch is
// reported to the Python wrapper, which raises.
//
// All three take a leading batch dimension: the JAX package vmaps these
// calls over receivers (one bucketing permutation, or one MDA round, per
// receiver), and one launch here covers the whole batch.
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

const char* repro_error_string(int status) {
    return cudaGetErrorString((cudaError_t)status);
}

}  // extern "C"
