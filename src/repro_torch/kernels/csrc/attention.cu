// Flash attention for Hopper (sm_90a): causal online-softmax attention with
// grouped-query heads and an optional sliding window, in f32.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py
// ::flash_attention_pallas (body _flash_kernel): q (B*H, Sq, hd), k and v
// (B*Hkv, Sk, hd), query head bh reads KV head (bh / H) * Hkv + (bh % H) / G,
// the mask is k_pos <= q_pos, k_pos < Sk and (q_pos - k_pos) < window on
// absolute indices 0..Sq-1 and 0..Sk-1, the scale is hd^-0.5, and the
// denominator has a floor of 1e-30.
//
// Design: one block of 256 threads per (bh, tile of 64 query rows), heavy
// (late, causal) tiles launched first. The block keeps its Q tile in shared
// memory, transposed, and walks the KV tiles of 64 keys from the first one
// the window reaches to the one holding the diagonal; tiles wholly outside
// are skipped, which changes nothing, since a fully masked tile adds p = 0
// and leaves the running max where it was. K (transposed) and V of one tile
// sit in shared memory, and so do the tile's probabilities P. Thread (ty, tx)
// of the 16 x 16 grid owns query rows 4ty..4ty+3: a 4 x 4 block of scores
// (key columns 4tx..4tx+3), and hd/16 output columns of those rows. The
// running max, denominator and accumulator of each row live in registers;
// the 16 threads of a row group (one half-warp) combine their row max and
// row sum with an xor butterfly, which gives every lane the same value.
// Masked scores are -1e30 and their p is set to 0 after the exponential,
// as the Pallas body does (a row whose visited keys are all masked so far
// keeps m = -1e30, where exp(s - m) would be 1).
//
// Arithmetic is IEEE f32 on the FMA units: no TF32, no tensor cores and no
// fast-math exponentials. Every sum runs in a fixed order with no atomics, so
// a rerun is bit-identical.
//
// Bound on the H100: operations. A causal prefill of S tokens costs about
// 2 * 2 * hd * S^2 / 2 flops per head against 4 * S * hd * (2 + 2 / G)
// bytes, hundreds of flops per byte at S = 512, so the 67 TFLOP/s f32 rate
// bounds it. What the design does about that: each thread does 16 FMAs per
// pair of 16-byte shared-memory loads in Q K^T, and 4 * hd / 16 FMAs per
// key against a quarter of a 16-byte P load and hd / 64 16-byte V loads in
// P V, so the FMA pipe rather than shared memory sets the pace. Tensor cores (wgmma), TMA double
// buffering and bf16 are later work. The caller passes contiguous
// (B*H, S, hd) tensors: ops.py folds the model layout into copies.
//
// Plain C interface (see aggregation.cu): the caller passes the pointers and
// the stream; the entry point returns cudaGetLastError().

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int FA_BQ = 64;          // query rows per block
constexpr int FA_BK = 64;          // keys per KV tile
constexpr int FA_THREADS = 256;    // 16 x 16: ty row group, tx column group
constexpr int FA_LDT = FA_BQ + 4;  // row stride of Qt, Kt, Ps (16-B aligned)
constexpr float FA_NEG_INF = -1e30f;

template <int HD>
struct FaTile {
    static constexpr int DPT = HD / 16;            // output columns/thread
    static constexpr int VEC = DPT < 4 ? DPT : 4;   // columns per vector load
    static constexpr int NG = DPT / VEC;            // vector groups/thread
    static constexpr int LDV = HD + 4;              // row stride of Vs
    static constexpr int QT = HD * FA_LDT;          // Qt[d][r]
    static constexpr int KT = HD * FA_LDT;          // Kt[d][c]
    static constexpr int VS = FA_BK * LDV;          // Vs[c][d]
    static constexpr int PS = FA_BQ * FA_LDT;       // Ps[r][c]
    static constexpr size_t BYTES = sizeof(float) * (QT + KT + VS + PS);
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

template <int HD>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int sq, int sk, int n_heads, int group, int window,
                       float scale) {
    using T = FaTile<HD>;
    extern __shared__ __align__(16) float smem[];
    float* qt_s = smem;                 // Q tile, transposed
    float* kt_s = qt_s + T::QT;         // K tile, transposed
    float* v_s = kt_s + T::KT;          // V tile
    float* p_s = v_s + T::VS;           // probabilities of the tile

    const int tid = threadIdx.x;
    const int tx = tid & 15;
    const int ty = tid >> 4;
    const int n_qt = gridDim.x;
    const int qtile = n_qt - 1 - (int)blockIdx.x;   // heavy tiles first
    const int bh = blockIdx.y;
    const int n_kv = n_heads / group;
    const int kvh = (bh / n_heads) * n_kv + (bh % n_heads) / group;
    const float* qb = q + (long long)bh * sq * HD;
    const float* kb = k + (long long)kvh * sk * HD;
    const float* vb = v + (long long)kvh * sk * HD;
    float* ob = o + (long long)bh * sq * HD;
    const int q0 = qtile * FA_BQ;

    for (int idx = tid; idx < FA_BQ * HD; idx += FA_THREADS) {
        const int r = idx / HD, d = idx % HD;
        qt_s[d * FA_LDT + r] = (q0 + r < sq) ? qb[(long long)(q0 + r) * HD + d]
                                             : 0.0f;
    }

    float m[4], l[4], acc[4][T::DPT];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        m[i] = FA_NEG_INF;
        l[i] = 0.0f;
#pragma unroll
        for (int c = 0; c < T::DPT; ++c) acc[i][c] = 0.0f;
    }

    // keys any row of the tile may see: k <= q_last, k < sk, k > q0 - window
    const int q_last = min(q0 + FA_BQ, sq) - 1;
    const int k_hi = min(q_last, sk - 1);
    const int k_lo = window > 0 ? max(0, q0 - window + 1) : 0;
    const int win = window > 0 ? window : INT_MAX;
    const int kt_begin = k_lo / FA_BK;
    const int kt_end = k_hi >= k_lo ? k_hi / FA_BK : kt_begin - 1;

    for (int kt = kt_begin; kt <= kt_end; ++kt) {
        const int k0 = kt * FA_BK;
        __syncthreads();                 // previous tile fully consumed
        for (int idx = tid; idx < FA_BK * HD; idx += FA_THREADS) {
            const int c = idx / HD, d = idx % HD;
            const bool in = k0 + c < sk;
            const long long off = (long long)(k0 + c) * HD + d;
            kt_s[d * FA_LDT + c] = in ? kb[off] : 0.0f;
            v_s[c * T::LDV + d] = in ? vb[off] : 0.0f;
        }
        __syncthreads();

        // S = Q K^T for rows 4ty+i, key columns 4tx+j
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
        for (int d = 0; d < HD; ++d) {
            float a[4], b[4];
            load_vec<4>(qt_s + d * FA_LDT + 4 * ty, a);
            load_vec<4>(kt_s + d * FA_LDT + 4 * tx, b);
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    s[i][j] = fmaf(a[i], b[j], s[i][j]);
        }

        // online softmax, one row at a time
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const int qp = q0 + 4 * ty + i;
            bool valid[4];
            float mt = FA_NEG_INF;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int kp = k0 + 4 * tx + j;
                valid[j] = kp <= qp && kp < sk && (qp - kp) < win;
                s[i][j] = valid[j] ? s[i][j] * scale : FA_NEG_INF;
                mt = fmaxf(mt, s[i][j]);
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
            const float m_new = fmaxf(m[i], mt);
            const float alpha = expf(m[i] - m_new);
            float lt = 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                s[i][j] = valid[j] ? expf(s[i][j] - m_new) : 0.0f;
                lt += s[i][j];
            }
#pragma unroll
            for (int off = 8; off > 0; off >>= 1)
                lt += __shfl_xor_sync(0xffffffffu, lt, off);
            l[i] = alpha * l[i] + lt;
            m[i] = m_new;
#pragma unroll
            for (int c = 0; c < T::DPT; ++c) acc[i][c] *= alpha;
            *reinterpret_cast<float4*>(p_s + (4 * ty + i) * FA_LDT + 4 * tx) =
                make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
        }
        __syncthreads();

        // acc += P V, keys in order 0..63
#pragma unroll 2
        for (int c0 = 0; c0 < FA_BK; c0 += 4) {
            float p[4][4];
#pragma unroll
            for (int i = 0; i < 4; ++i)
                load_vec<4>(p_s + (4 * ty + i) * FA_LDT + c0, p[i]);
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
                float vv[T::DPT];
#pragma unroll
                for (int g = 0; g < T::NG; ++g)
                    load_vec<T::VEC>(v_s + (c0 + cc) * T::LDV
                                     + g * 16 * T::VEC + tx * T::VEC,
                                     vv + g * T::VEC);
#pragma unroll
                for (int i = 0; i < 4; ++i)
#pragma unroll
                    for (int c = 0; c < T::DPT; ++c)
                        acc[i][c] = fmaf(p[i][cc], vv[c], acc[i][c]);
            }
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int r = q0 + 4 * ty + i;
        if (r >= sq) continue;
        const float inv_den = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int g = 0; g < T::NG; ++g)
#pragma unroll
            for (int e = 0; e < T::VEC; ++e)
                ob[(long long)r * HD + g * 16 * T::VEC + tx * T::VEC + e] =
                    acc[i][g * T::VEC + e] * inv_den;
    }
}

template <int HD>
int launch_flash(const float* q, const float* k, const float* v, float* o,
                 int bh, int sq, int sk, int n_heads, int group, int window,
                 float scale, cudaStream_t stream) {
    const size_t bytes = FaTile<HD>::BYTES;
    cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int n_qt = (sq + FA_BQ - 1) / FA_BQ;
    flash_attention_kernel<HD><<<dim3(n_qt, bh), FA_THREADS, bytes,
                                 stream>>>(q, k, v, o, sq, sk, n_heads,
                                           group, window, scale);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// window <= 0 means no window; scale is hd^-0.5 rounded to f32 by the
// caller, as the reference rounds it. hd must be 32, 64 or 128.
int repro_flash_attention_f32(const float* q, const float* k, const float* v,
                              float* o, int bh, int sq, int sk, int hd,
                              int n_heads, int group, int window, float scale,
                              cudaStream_t stream) {
    switch (hd) {
        case 32:
            return launch_flash<32>(q, k, v, o, bh, sq, sk, n_heads, group,
                                    window, scale, stream);
        case 64:
            return launch_flash<64>(q, k, v, o, bh, sq, sk, n_heads, group,
                                    window, scale, stream);
        case 128:
            return launch_flash<128>(q, k, v, o, bh, sq, sk, n_heads, group,
                                     window, scale, stream);
        default:
            return (int)cudaErrorInvalidValue;
    }
}

// Dynamic shared memory of one block at head dim hd (-1 if not compiled).
int repro_flash_attention_shared_bytes(int hd) {
    switch (hd) {
        case 32: return (int)FaTile<32>::BYTES;
        case 64: return (int)FaTile<64>::BYTES;
        case 128: return (int)FaTile<128>::BYTES;
        default: return -1;
    }
}

}  // extern "C"
