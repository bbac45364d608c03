// Fixed-order f32 sums, and the clamp of a squared distance, shared by the
// kernel sources of this directory (weiszfeld_kernel in aggregation.cu,
// krum_score_kernel in cw_reduce.cu).
//
// A sum of n values is a halving tree over P slots, P the smallest power of
// two >= n: slot i += slot i + h for h = P/2 .. 1, slot 0 holds the sum. In
// registers it is tree_sum; across lanes, lane_sum's xor butterfly, which
// leaves the same bits in every lane (lane l adds lane l ^ h, and a + b is
// b + a bit for bit). Every add is __fadd_rn, so nothing is contracted or
// reordered, and the plain PyTorch versions (kernels/rfa/rfa.py::
// weiszfeld_plain, kernels/krum_score/krum_score.py::krum_score_plain)
// give the same bits by halving a padded tensor the same way.
#pragma once

#include <cuda_runtime.h>

namespace {

__host__ __device__ constexpr int pow2_at_least(int n) {
    return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// max(x, 0) that keeps NaN, as torch.clamp_min and the reference's
// jnp.maximum do (CUDA's fmaxf would turn a NaN distance into 0)
__device__ __forceinline__ float clamp0(float x) {
    return x < 0.0f ? 0.0f : x;
}

// v[i] += v[i + h] for h = P/2 .. 1: v[0] is the sum. One template level a
// halving, so every loop has a constant trip count and is unrolled: a
// loop over h left nvcc a local-memory array at P = 32 (2.5x slower).
template <int P, int HALF = P / 2>
__device__ __forceinline__ float tree_sum(float (&v)[P]) {
    if constexpr (HALF == 0) {
        return v[0];
    } else {
#pragma unroll
        for (int i = 0; i < HALF; ++i) v[i] = __fadd_rn(v[i], v[i + HALF]);
        return tree_sum<P, HALF / 2>(v);
    }
}

// the xor butterfly over lanes [0, P): tree_sum's bits, in every lane
template <int P>
__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
    for (int off = P / 2; off >= 1; off >>= 1)
        v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
    return v;
}

}  // namespace
