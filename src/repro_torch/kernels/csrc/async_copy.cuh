// Asynchronous copies from device memory into shared memory on Hopper
// (sm_90a), shared by the kernel sources of this directory.
//
// * Bulk copies (cp.async.bulk) complete on an mbarrier that the consumer
//   waits on by phase parity: one thread moves a whole row segment, the
//   hardware counts the bytes (gram_chunk_kernel, aggregation.cu).
// * 16-byte copies (cp.async.cg) are issued by every thread and waited for
//   by commit group: a source size of 0 fills the 16 bytes with zeros, so a
//   ragged edge needs no second code path (flash_attention_kernel,
//   attention.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
                 :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
    asm volatile(
        "{\n\t"
        ".reg .pred p;\n\t"
        "LAB_WAIT:\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n\t"
        "@!p bra LAB_WAIT;\n\t"
        "}"
        :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];"
        :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
        : "memory");
}

// 16 bytes from src (16-byte aligned) to dst (16-byte aligned), or 16 zero
// bytes when `full` is false (src is then not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
    asm volatile(
        "cp.async.cg.shared.global [%0], [%1], 16, %2;"
        :: "r"(smem_u32(dst)), "l"(src), "r"(full ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

}  // namespace
