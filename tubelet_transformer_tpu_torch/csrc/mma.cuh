// Tensor-core and asynchronous-copy primitives in PTX, as the stage chain
// (stage.cu) and the bf16 pooled stem (stem.cu) use them:
//   cp_async16:  cp.async.cg of 16 bytes, device memory -> shared, through L2
//                only (never L1, so a copy sees what other blocks wrote before
//                a grid barrier); fewer than 16 source bytes zero-fill the rest;
//   ldsm_x4 / ldsm_x4_t: ldmatrix of four 8x8 bf16 matrices, plain or
//                transposed, into mma fragments;
//   mma_bf16:    mma.sync.m16n8k16, bf16 in, float32 accumulators;
//   mbar_*:      mbarriers in shared memory (init, arrive, parity wait), and
//                cp_async_arrive, which arrives on one when this thread's
//                earlier cp.async copies have landed (the depthwise's ring).
// Fragment layouts (lane = 4 g + t): A (16x16, row-major) a0 = (g, 2t..2t+1),
// a1 = (g+8, 2t..), a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16x8) b0 = (k
// 2t..2t+1, n g), b1 = (k 2t+8.., n g); C (16x8 float32) c0,c1 = (g, 2t..2t+1),
// c2,c3 = (g+8, 2t..). In a 32-bit register of two bf16, the lower half holds
// the lower column (A) or k (B).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace tuber_mma {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from `src` to shared `dst`; with `valid` false, 16 zero bytes
// (src must still be a valid address: it is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// An mbarrier in shared memory that completes a phase after `count`
// arrivals; the block syncs before any thread uses it.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

// One arrival on `bar` once every cp.async this thread issued before has
// landed (counted in the barrier's `count`: the .noinc form).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// One arrival now, with release semantics: this thread's earlier shared
// reads and writes happen before the phase completes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
          smem_addr(bar))
      : "memory");
}

// Wait until the phase of parity `parity` (0 for the first, 1 for the
// second, ...) of `bar` has completed; what the arrivals released is then
// visible.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Four 8x8 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16) @ b (16x8)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace tuber_mma
