// Building blocks of the fp32 attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu, with mma_tf32.cuh) and of the bf16 kernels' small row
// loads, for sm_80 and later (built for sm_90a here): cp.async copies, the
// ldmatrix fragment load that mma_tf32.cuh reads fp32 tiles with, and the
// row max and sum over the four lanes of an mma.sync quad.
//
// In an mma.sync accumulator fragment (PTX ISA, "Matrix Fragments for
// mma.m16n8k8" and "m16n8k16"), with group = lane / 4 and tig = lane % 4,
// c0, c1 lie in row group, cols 2 tig + {0,1}, and c2, c3 in row group + 8:
// the four lanes of a quad (same group) hold one row between them, so a row
// reduction is a shuffle across lanes 1 and 2 apart.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; `ok` false writes 16 zero bytes
// and reads nothing (src-size 0), so `src` need only be a valid address
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; `ok` false writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 8 matrices of 16-bit words from shared memory: lane l gives the
// address of row l % 8 of matrix l / 8 and receives, in r[i], the 32 bits at
// word l % 4 of row l / 4 of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// max and sum over the four lanes of a quad (one row of a C fragment)
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace mma_bf16
