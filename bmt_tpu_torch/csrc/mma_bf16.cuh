// Small building blocks of the attention kernels (flash_attn_fwd.cu,
// flash_attn_bwd.cu), beside their wgmma ones in sm90.cuh: the 4-byte
// cp.async that brings a tile's key validity (or its lse and D rows) into
// shared memory, and the row max and sum over the four lanes of a quad.
//
// In a wgmma (and mma.sync) accumulator fragment, with group = lane / 4
// and tig = lane % 4, a thread's elements lie in rows group and group + 8
// of its warp's 16, at columns 2 tig + {0, 1} of each 8-column group: the
// four lanes of a quad (same group) hold one row between them, so a row
// reduction is a shuffle across lanes 1 and 2 apart.

#pragma once

#include <stdint.h>

namespace mma_bf16 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared, asynchronously; `ok` false writes zeros
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0));
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
