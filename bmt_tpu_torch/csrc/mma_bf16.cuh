// Tensor-core building blocks of the attention forward (flash_attn_fwd.cu)
// and of the fp32 backward (flash_attn_bwd.cu, with mma_tf32.cuh), for sm_80
// and later (built for sm_90a here): cp.async tile loads (the bf16
// backward's small row loads too), ldmatrix fragment loads and the m16n8k16
// bf16 mma.sync with fp32 accumulators.
//
// Fragment layouts of mma.sync.m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), with group = lane / 4 and tig = lane % 4:
//   A (16 x 16, row-major), 4 x b32 of two bf16 each:
//     a0 (row group,     k 2 tig + {0,1})   a1 (row group + 8, k 2 tig + ..)
//     a2 (row group,     k 2 tig + 8 + ..)  a3 (row group + 8, k 2 tig + 8 ..)
//   B (16 x 8, k-major), 2 x b32: b0 (k 2 tig + {0,1}, col group),
//     b1 (k 2 tig + 8 + {0,1}, col group)
//   C (16 x 8) fp32: c0, c1 (row group, cols 2 tig + {0,1}),
//     c2, c3 (row group + 8, the same cols)
// So the four lanes of a quad (same group) hold one row of C between them,
// and a row reduction over C is a shuffle across lanes 1 and 2 apart.
//
// Tiles in shared memory are row-major bf16 with rows padded to
// PAD_ROW(cols) = cols + 8 elements: a row stride of an odd number of 16-byte
// chunks (the tile widths are multiples of 64) puts the eight rows that one
// ldmatrix 8x8 read touches in eight different bank groups, so the reads
// are free of bank conflicts without a swizzle.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma_bf16 {

typedef __nv_bfloat16 bf16;

__host__ __device__ constexpr int pad_row(int cols) { return cols + 8; }

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

// rows [r0, r0 + R) of a row-major (S, d) bf16 matrix into an R x COLS tile
// (row stride pad_row(COLS)) by 16-byte cp.async copies, zeros for rows at or
// past S and for columns at or past d (COLS >= d, d % 8 == 0)
template <int COLS, int THREADS>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* src,
                                                int r0, int R, int S, int d,
                                                int tid) {
  constexpr int CHUNKS = COLS / 8;
  for (int i = tid; i < R * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    const bool ok = r0 + r < S && c < d;
    cp_async16(dst + r * pad_row(COLS) + c,
               ok ? src + (size_t)(r0 + r) * d + c : src, ok);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Fragment addresses for ldmatrix.x4, per lane, into a tile with row
// stride `ld` elements:
// - A of rows [m0, m0 + 16), k columns [k0, k0 + 16) of a row-major tile:
//   r[0..3] = a0..a3.
__device__ __forceinline__ const bf16* frag_a(const bf16* tile, int ld,
                                              int m0, int k0, int lane) {
  return tile + (m0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
// - B of two 8-wide n-tiles [n0, n0 + 16), k [k0, k0 + 16), from a tile
//   that stores B transposed (rows = n, cols = k: K for Q K^T):
//   r[0], r[1] = b0, b1 of n-tile n0; r[2], r[3] those of n0 + 8.
__device__ __forceinline__ const bf16* frag_b_nk(const bf16* tile, int ld,
                                                 int n0, int k0, int lane) {
  return tile + (n0 + (lane & 7) + (lane >> 4) * 8) * ld + k0 +
         ((lane >> 3) & 1) * 8;
}
// - the same from a tile that stores B as it is (rows = k, cols = n: V for
//   P V), read with ldmatrix_x4_trans.
__device__ __forceinline__ const bf16* frag_b_kn(const bf16* tile, int ld,
                                                 int n0, int k0, int lane) {
  return tile + (k0 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld + n0 +
         (lane >> 4) * 8;
}

// c += a b, m16n8k16, bf16 inputs, fp32 accumulators
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half:
// the lower column of a fragment register
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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
