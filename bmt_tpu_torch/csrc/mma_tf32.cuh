// Tensor-core building blocks of the fp32 attention forward
// (flash_attn_fwd.cu; the fp32 backward is on wgmma, sm90.cuh), for sm_80
// and later (built for sm_90a here): fp32 tiles by cp.async, fragments by
// ldmatrix, and the m16n8k8 TF32 mma.sync with fp32 accumulators, used
// three times per product so that the result keeps fp32 accuracy
// ("3xTF32").
//
// Fragment layouts of mma.sync.m16n8k8 .tf32 (PTX ISA, "Matrix Fragments
// for mma.m16n8k8"), one element a register, with group = lane / 4 and
// tig = lane % 4:
//   A (16 x 8, row-major): a0 (row group, k tig), a1 (row group + 8, k tig),
//     a2 (row group, k tig + 4), a3 (row group + 8, k tig + 4)
//   B (8 x 8, k-major): b0 (k tig, col group), b1 (k tig + 4, col group)
//   C (16 x 8) fp32: c0, c1 (row group, cols 2 tig + {0,1}), c2, c3 (row
//     group + 8, the same cols)
//
// ldmatrix reads 8 x 8 matrices of 16-bit words: lane l receives the 32
// bits at word l % 4 of row l / 4. On an fp32 tile each such 8 x 8 b16
// matrix is 8 rows of 4 floats, and lane (group, tig) receives the float at
// (row group, col tig): the a0 / b0 position of the fragments above. So one
// ldmatrix.x4 fills a whole A fragment of Q, or the B fragments of K for two
// 8-key tiles.
//
// Tiles are row-major fp32 with rows padded to pad_f32(cols) = cols + 4
// floats (16 bytes, so 16-byte cp.async copies and ldmatrix rows stay
// aligned). The widths are multiples of 32, so the row stride is 4 words
// mod 32: the 8 rows of an ldmatrix 8 x 8 read fall on 8 different 16-byte
// bank groups, and a scalar read of (row 2 tig + {0,1}, col group), V's
// B fragment, on 32 different banks.
//
// 3xTF32: x = hi + lo with hi = rna_tf32(x) and lo = rna_tf32(x - hi);
// a b ~ lo(a) hi(b) + hi(a) lo(b) + hi(a) hi(b), summed smallest first. The
// dropped lo lo term is ~2^-22 |a b|: the sum is as accurate as fp32 FMA
// (tests/test_torch_port_tf32.py emulates it against the Pallas kernel).

#pragma once

#include <stdint.h>

#include "mma_bf16.cuh"   // cp.async, ldmatrix, quad_max, quad_sum

namespace mma_tf32 {

__host__ __device__ constexpr int pad_f32(int cols) { return cols + 4; }

// rows [r0, r0 + R) of a row-major (S, d) fp32 matrix into an R x COLS tile
// (row stride pad_f32(COLS)) by 16-byte cp.async copies, zeros for rows at or
// past S and for columns at or past d (COLS >= d, d % 4 == 0)
template <int COLS, int THREADS>
__device__ __forceinline__ void load_rows_async(float* dst, const float* src,
                                                int r0, int R, int S, int d,
                                                int tid) {
  constexpr int CHUNKS = COLS / 4;
  for (int i = tid; i < R * CHUNKS; i += THREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 4;
    const bool ok = r0 + r < S && c < d;
    mma_bf16::cp_async16(dst + r * pad_f32(COLS) + c,
                         ok ? src + (size_t)(r0 + r) * d + c : src, ok);
  }
}

// four 8 x 4 fp32 matrices (see the header) by one ldmatrix.x4 of b16
// 8 x 8 matrices; lanes 8 i .. 8 i + 7 give the row addresses of matrix i
__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const float* p) {
  mma_bf16::ldmatrix_x4(r, reinterpret_cast<const mma_bf16::bf16*>(p));
}

// Per-lane ldmatrix addresses into a tile with row stride `ld` floats:
// - the A fragment of rows [m0, m0 + 16), k columns [k0, k0 + 8):
//   r[0..3] = a0..a3;
__device__ __forceinline__ const float* frag_a(const float* tile, int ld,
                                               int m0, int k0, int lane) {
  const int i = lane >> 3;
  return tile + (m0 + (lane & 7) + (i & 1) * 8) * ld + k0 + (i >> 1) * 4;
}
// - the B fragments of two 8-wide n-tiles [n0, n0 + 16), k [k0, k0 + 8),
//   from a tile that stores B transposed (rows = n, cols = k: K for Q K^T):
//   r[0], r[1] = b0, b1 of n-tile n0; r[2], r[3] those of n0 + 8.
__device__ __forceinline__ const float* frag_b_nk(const float* tile, int ld,
                                                  int n0, int k0, int lane) {
  const int i = lane >> 3;
  return tile + (n0 + (lane & 7) + (i >> 1) * 8) * ld + k0 + (i & 1) * 4;
}

// fp32 -> tf32, round to nearest, ties away from zero: the bits of
// cvt.rna.tf32.f32 for every finite x and for +-inf, in two integer
// instructions (a NaN keeps its payload's top bits, so torch's NaN stays
// NaN; one whose top 10 mantissa bits are all set would wrap to 0). cvt runs
// on the conversion unit, 16 results a clock an SM, and two a split made it
// the kernel's bottleneck
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo, both tf32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(x);
  lo = rna_tf32(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split(uint32_t bits, uint32_t& hi,
                                      uint32_t& lo) {
  split(__uint_as_float(bits), hi, lo);
}

// c += a b, m16n8k8, tf32 inputs, fp32 accumulators. Not volatile: it
// reads registers only, so the compiler may interleave it with other work
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

}  // namespace mma_tf32
