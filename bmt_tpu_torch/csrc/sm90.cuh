// Hopper (sm_90a) building blocks of the attention kernels, all on wgmma:
// the forward (flash_attn_fwd.cu) and the backward (flash_attn_bwd.cu), in
// bf16 and fp32: mbarriers, TMA tile loads, clusters, shared-memory
// matrix descriptors and the warpgroup product wgmma.mma_async (bf16 or
// TF32 in, fp32 accumulators), in inline PTX; the layout of a head-dim
// tile (HeadDim for bf16, F32Tile for fp32) and, on the host, the tensor
// maps that TMA reads it by (tile_map, tile_map_f32), encoded at each
// launch.
//
// Tiles. A bf16 tile of R rows of the head dim padded to DP lies in shared
// memory as DP / COLS regions, one after another, each R rows of COLS
// columns: COLS = 64 (128-byte rows, the 128-byte swizzle) for DP >= 64 and
// COLS = 32 (64-byte rows, the 64-byte swizzle) for DP = 32. TMA writes a
// region with the swizzle of its tensor map: in each group of 8 rows
// (an atom: 1024 or 512 bytes, and so aligned), the 16-byte chunk c of row
// r goes to chunk c ^ (r % 8) (128-byte) or c ^ ((r / 2) % 4) (64-byte).
// The products read the same pattern through the descriptor's layout type.
//
// Descriptors (64 bits): start address >> 4 (bits 0-13), leading byte
// offset >> 4 (16-29), stride byte offset >> 4 (32-45), layout type
// (62-63: 1 = 128-byte swizzle, 2 = 64-byte). A tile is read in one of two
// ways:
// - K-major (the product's k runs along the head dim: Q K^T, K Q^T): rows
//   are M or N, 8-row atoms SBO = 8 x row bytes apart; a k-step of 16
//   columns starts 32 bytes further along the row, in region
//   16 kk / COLS (the swizzle applies to the address, so an offset inside
//   an atom's row is read through it);
// - MN-major (the product's k runs along the rows, N along the head dim:
//   P^T dO, dS^T Q, dS K): N spans the regions, LBO = R x row bytes apart,
//   k spans rows in 8-row atoms SBO = 8 x row bytes apart; a k-step of 16
//   rows starts 16 rows further on.
//
// Fragments (per warp w of a warpgroup, group = lane / 4, tig = lane % 4):
// the m64nN accumulator gives thread element 4 j + e at row 16 w + group +
// 8 (e / 2), column 8 j + 2 tig + e % 2; the register A operand of
// m64nNk16 holds, for the k-step's 16 columns, rows 16 w + group (+ 8) at
// columns 2 tig (+ 8), two bf16 a register, in the order (row, col) =
// (g, 2t), (g + 8, 2t), (g, 2t + 8), (g + 8, 2t + 8): the accumulator of
// one product converts to the A operand of the next in place.
//
// fp32 (the fp32 forward and backward, flash_attn_fwd.cu and
// flash_attn_bwd.cu): wgmma in TF32, m64nNk8,
// reads both operands K-major (the transposed B of the bf16 products is
// for 16-bit types alone) and a 32-bit word as TF32 by dropping its low 13
// bits. A fp32 tile (F32Tile) lies in regions of 32 floats (128-byte rows,
// the 128-byte swizzle: chunk c of row r at chunk c ^ (r % 8)); a k-step
// is 8 floats, 32 bytes along a row, so its descriptor is the bf16 one's
// in bytes. The register A operand of m64nNk8 .tf32 holds one fp32 word a
// register, (row, col) = (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4).
// Tensor maps of fp32 tensors: tile_map_f32. Blocks of a cluster reach each
// other's shared memory by st.async (map_to), which completes the other
// block's barrier. Three TF32 products make one fp32 product (product3,
// below): an operand in registers is split hi = rna(x), lo = rna(x - hi);
// one in shared memory keeps its raw word as hi (read truncated) beside
// lo = rna(x - trunc(x)) (lo_part, split_tile).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// arrive, and expect `bytes` more of TMA (or st.async) writes before the
// phase completes
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (the loop is inside
// the PTX, so the warp leaves it together)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// mbar_wait at the scope of the cluster: for a barrier that another
// block's st.async completes
__device__ __forceinline__ void mbar_wait_cluster(uint32_t bar,
                                                  uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      "@!p bra WAITC;\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// makes `bar`'s phase wait for this thread's earlier cp.async copies too
// (counted as one more arrival while they are in flight)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// ---------------------------------------------------------------------------
// TMA: one thread asks for a box; its bytes count toward `bar`'s phase.
// Elements outside the tensor land as zeros
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// fetches a tensor map (a __grid_constant__ parameter) ahead of its first
// TMA load
__device__ __forceinline__ void prefetch_tensormap(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(map))
               : "memory");
}

// ---------------------------------------------------------------------------
// warp specialisation: registers between warpgroups, named barriers
// ---------------------------------------------------------------------------

template <int N> __device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier `id` (1-15; 0 is __syncthreads) of `count` threads: arrive
// and go on, or arrive and wait for the rest
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// makes this thread's writes to shared memory visible to the async proxy
// (the wgmma products that read them next)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// clusters: a block's rank, the whole cluster's barrier, and another
// block's shared memory
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders shared-memory writes
// before it (release) with reads after it (acquire)
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release;\n"
      "barrier.cluster.wait.acquire;\n" ::: "memory");
}

// the address in block `rank`'s shared memory of `addr` in this block's
__device__ __forceinline__ uint32_t map_to(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r)
               : "r"(addr), "r"(rank));
  return r;
}

// 16 bytes into another block's shared memory (`addr` from map_to),
// asynchronously: they count as transaction bytes toward that block's
// barrier `bar` (from map_to), whose wait then sees them
__device__ __forceinline__ void st_async(uint32_t addr, float4 v,
                                         uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint32_t layout) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | ((uint64_t)layout << 62);
}

// orders this thread's register writes before the next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous products that own them
template <int N>
__device__ __forceinline__ void fence_operands(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for register A operands: they stay in their registers until
// here, after the wait for the products that read them
template <int N>
__device__ __forceinline__ void keep_live(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// m64nNk16 with bf16 operands and fp32 accumulators d (N / 2 a thread):
// from shared memory at N = 64 (the S and dP products), with the A operand
// in registers at N = DP (the gradient products). scale_d 0 overwrites d,
// 1 adds to it. TRANS_B 0: b is K-major, 1: MN-major
template <int N> struct Wgmma;

template <> struct Wgmma<32> {
  // d (+)= a b, a from registers (the A fragments of rows 16 warp ..
  // + 15 of the warpgroup), b from shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS_B));
  }
};

template <> struct Wgmma<64> {
  // d (+)= a b, a and b from shared memory (descriptors)
  template <int TRANS_B>
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d), "n"(TRANS_B));
  }
  // d (+)= a b, a from registers (the A fragments of rows 16 warp ..
  // + 15 of the warpgroup), b from shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS_B));
  }
};

template <> struct Wgmma<256> {
  // d (+)= a b, a from registers (the A fragments of rows 16 warp ..
  // + 15 of the warpgroup), b from shared memory
  template <int TRANS_B>
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, "
        "%88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, {%128, %129, %130, %131}, %132, p, 1, 1, %134;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
          "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
          "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
          "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
          "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d),
          "n"(TRANS_B));
  }
};

// m64nNk8 in TF32 with fp32 accumulators d (N / 2 a thread), the A operand
// in registers (fp32 words, read as TF32: the low 13 bits dropped), b a
// K-major descriptor. scale_d 0 overwrites d, 1 adds to it
template <int N> struct WgmmaTf32;

template <> struct WgmmaTf32<32> {
  static __device__ __forceinline__ void rs(float (&d)[16],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <> struct WgmmaTf32<64> {
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// ---------------------------------------------------------------------------
// tiles of the head dim, the roles of a block's warpgroups
// ---------------------------------------------------------------------------

// a fp32 tile of R rows (R a multiple of 8) in regions of 32 columns,
// rows of 128 bytes with the 128-byte swizzle, as TMA writes it from a
// tile_map_f32 map: the byte offset of element (row, col), and the K-major
// descriptor of all R rows at k-step kk (columns 8 kk .. 8 kk + 7)
template <int R> struct F32Tile {
  static constexpr uint32_t REGION = R * 128;
  static __device__ __forceinline__ uint32_t at(int row, int col) {
    return (col >> 5) * REGION + row * 128 +
           ((((col >> 2) & 7) ^ (row & 7)) << 4) + ((col & 3) << 2);
  }
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int kk) {
    return smem_desc(tile + (kk >> 2) * REGION + (kk & 3) * 32, 16, 1024, 1);
  }
};

// the shared-memory layout of a tile of the head dim padded to DP (see the
// top of this file): regions of COLS columns, rows of SW bytes
template <int DP> struct HeadDim {
  static constexpr int SW = DP >= 64 ? 128 : 64;      // swizzle span, bytes
  static constexpr int COLS = SW / 2;
  static constexpr int REGIONS = DP / COLS;
  static constexpr uint32_t LAYOUT = SW == 128 ? 1 : 2;
  static constexpr uint32_t ATOM = 8 * SW;            // bytes of 8 rows
  static constexpr CUtensorMapSwizzle SWIZZLE =
      SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;

  // K-major operand: rows [row0, row0 + 64) (A) or all N rows (B) of a tile
  // of `rows` rows at `tile`, k-step kk (head-dim columns 16 kk ..)
  static __device__ __forceinline__ uint64_t kmajor(uint32_t tile, int rows,
                                                    int row0, int kk) {
    const int col = 16 * kk;
    return smem_desc(tile + (col / COLS) * rows * SW + row0 * SW +
                         (col % COLS) * 2,
                     16, ATOM, LAYOUT);
  }
  // MN-major B operand: the tile's rows are the product's k (k-step kk:
  // rows 16 kk ..), its head-dim columns the product's N
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int rows,
                                                     int kk) {
    return smem_desc(tile + 16 * kk * SW, rows * SW, ATOM, LAYOUT);
  }
};

// a block of 384 threads, two consumer warpgroups and a producer one: its
// blocks an SM and, by setmaxnreg, the registers of a producer and of a
// consumer thread (the producer warpgroup gives registers to the
// consumers). One block of 168 registers a thread (128 x 40 + 256 x 232 =
// 384 x 168), or at DP = 32, where a tile's work is small and its
// per-element steps set the pace, two of 80 (128 x 32 + 256 x 104)
template <int DP> struct Occupancy {
  static constexpr int BLOCKS = DP == 32 ? 2 : 1;
  static constexpr int PRODUCER_REGS = DP == 32 ? 32 : 40;
  static constexpr int CONSUMER_REGS = DP == 32 ? 104 : 232;
};

// the A operand fragments of the k-steps of a 64 x N accumulator, rounded
// to bf16: a[kk] covers its columns 16 kk .. 16 kk + 15
template <int N>
__device__ __forceinline__ void to_a_fragments(const float (&c)[N / 2],
                                               uint32_t (&a)[N / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// the thread's warpgroup and warp, read through a shuffle so that the
// compiler knows them to be uniform over a warp: a branch on them is not
// divergent, and the wgmma products inside it are not serialised
__device__ __forceinline__ int warpgroup(int tid) {
  return __shfl_sync(0xffffffffu, tid >> 7, 0);
}
__device__ __forceinline__ int warp_of(int tid) {
  return __shfl_sync(0xffffffffu, tid >> 5, 0);
}

// the first 1024-byte boundary of dynamic shared memory (the 128-byte
// swizzle's atom): tiles are laid out from there
__device__ __forceinline__ uint32_t aligned_base(const unsigned char* raw) {
  return (smem_u32(raw) + 1023) & ~1023u;
}

// ---------------------------------------------------------------------------
// three TF32 products for one fp32 product: the operands' splits, the
// products, the cluster's partial sums (the fp32 kernels, flash_attn_fwd.cu
// and flash_attn_bwd.cu)
// ---------------------------------------------------------------------------

// 2^x by the special-function unit (ex2.approx.ftz: within 2^-22
// relative; 0 for a result under 2^-126, a P that moves no fp32 sum):
// exp2f's accurate path doubled the time P takes
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// fp32 -> tf32 bits, round to nearest, ties away from zero (the bits of
// cvt.rna.tf32.f32, in two integer instructions)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// The lo part of a B operand, whose raw word serves as hi (the tensor
// core reads it truncated): x - trunc(x), exact in fp32, rounded to tf32
__device__ __forceinline__ float lo_part(float x) {
  return __uint_as_float(
      rna_tf32(x - __uint_as_float(__float_as_uint(x) & 0xFFFFE000u)));
}

// the lo parts of the BYTES of fp32 at src into dst, at the same offsets
// (so in the same swizzled layout), by the 128 threads of a warpgroup (all
// loads, then all stores), made visible to its products
template <uint32_t BYTES>
__device__ __forceinline__ void split_tile(const unsigned char* src,
                                           unsigned char* dst, int t) {
  constexpr int N = BYTES / (128 * 16);
  float4 x[N];
#pragma unroll
  for (int j = 0; j < N; ++j)
    x[j] = *reinterpret_cast<const float4*>(src + (j * 128 + t) * 16);
#pragma unroll
  for (int j = 0; j < N; ++j)
    *reinterpret_cast<float4*>(dst + (j * 128 + t) * 16) = make_float4(
        lo_part(x[j].x), lo_part(x[j].y), lo_part(x[j].z), lo_part(x[j].w));
  fence_proxy_async();
}

// the register A operand of k-step kk: rows 16 w + g (+ 8), columns
// 8 kk + t (+ 4) of a tile of R rows (S = Q K^T reads Q so)
template <int R>
__device__ __forceinline__ void frag_rows(const unsigned char* tile, int w,
                                          int lane, int, int kk,
                                          float (&x)[4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const float*>(
        tile + F32Tile<R>::at(16 * w + g + 8 * (i & 1),
                              8 * kk + t + 4 * (i >> 1)));
}

// the register A operand of k-step kk from a fp32 tile of R rows read by
// columns: A(m, k) = tile(k, m) with m = 64 mb + 16 w + g (+ 8), k = 8 kk +
// t (+ 4) (dQ^T = K^T dS^T reads K so, O^T = V^T P^T reads V)
template <int R>
__device__ __forceinline__ void frag_cols(const unsigned char* tile, int w,
                                          int lane, int mb, int kk,
                                          float (&x)[4]) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    x[i] = *reinterpret_cast<const float*>(
        tile + F32Tile<R>::at(8 * kk + t + 4 * (i >> 1),
                              64 * mb + 16 * w + g + 8 * (i & 1)));
}

// the A operands in flight (product3): two slots of K k-steps, hi =
// rna(x) and lo = rna(x - hi), four registers each; keep_ring holds them
// in their registers until the products that read them have finished
template <int K>
__device__ __forceinline__ void keep_slot(uint32_t (&r)[K][2][4]) {
#pragma unroll
  for (int s = 0; s < K; ++s) keep_live(r[s]);
}
template <int K>
__device__ __forceinline__ void keep_ring(uint32_t (&r)[2][K][2][4]) {
  keep_slot(r[0]);
  keep_slot(r[1]);
}

// d[m] (+)= A_m B over KS k-steps for each of MB row blocks m, in three
// TF32 products a k-step, smallest first: lo(A) hi(B), hi(A) lo(B),
// hi(A) hi(B). With SEP the two small ones go into c[m] and the caller
// adds c to d once the products have finished (as S and dP are taken: the
// small terms added to a large accumulator lose their low bits, truncated,
// at each add); else all into d[m] (pass d as c). add = false overwrites d
// (and c). A's fragments
// come from frag(m, kk, x) (raw fp32) and are split in registers; B is
// K-major in shared memory, its raw tile at bhi(kk) (read truncated: hi)
// and its lo parts at blo(kk). G k-steps make a group of products, one
// group in flight: a group's fragments are loaded and split into one slot
// of the ring while the group before runs from the other, then the wait
// for that one and the issue. (With two groups in flight, wait<1>, ptxas
// serialises every product: C7514.) A product has an even number of
// groups, so the next one starts in the slot its predecessor's last group
// did not use
template <int N, int MB, int KS, int G, bool SEP, int K, class Frag,
          class Hi, class Lo>
__device__ __forceinline__ void product3(float (&d)[MB][N / 2],
                                         float (&c)[MB][N / 2],
                                         uint32_t (&ring)[2][K][2][4],
                                         Frag frag, Hi bhi, Lo blo,
                                         bool add) {
  static_assert(G <= K && KS % G == 0 && (MB * KS / G) % 2 == 0,
                "product3: an even number of whole groups");
#pragma unroll
  for (int m = 0; m < MB; ++m) {
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += G) {
      const int slot = ((m * KS + k0) / G) & 1;
#pragma unroll
      for (int s = 0; s < G; ++s) {
        float x[4];
        frag(m, k0 + s, x);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const uint32_t hi = rna_tf32(x[i]);
          ring[slot][s][0][i] = hi;
          ring[slot][s][1][i] = rna_tf32(x[i] - __uint_as_float(hi));
        }
      }
      wgmma_wait<0>();                   // the group before
      keep_slot(ring[slot ^ 1]);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < G; ++s) {
        const int kk = k0 + s;
        WgmmaTf32<N>::rs(c[m], ring[slot][s][1], bhi(kk), add || kk > 0);
        WgmmaTf32<N>::rs(c[m], ring[slot][s][0], blo(kk), 1);
        WgmmaTf32<N>::rs(d[m], ring[slot][s][0], bhi(kk),
                         !SEP || add || kk > 0);
      }
      wgmma_commit();
    }
  }
}

// S or dP (NA = 1), or both (NA = 2: x and y), over this block's head-dim
// columns plus the other block's of the cluster (CL = 2): thread t stores
// its 16 values of each into the other block's receive buffer `recv` (4
// float4 at q 128 + t, y 8 KB after x) by st.async, whose bytes complete
// the other's barrier `bar`, waits for the other block's on its own, and
// adds them. x + y is y + x, so both blocks hold the same bits
template <int CL, int NA>
__device__ __forceinline__ void cluster_sum(float (&x)[16], float (&y)[16],
                                            uint32_t recv, const float4* mine,
                                            uint32_t bar, uint32_t phase,
                                            int t) {
  if (CL == 1) return;
  const uint32_t other = cluster_rank() ^ 1u;
  const uint32_t dst = map_to(recv, other), dst_bar = map_to(bar, other);
  if (t == 0) mbar_arrive_expect_tx(bar, NA * 128 * 16 * 4);  // the other's
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const float* v = a == 0 ? x : y;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      st_async(dst + ((a * 4 + q) * 128 + t) * 16,
               make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]),
               dst_bar);
  }
  mbar_wait_cluster(bar, phase);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    float* v = a == 0 ? x : y;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float4 z = mine[(a * 4 + q) * 128 + t];
      v[4 * q] += z.x;
      v[4 * q + 1] += z.y;
      v[4 * q + 2] += z.z;
      v[4 * q + 3] += z.w;
    }
  }
}

// a 64 x 32 accumulator (element 4 j + e at row 16 w + g + 8 (e / 2),
// column 8 j + 2 t + e % 2) into a 64-row tile at hi (as it is) and lo
// (lo_part): the K-major B operand of a product (the backward's dS, P^T
// and dS^T, the forward's P)
__device__ __forceinline__ void store_grad_tile(const float (&s)[16],
                                                unsigned char* hi,
                                                unsigned char* lo, int w,
                                                int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t at = F32Tile<64>::at(16 * w + g + 8 * hf, 8 * j + 2 * t);
      const float a = s[4 * j + 2 * hf], b = s[4 * j + 2 * hf + 1];
      *reinterpret_cast<float2*>(hi + at) = make_float2(a, b);
      *reinterpret_cast<float2*>(lo + at) =
          make_float2(lo_part(a), lo_part(b));
    }
}

// ---------------------------------------------------------------------------
// host: the tensor maps, encoded at each launch
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found once through the runtime's
// entry-point query (no link against libcuda); null where it is missing
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// a (BH, S, d) tensor of `esize`-byte elements as a rank-3 map (d, S, BH)
// read in boxes of (cols, rows, 1) with the given swizzle; outside the
// tensor the box fills with zeros. False when the map does not encode.
// The map holds the tensor's address and travels as a __grid_constant__
// parameter, so a CUDA graph that captures the launch (a train step's,
// train/graphs.py) replays the map as it was encoded. That is sound only
// because a graph's tensors never move: its inputs are fixed buffers, its
// activations come from its own memory pool at fixed addresses, and a
// replay refuses a state whose tensors were rebound after the capture.
// cudaFuncSetAttribute, called at every launch, is allowed while a stream
// captures (the graphed steps run on the H100 with it)
inline bool rank3_map(CUtensorMap* map, const void* ptr,
                      CUtensorMapDataType type, int esize, int d, int S,
                      int BH, int cols, int rows, CUtensorMapSwizzle swizzle) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * esize,
                                 (cuuint64_t)S * d * esize};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a bf16 tensor in boxes of HeadDim<DP>'s regions
template <int DP>
bool tile_map(CUtensorMap* map, const void* ptr, int d, int S, int BH,
              int rows) {
  return rank3_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, d, S, BH,
                   HeadDim<DP>::COLS, rows, HeadDim<DP>::SWIZZLE);
}

// a fp32 tensor in boxes of F32Tile's regions (32 columns, the 128-byte
// swizzle)
inline bool tile_map_f32(CUtensorMap* map, const void* ptr, int d, int S,
                         int BH, int rows) {
  return rank3_map(map, ptr, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, d, S, BH, 32,
                   rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

// a launch of `kernel` in blocks of 384 threads (two consumer warpgroups
// and a producer one) in clusters of `cl` blocks along x, with `smem` bytes
// of dynamic shared memory: the fp32 kernels' (flash_attn_fwd.cu,
// flash_attn_bwd.cu)
template <class... Params, class... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), dim3 grid, int cl,
                            size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(384);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace sm90
