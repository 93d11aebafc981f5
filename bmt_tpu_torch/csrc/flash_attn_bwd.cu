// Masked attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV, in a tensor-core version for each dtype.
//
// Replaces the two Pallas backward kernels of bmt_tpu/ops/pallas_attention.py,
// both launched by `_flash_attention_tiled_bwd`:
//   tf32::flash_attn_bwd_dq_tf32_kernel (fp32),
//   wg::flash_attn_bwd_dq_sm90_kernel (bf16)
//       <- `_dq_kernel`  (:351-389, pallas_call :473)
//   tf32::flash_attn_bwd_dkv_tf32_kernel (fp32),
//   wg::flash_attn_bwd_dkv_sm90_kernel (bf16)
//       <- `_dkv_kernel` (:392-431, pallas_call :498)
// and the XLA recompute of the single-block custom VJP (`_fa_bwd`, :558-581),
// which computes the same gradient.
//
// What they compute, per (b, h), from the forward's row log-sum-exp `lse`
// (flash_attn_fwd.cu) and the row dot D = rowsum(dO * O) with NaN -> 0 (the
// wrapper computes D in plain torch, as the JAX package does outside Pallas,
// :455-457):
//   valid[i, j] = key_mask[b, j] != 0 && j < Sk && (!causal || j <= i)
//   P  = valid ? exp(q k^T * scale - lse) : 0          (`_recon_p`, :332-348)
//   dS = P * (dO v^T - D) * scale
//   dQ = dS k,   dK = dS^T q,   dV = P^T dO
// with `valid ? exp(..) : 0`, never exp then mask: an empty row has
// lse = -inf and no valid column, so it gets P = 0 and zero gradients rather
// than exp(+inf) * 0 = NaN. Logits, P, dS and the accumulators are fp32; as in
// the Pallas kernels, dS is rounded to the input dtype before dQ and dK, P
// before dV (no-ops in fp32), and each gradient takes the input dtype.
//
// Design. No atomics: as in the JAX design, dQ and dK/dV are two kernels, so
// every gradient element is summed by one thread in one fixed order and the
// gradients are the same bits from run to run.
// - dQ: one thread block per (query tile, head, batch). It keeps its Q and
//   dO tiles in shared memory and loops over key tiles, rebuilding P and dS
//   per tile; dQ accumulates in registers. With `causal`, key tiles wholly
//   above the diagonal are never loaded.
// - dK/dV: one block per (key tile, head, batch). It keeps its K and V
//   tiles in shared memory and loops over query tiles; dK and dV accumulate
//   in registers for the block's life. With `causal`, query tiles that end
//   before the key tile starts are skipped. The sequential grid axis that
//   carried the Pallas accumulators in VMEM becomes this in-block loop;
//   nothing crosses blocks.
// Both run every product on tensor cores: 3xTF32 mma.sync for float32
// (below), bf16 wgmma for bfloat16 (further below). The head dim is padded
// to DP (a template parameter: 64 or 256 in fp32, 32, 64 or 256 in bf16;
// the padded columns load as 0 and are not stored), so d need only be a
// multiple of 8. Ragged edges: key rows >= Sk load as 0 and are masked,
// query rows >= Sq load as 0 and get P = 0 (not relying on dO = 0 there),
// and gradient rows past Sq or Sk are not stored. Tiles arrive in a ring of
// stages, so tile t + 1 loads while tile t computes.
//
// fp32 (the fp32 train steps: make_cap_train_step's and
// make_prop_train_step's default compute dtype, and the parity checks):
// tiles by 16-byte cp.async copies in a ring of two stages, tensor cores in
// TF32 by mma.sync m16n8k8, three products per product (csrc/mma_tf32.cuh), so
// the gradients are as accurate as fp32 FMA; one TF32 product misses the
// fp32 tolerances (tests/test_torch_port_tf32.py). What bounds them on this
// card: three m16n8k8 products per fp32 product make the peak 495 / 3 = 165
// TFLOP/s, and the train cell's 256x256 calls move 77-85 FLOP per byte
// against the 49 at which that peak and HBM's 3.35 TB/s cross, so they are
// bound by operations (dQ 12.9 GFLOP, 0.078 ms; dK/dV 17.2 GFLOP, 0.104 ms).
// Before the tensor cores come the instructions around them: each operand is
// split in registers into hi + lo (five instructions a value, mma_tf32.cuh),
// which set the pace of the fp32 forward (PERF.md). The design (the same for
// both kernels, with the roles of queries and keys swapped; "rows" are the
// block's queries in dQ and its keys in dK/dV, "columns" those of the loop's
// tiles):
// - BM = 64 rows a block, tiles of BN = 16 columns, 8 warps. Warps w and
//   w + 4 share rows 16 (w % 4) .. + 15 and all 16 columns of each tile.
//   Warp w computes S and dP (dQ: S = Q K^T, dP = dO V^T; dK/dV: S^T =
//   K Q^T, dP^T = V dO^T) over head-dim half w / 4 only: the rows' A
//   fragments and the tile's B fragments by ldmatrix, each value split once
//   for the three products lo hi, hi lo and hi hi, which go into three
//   accumulators summed (lh + hl) + hh. The pair then hands its halves to
//   each other through shared memory (a named barrier of 64 threads) and
//   both add them, x + y being y + x, so both hold the same S and dP.
// - P and dS are rebuilt in registers (exp2 of base-2 logits) and used as
//   they stand as the A fragment of the gradient product, as the fp32
//   forward uses P: the S accumulator gives lane (group, tig) columns
//   2 tig and 2 tig + 1 where the A fragment wants k = tig and tig + 4, so k
//   is mapped to columns in that order and the B operand (K for dQ = dS K;
//   dO and Q for dV = P^T dO and dK = dS^T Q) is read by scalar loads of its
//   rows 2 tig and 2 tig + 1, free of bank conflicts at the padded stride.
//   TF32 fragments cannot be transposed by ldmatrix .trans (16-bit words
//   only); this way no operand needs it and P and dS never touch shared
//   memory.
// - Warp w accumulates the gradient for head-dim half w / 4: dQ 16 x DP/2
//   (64 registers a thread at DP = 256), dK and dV 2 x 16 x DP/2 (128).
// - Shared memory at DP = 256, rows of 256 + 4 floats: the block's two 64-row
//   tiles (133,120 bytes), two stages of the loop's two 16-row tiles
//   (66,560) and the pair exchange (16,384): 216,192 bytes (dQ) and 216,576
//   (dK/dV, with the query tiles' lse and D), one block an SM. Registers
//   from ptxas -v are in PERF.md.
//
// bf16 (the bf16 train and serving paths): every product by wgmma.mma_async
// (bf16 in, fp32 accumulators) on tiles that TMA brings into shared memory
// (csrc/sm90.cuh). What bounds them: the train cell's 256x256 calls move
// 128-170 FLOP per byte at d = 256, under the H100's 295, so HBM bounds
// them (dQ 84.2 MB, 0.0251 ms; dK/dV 101.0 MB, 0.0301 ms); the proposal
// cell's 800x800 calls do 62.9 and 83.9 GFLOP, and the tensor cores bound
// them (0.0636 and 0.0848 ms). Before either come the tiles of the other
// side, which every block reads again from L2 (64 KB a 64-row tile at
// d = 256, for 64 rows of its own), and the per-element steps between the
// products. The design, alike in both kernels ("rows" are the block's keys
// in dK/dV and its queries in dQ, "columns" those of the loop's tiles):
// - 384 threads: warpgroups 0 and 1 compute, warp 8 (of warpgroup 2)
//   loads; setmaxnreg moves registers from the loading warpgroup to the
//   computing ones.
// - The loading warp brings the block's own 64-row tiles (K and V, or Q
//   and dO) once and each 64-row tile of the loop into a ring of stages (2
//   at DP = 256, 3 or 4 below) by TMA from rank-3 tensor maps (d, S, B H)
//   encoded at each launch: regions of 64 columns with the 128-byte
//   swizzle (32 and the 64-byte one at DP = 32); rows past S and columns
//   past d arrive as zeros. With a tile come its lse and D (dK/dV) or key
//   validity (dQ) by cp.async, zero past Sq or Sk; the stage's full
//   mbarrier waits for both, and its empty mbarrier for all 256 computing
//   threads to be done with it.
// - Warpgroup 0 computes S^T = K Q^T (dK/dV) or S = Q K^T (dQ), 64 rows by
//   64 columns over the head dim (both operands K-major from shared
//   memory), and P = valid ? exp(..) : 0. It hands P (fp32) to warpgroup 1
//   through a 16 KB shared buffer (named barriers P_READY and P_FREE):
//   thread t of either warpgroup holds the same elements, so nothing is
//   transposed. In dK/dV it then runs dV += P^T dO, P^T rounded to bf16 as
//   the register A operand and dO read MN-major from its tile (bf16 allows
//   the transposed B, TF32 does not).
// - Warpgroup 1 computes dP^T = V dO^T (dP = dO V^T), dS from P, and
//   dK += dS^T Q (dQ += dS K) the same way, dS rounded to bf16 in registers.
//   The products are split by warpgroup, not by rows, because one 64 x DP
//   fp32 accumulator takes 128 registers a thread at DP = 256: a
//   warpgroup holds one (dV or dK; in dQ warpgroup 1 holds dQ).
// - A tile's gradient product runs on while the next tile's S or dP is
//   issued; the tile's stage is released when it has finished.
// - The roles branch on the warpgroup index read through a shuffle, which
//   the compiler knows to be uniform over a warp. Read from threadIdx
//   directly, it made ptxas serialise dQ's products (C7518: a wait after
//   each wgmma), and the pair ran 1.11x slower at 800x800 (PERF.md).
// - dQ's block is 64 query rows: Q and dO take 64 KB at DP = 256, two
//   stages of 64-key K and V tiles 128 KB, so S and dP are m64n64k16
//   products. A block of 128 rows (Q and dO 128 KB) left room only for
//   32-key tiles, whose m64n32k16 products each read their 2 KB A operand
//   for half the work, and ran 1.2x slower at 800x800 (PERF.md).
// - At DP = 32 two blocks share an SM (80 registers a thread at launch,
//   104 for a computing one): there a tile's products are small and the
//   per-element steps and waits set the pace, which a second block hides.
// ptxas -v (sm_90a, CUDA 12.8): 168 registers at DP = 64 and 256 (the
// launch bound of 384 threads; setmaxnreg 40 and 232), 80 at DP = 32 (32
// and 104), no spills; dynamic shared memory at DP = 256: dK/dV 215,080
// bytes, dQ 214,568 (one block an SM). Grids: dK/dV ceil(Sk / 64) x H x B,
// dQ ceil(Sq / 64) x H x B (512 blocks each at the train cell, 3.9 waves on
// 132 SMs; 832 at 800x800, B = 16); no persistent tile loop. Times in
// PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (bmt_tpu_torch/ops/_build.py). No
// fast-math: the empty-row rules rely on IEEE infinities.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
#include "sm90.cuh"

namespace {

constexpr int MAX_D = 256;

// ---------------------------------------------------------------------------
// fp32: tensor cores in TF32, three products (mma.sync m16n8k8), cp.async
// tiles
// ---------------------------------------------------------------------------

namespace tf32 {

using namespace mma_tf32;
using mma_bf16::cp_async4;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;

constexpr int BM = 64;               // rows a block: dQ queries, dK/dV keys
constexpr int BN = 16;               // rows a tile of the block's loop
constexpr int THREADS = 256;         // 8 warps: 4 row slices x 2 dim halves
constexpr int NG = 4;                // column tiles a group of products
constexpr int XCH = 16;              // floats a lane hands its partner a tile
constexpr float LOG2E = 1.44269504088896341f;

// the block's two BM-row tiles, two stages of the loop's two BN-row tiles
// (head dim padded to DP), the pair exchange, then `extra` bytes of small
// arrays
template <int DP> constexpr size_t smem_bytes(size_t extra) {
  return (size_t)(2 * BM + 4 * BN) * pad_f32(DP) * sizeof(float) +
         THREADS * XCH * sizeof(float) + extra;
}

// c = a b^T for rows [m0, m0 + 16) of tile A and rows [0, 16) of tile Bt
// (both row stride LD), over the KS k-steps of 8 columns from column k0:
// each step's fragments by ldmatrix (those of step kk + 1 loaded before the
// products of step kk), each split once for its three products lo hi,
// hi lo and hi hi, which go into three accumulators so that no mma waits
// on the one before it, summed (lh + hl) + hh. c[j][e]: row
// m0 + group + 8 (e / 2), column j 8 + 2 tig + e % 2
template <int KS>
__device__ __forceinline__ void product_abt(const float* A, const float* Bt,
                                            int LD, int m0, int k0, int lane,
                                            float c[2][4]) {
  float lh[2][4], hl[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = lh[j][e] = hl[j][e] = 0.f;
  uint32_t fa[2][4], fb[2][4];
  ldmatrix_x4(fa[0], frag_a(A, LD, m0, k0, lane));
  ldmatrix_x4(fb[0], frag_b_nk(Bt, LD, 0, k0, lane));
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int cur = kk & 1;
    if (kk + 1 < KS) {
      ldmatrix_x4(fa[cur ^ 1], frag_a(A, LD, m0, k0 + kk * 8 + 8, lane));
      ldmatrix_x4(fb[cur ^ 1], frag_b_nk(Bt, LD, 0, k0 + kk * 8 + 8, lane));
    }
    uint32_t ah[4], al[4], bhi[2][2], blo[2][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      split(fa[cur][i], ah[i], al[i]);
      split(fb[cur][i], bhi[i >> 1][i & 1], blo[i >> 1][i & 1]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) mma(lh[j], al, bhi[j][0], bhi[j][1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma(hl[j], ah, blo[j][0], blo[j][1]);
#pragma unroll
    for (int j = 0; j < 2; ++j) mma(c[j], ah, bhi[j][0], bhi[j][1]);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[j][e] = (lh[j][e] + hl[j][e]) + c[j][e];
}

// The two warps of a row slice each hold S and dP over one half of the head
// dim: each writes its halves to `mine`, waits for its partner at named
// barrier 1 + slice (64 threads; 0 is __syncthreads), and adds the
// partner's from `theirs`. x + y is y + x, so both warps end with the same
// bits. `mine` is written again only after the next __syncthreads, which
// the partner reaches after its reads
__device__ __forceinline__ void pair_sum(float s[2][4], float dp[2][4],
                                         float* mine, const float* theirs,
                                         int slice, int lane) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    mine[i * 32 + lane] = s[i >> 2][i & 3];
    mine[(8 + i) * 32 + lane] = dp[i >> 2][i & 3];
  }
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + slice) : "memory");
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    s[i >> 2][i & 3] += theirs[i * 32 + lane];
    dp[i >> 2][i & 3] += theirs[(8 + i) * 32 + lane];
  }
}

// acc += a b over 16 k for the NT 8-wide column tiles of b from column n0:
// a (16 x 16) as the C fragments product_abt gives (a[j][e]: row
// group + 8 (e / 2), k j 8 + 2 tig + e % 2), b rows [0, 16) of tile B (row
// stride LD, rows = k). The mma's k = tig and tig + 4 of step j take a's k
// j 8 + 2 tig and j 8 + 2 tig + 1, so the A fragment is a[j] in the order
// c0, c2, c1, c3 and b's B fragment is its rows j 8 + 2 tig and + 1 at
// column group, read as scalars. Each value is split once. Per group of NG
// column tiles the two steps' lo hi, hi lo and hi hi go into a zeroed
// accumulator, which is then added to acc in fp32: an mma adds its sum to
// its accumulator truncated, not rounded, and a long run of small terms
// into a large accumulator drifts (dV of a causal call's first keys
// gathers thousands of them), while one rounded add a tile does not
template <int NT>
__device__ __forceinline__ void product_acc(float acc[NT][4],
                                            const float a[2][4],
                                            const float* B, int LD, int n0,
                                            int tig, int group) {
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    split(a[j][0], ah[j][0], al[j][0]);
    split(a[j][2], ah[j][1], al[j][1]);
    split(a[j][1], ah[j][2], al[j][2]);
    split(a[j][3], ah[j][3], al[j][3]);
  }
  const float* b0 = B + 2 * tig * LD + n0 + group;
#pragma unroll
  for (int n = 0; n < NT; n += NG) {
    float t[NG][4];
#pragma unroll
    for (int g = 0; g < NG; ++g) t[g][0] = t[g][1] = t[g][2] = t[g][3] = 0.f;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      uint32_t bh[NG][2], bl[NG][2];
#pragma unroll
      for (int g = 0; g < NG; ++g) {
        split(b0[j * 8 * LD + (n + g) * 8], bh[g][0], bl[g][0]);
        split(b0[(j * 8 + 1) * LD + (n + g) * 8], bh[g][1], bl[g][1]);
      }
#pragma unroll
      for (int g = 0; g < NG; ++g) mma(t[g], al[j], bh[g][0], bh[g][1]);
#pragma unroll
      for (int g = 0; g < NG; ++g) mma(t[g], ah[j], bl[g][0], bl[g][1]);
#pragma unroll
      for (int g = 0; g < NG; ++g) mma(t[g], ah[j], bh[g][0], bh[g][1]);
    }
#pragma unroll
    for (int g = 0; g < NG; ++g)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n + g][e] += t[g][e];
  }
}

// dQ. Block (x, y, z): query rows [64 x, 64 x + 64) of head y, batch z;
// key tiles of BN rows in order. DP: the head dim the tiles are padded to
// (64 or 256, >= d)
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dq_tf32_kernel(const float* __restrict__ q,
                              const float* __restrict__ k,
                              const float* __restrict__ v,
                              const int32_t* __restrict__ key_mask,
                              const float* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ drow,
                              float* __restrict__ dq, int H, int Sq, int Sk,
                              int d, int causal, float scale) {
  constexpr int LD = pad_f32(DP);
  constexpr int HD = DP / 2;         // the warp's half of the head dim
  constexpr int NT = HD / 8;         // its 8-wide column tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);   // BM x LD
  float* dOs = Qs + BM * LD;                        // BM x LD
  float* Ks = dOs + BM * LD;                        // 2 x BN x LD
  float* Vs = Ks + 2 * BN * LD;                     // 2 x BN x LD
  float* xs = Vs + 2 * BN * LD;                     // 8 warps x XCH x 32
  int32_t* valid_s = reinterpret_cast<int32_t*>(xs + THREADS * XCH);  // 2 x BN

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + bh * Sk * d;
  const float* vb = v + bh * Sk * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  int n_tiles = (Sk + BN - 1) / BN;
  // causal: the block's last valid row sees keys up to itself
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, Sq) - 1) / BN + 1);

  // key tile t into stage t & 1: K, V rows (0 past Sk) and key validity
  auto load_kv = [&](int t) {
    const int k0 = t * BN, st = t & 1;
    load_rows_async<DP, THREADS>(Ks + st * BN * LD, kb, k0, BN, Sk, d, tid);
    load_rows_async<DP, THREADS>(Vs + st * BN * LD, vb, k0, BN, Sk, d, tid);
    if (tid < BN) {
      const bool in = k0 + tid < Sk;
      cp_async4(valid_s + st * BN + tid, in ? mb + k0 + tid : mb, in);
    }
  };
  load_rows_async<DP, THREADS>(Qs, q + bh * Sq * d, q0, BM, Sq, d, tid);
  load_rows_async<DP, THREADS>(dOs, dout + bh * Sq * d, q0, BM, Sq, d, tid);
  load_kv(0);
  cp_async_commit();

  // warp roles: query rows m0..m0+15 of the block with its partner warp
  // ^ 4; head-dim columns c0..c0+HD-1 for its halves of S and dP and for dQ
  const int slice = warp & 3, m0 = slice * 16, c0 = (warp >> 2) * HD;
  float* mine = xs + warp * XCH * 32;
  const float* theirs = xs + (warp ^ 4) * XCH * 32;
  const float scale2 = scale * LOG2E;
  // this thread's two query rows (those of its C fragments), their lse in
  // base-2 units and their D; rows past Sq read nothing and are masked
  int row[2];
  float lse2[2], D[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + m0 + group + 8 * hf;
    const bool in = row[hf] < Sq;
    lse2[hf] = in ? lse[bh * Sq + row[hf]] * LOG2E : -INFINITY;
    D[hf] = in ? drow[bh * Sq + row[hf]] : 0.f;
  }
  // uniform over the pair: false when its rows all lie past Sq (decoder
  // calls have Sq = 21 in a 64-row block)
  const bool rows_live = q0 + m0 < Sq;
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // one barrier a tile: after it, tile t has landed and every warp is done
  // with tile t - 1, so its stage (which tile t + 1 takes) and the pair
  // exchange are free
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                    // Q, dO and tile t have landed
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);   // overlaps this tile
    cp_async_commit();
    const int k0 = t * BN;
    const float* Kt = Ks + (t & 1) * BN * LD;
    const float* Vt = Vs + (t & 1) * BN * LD;
    const int32_t* vt = valid_s + (t & 1) * BN;
    // skip, uniform over the pair, when its rows all lie past Sq or
    // (causal) every key of the tile lies after them: dS is 0 there
    if (!rows_live || (causal && k0 > q0 + m0 + 15)) continue;
    float s[2][4], dp[2][4];
    product_abt<HD / 8>(Qs, Kt, LD, m0, c0, lane, s);
    product_abt<HD / 8>(dOs, Vt, LD, m0, c0, lane, dp);
    pair_sum(s, dp, mine, theirs, slice, lane);
    // P = valid ? exp(S scale - lse) : 0 (never exp then mask), as
    // 2^(S scale log2(e) - lse log2(e)), and dS = P (dP - D) scale into s
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1, kl = j * 8 + 2 * tig + (e & 1);
        const bool ok = vt[kl] != 0 && row[hf] < Sq &&
                        (!causal || k0 + kl <= row[hf]);
        const float p = ok ? exp2f(s[j][e] * scale2 - lse2[hf]) : 0.f;
        s[j][e] = ok ? p * (dp[j][e] - D[hf]) * scale : 0.f;
      }
    }
    // dQ += dS K for head-dim columns c0..c0+HD-1
    product_acc<NT>(acc, s, Kt, LD, c0, tig, group);
  }

  float* gq = dq + bh * Sq * d;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = c0 + n * 8 + 2 * tig;
      if (c >= d) continue;
      *reinterpret_cast<float2*>(gq + (size_t)row[hf] * d + c) =
          make_float2(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

// dK/dV. Block (x, y, z): key rows [64 x, 64 x + 64) of head y, batch z;
// query tiles of BN rows in order, with their lse and D. DP as above
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_tf32_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const int32_t* __restrict__ key_mask,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ drow,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int H, int Sq, int Sk, int d, int causal,
                               float scale) {
  constexpr int LD = pad_f32(DP);
  constexpr int HD = DP / 2;
  constexpr int NT = HD / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Ks = reinterpret_cast<float*>(smem_raw);   // BM x LD
  float* Vs = Ks + BM * LD;                         // BM x LD
  float* Qs = Vs + BM * LD;                         // 2 x BN x LD
  float* dOs = Qs + 2 * BN * LD;                    // 2 x BN x LD
  float* xs = dOs + 2 * BN * LD;                    // 8 warps x XCH x 32
  float* lse_s = xs + THREADS * XCH;                // 2 x BN
  float* D_s = lse_s + 2 * BN;                      // 2 x BN
  int32_t* valid_s = reinterpret_cast<int32_t*>(D_s + 2 * BN);  // BM

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BM;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const float* qb = q + bh * Sq * d;
  const float* ob = dout + bh * Sq * d;
  const float* lb = lse + bh * Sq;
  const float* db = drow + bh * Sq;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  load_rows_async<DP, THREADS>(Ks, k + bh * Sk * d, k0, BM, Sk, d, tid);
  load_rows_async<DP, THREADS>(Vs, v + bh * Sk * d, k0, BM, Sk, d, tid);
  if (tid < BM) {
    const bool in = k0 + tid < Sk;
    cp_async4(valid_s + tid, in ? mb + k0 + tid : mb, in);   // 0 past Sk
  }
  const int n_tiles = (Sq + BN - 1) / BN;
  // causal: tile t ends at row t BN + BN - 1, before k0 for t < k0 / BN
  const int first = causal ? k0 / BN : 0;
  // query tile t into stage (t - first) & 1: Q, dO rows (0 past Sq), lse, D
  auto load_q = [&](int t) {
    const int q0 = t * BN, st = (t - first) & 1;
    load_rows_async<DP, THREADS>(Qs + st * BN * LD, qb, q0, BN, Sq, d, tid);
    load_rows_async<DP, THREADS>(dOs + st * BN * LD, ob, q0, BN, Sq, d, tid);
    if (tid < BN) {
      const bool in = q0 + tid < Sq;
      cp_async4(lse_s + st * BN + tid, in ? lb + q0 + tid : lb, in);
      cp_async4(D_s + st * BN + tid, in ? db + q0 + tid : db, in);
    }
  };
  if (first < n_tiles) load_q(first);
  cp_async_commit();

  // warp roles: key rows m0..m0+15 of the block with its partner warp ^ 4;
  // head-dim columns c0..c0+HD-1 for its halves of S^T and dP^T and for dK
  // and dV
  const int slice = warp & 3, m0 = slice * 16, c0 = (warp >> 2) * HD;
  float* mine = xs + warp * XCH * 32;
  const float* theirs = xs + (warp ^ 4) * XCH * 32;
  const float scale2 = scale * LOG2E;
  // uniform over the pair: false when its key rows all lie past Sk
  const bool keys_live = k0 + m0 < Sk;
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = first; t < n_tiles; ++t) {
    cp_async_wait<0>();                    // K, V and tile t have landed
    __syncthreads();
    if (t + 1 < n_tiles) load_q(t + 1);    // overlaps this tile
    cp_async_commit();
    const int q0 = t * BN, st = (t - first) & 1;
    const float* Qt = Qs + st * BN * LD;
    const float* dOt = dOs + st * BN * LD;
    const float* lt = lse_s + st * BN;
    const float* Dt = D_s + st * BN;
    // skip, uniform over the pair, when its key rows all lie past Sk or
    // (causal) after every query of the tile: P and dS are 0 there
    if (!keys_live || (causal && k0 + m0 > q0 + BN - 1)) continue;
    float s[2][4], dp[2][4], ds[2][4];
    product_abt<HD / 8>(Ks, Qt, LD, m0, c0, lane, s);     // S^T
    product_abt<HD / 8>(Vs, dOt, LD, m0, c0, lane, dp);   // dP^T
    pair_sum(s, dp, mine, theirs, slice, lane);
    // P^T = valid ? exp(S^T scale - lse) : 0 (never exp then mask) into s,
    // and dS^T = P^T (dP^T - D) scale: element e of s[j] is key row
    // m0 + group + 8 (e / 2), query column j 8 + 2 tig + e % 2
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = m0 + group + 8 * (e >> 1);
        const int ql = j * 8 + 2 * tig + (e & 1), qi = q0 + ql;
        const bool ok = valid_s[kl] != 0 && qi < Sq &&
                        (!causal || k0 + kl <= qi);
        const float p =
            ok ? exp2f(s[j][e] * scale2 - lt[ql] * LOG2E) : 0.f;
        ds[j][e] = ok ? p * (dp[j][e] - Dt[ql]) * scale : 0.f;
        s[j][e] = p;
      }
    }
    // dV += P^T dO and dK += dS^T Q for head-dim columns c0..c0+HD-1
    product_acc<NT>(dv_acc, s, dOt, LD, c0, tig, group);
    product_acc<NT>(dk_acc, ds, Qt, LD, c0, tig, group);
  }
  cp_async_wait<0>();  // nothing left in flight (no query tile at all)

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + m0 + group + 8 * hf;
    if (kr >= Sk) continue;
    float* gk = dk + (bh * Sk + kr) * d;
    float* gv = dv + (bh * Sk + kr) * d;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int c = c0 + n * 8 + 2 * tig;
      if (c >= d) continue;
      *reinterpret_cast<float2*>(gk + c) =
          make_float2(dk_acc[n][2 * hf], dk_acc[n][2 * hf + 1]);
      *reinterpret_cast<float2*>(gv + c) =
          make_float2(dv_acc[n][2 * hf], dv_acc[n][2 * hf + 1]);
    }
  }
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* key_mask, const void* dout, const void* lse,
                      const void* drow, void* dq, int B, int H, int Sq, int Sk,
                      int d, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>(2 * BN * sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_tf32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BM - 1) / BM, H, B);
  flash_attn_bwd_dq_tf32_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<float*>(dq), H, Sq, Sk, d,
      causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* key_mask, const void* dout,
                       const void* lse, const void* drow, void* dk, void* dv,
                       int B, int H, int Sq, int Sk, int d, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem =
      smem_bytes<DP>(4 * BN * sizeof(float) + BM * sizeof(int32_t));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_tf32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BM - 1) / BM, H, B);
  flash_attn_bwd_dkv_tf32_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<float*>(dk),
      static_cast<float*>(dv), H, Sq, Sk, d, causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16: TMA tiles, a producer warp and two consumer warpgroups on wgmma
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using mma_bf16::cp_async4;
typedef __nv_bfloat16 bf16;

constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = 384;         // and the producer warpgroup
constexpr float LOG2E = 1.44269504088896341f;
// named barriers of the P (dQ) and P^T (dK/dV) hand-over (0 is
// __syncthreads)
constexpr int P_READY = 1, P_FREE = 2;

// a 64 x DP accumulator of bf16 gradients to rows row(hf) (< S) of `out`
// (row stride d), columns < d
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2],
                                           bf16* out, const int (&row)[2],
                                           int S, int d, int tig) {
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= S) continue;
    bf16* o = out + (size_t)row[hf] * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (c < d)
        *reinterpret_cast<uint32_t*>(o + c) =
            pack_bf16(acc[4 * j + 2 * hf], acc[4 * j + 2 * hf + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

template <int DP> struct Dkv {
  static constexpr int BK = 64;          // key rows a block
  static constexpr int BQ = 64;          // query rows a tile
  static constexpr int STAGES = DP == 256 ? 2 : 3;
  static constexpr uint32_t KV_TILE = BK * DP * 2;
  static constexpr uint32_t Q_TILE = BQ * DP * 2;
  // byte offsets from the 1024-aligned base: K, V, then STAGES of Q, of
  // dO, of lse and of D, the P^T hand-over (128 threads x BQ / 2 floats),
  // the barriers kv_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t K_OFF = 0, V_OFF = KV_TILE;
  static constexpr uint32_t Q_OFF = 2 * KV_TILE;
  static constexpr uint32_t DO_OFF = Q_OFF + STAGES * Q_TILE;
  static constexpr uint32_t LSE_OFF = DO_OFF + STAGES * Q_TILE;
  static constexpr uint32_t D_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr uint32_t XCH_OFF = D_OFF + STAGES * BQ * 4;
  static constexpr uint32_t BAR_OFF = XCH_OFF + 128 * (BQ / 2) * 4;
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "dK/dV: shared memory");
};

// Block (x, y, z): key rows [64 x, 64 x + 64) of head y, batch z; query
// tiles of BQ rows in order. Warpgroup 0 computes S^T = K Q^T and P^T and
// holds dV; warpgroup 1 computes dP^T = V dO^T and dS^T and holds dK;
// warp 8 (the first of warpgroup 2) loads the tiles
template <int DP>
__global__ void __launch_bounds__(THREADS, Occupancy<DP>::BLOCKS)
flash_attn_bwd_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const int32_t* __restrict__ key_mask,
                               const float* __restrict__ lse,
                               const float* __restrict__ drow,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int H, int Sq, int Sk, int d, int causal,
                               float scale) {
  using C = Dkv<DP>;
  using T = HeadDim<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t kv_full = base + C::BAR_OFF;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * C::STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + C::LSE_OFF);
  float* d_s = reinterpret_cast<float*>(smem + C::D_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = blockIdx.x * C::BK, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  const int n_tiles = (Sq + C::BQ - 1) / C::BQ;
  // causal: query tile t ends at row t BQ + BQ - 1, before k0 for
  // t < k0 / BQ; with Sq < Sk a block may see no tile at all
  const int first = causal ? min(k0 / C::BQ, n_tiles) : 0;
  const int count = n_tiles - first;

  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    // the producer warp: K and V once, then each query tile's Q and dO (by
    // TMA) and its lse and D (by cp.async, 0 past Sq) into the ring as
    // soon as the tile's stage is free; the full barrier waits for both
    setmaxnreg_dec<Occupancy<DP>::PRODUCER_REGS>();
    if (warp_of(tid) == 8 && count > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(kv_full, 2 * C::KV_TILE);
        for (int r = 0; r < T::REGIONS; ++r) {
          tma_load_3d(base + C::K_OFF + r * C::BK * T::SW, &tm_k, kv_full,
                      r * T::COLS, k0, bh);
          tma_load_3d(base + C::V_OFF + r * C::BK * T::SW, &tm_v, kv_full,
                      r * T::COLS, k0, bh);
        }
      }
      const float* lse_g = lse + (size_t)bh * Sq;
      const float* d_g = drow + (size_t)bh * Sq;
      for (int i = 0; i < count; ++i) {
        const int st = i % C::STAGES, q0 = (first + i) * C::BQ;
        const uint32_t full = full0 + 8 * st;
        if (i >= C::STAGES)
          mbar_wait(empty0 + 8 * st, (i / C::STAGES - 1) & 1);
        for (int r = lane; r < C::BQ; r += 32) {
          const bool in = q0 + r < Sq;
          cp_async4(lse_s + st * C::BQ + r, in ? lse_g + q0 + r : lse_g, in);
          cp_async4(d_s + st * C::BQ + r, in ? d_g + q0 + r : d_g, in);
        }
        cp_async_mbar_arrive(full);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * C::Q_TILE);
          for (int r = 0; r < T::REGIONS; ++r) {
            const uint32_t off = st * C::Q_TILE + r * C::BQ * T::SW;
            tma_load_3d(base + C::Q_OFF + off, &tm_q, full, r * T::COLS, q0,
                        bh);
            tma_load_3d(base + C::DO_OFF + off, &tm_do, full, r * T::COLS,
                        q0, bh);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<Occupancy<DP>::CONSUMER_REGS>();
    const int t = tid & 127, warp = t >> 5;
    const int tig = lane & 3;
    // the thread's two key rows (those of its accumulator fragments)
    int kr[2];
    bool key_ok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      kr[hf] = k0 + 16 * warp + (lane >> 2) + 8 * hf;
      key_ok[hf] = kr[hf] < Sk && key_mask[(size_t)b * Sk + kr[hf]] != 0;
    }
    const float scale2 = scale * LOG2E;
    float* xch = reinterpret_cast<float*>(smem + C::XCH_OFF);
    // K and V (warpgroup 0: S^T's A operand K, dV's B dO; 1: V and Q)
    const uint32_t a_tile = base + (wgi == 0 ? C::K_OFF : C::V_OFF);
    float acc[DP / 2];                   // dV (warpgroup 0) or dK (1)
    float s[C::BQ / 2];                  // S^T (0) or dP^T (1)
    uint32_t a[C::BQ / 16][4];           // P^T (0) or dS^T (1) in bf16
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BQ / 2; ++i) s[i] = 0.f;
    if (count > 0) mbar_wait(kv_full, 0);

    // each tile's gradient product runs on while the next tile's S^T or
    // dP^T is issued; the tile's stage is released once it has finished
    int prev = -1;                       // the stage of the product in flight
    for (int i = 0; i < count; ++i) {
      const int st = i % C::STAGES, q0 = (first + i) * C::BQ;
      const uint32_t q_tile = base + C::Q_OFF + st * C::Q_TILE;
      const uint32_t do_tile = base + C::DO_OFF + st * C::Q_TILE;
      mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (1): 64 keys x BQ
      // queries over the head dim; A = K or V, B = Q or dO, both K-major
      const uint32_t b_tile = wgi == 0 ? q_tile : do_tile;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Wgmma<C::BQ>::template ss<0>(
            s, T::kmajor(a_tile, C::BK, 0, kk),
            T::kmajor(b_tile, C::BQ, 0, kk), kk > 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();                 // the previous tile's dV or dK
        keep_live(a);
        mbar_arrive(empty0 + 8 * prev);
      }
      wgmma_wait<0>();
      fence_operands(s);

      const float* rows = (wgi == 0 ? lse_s : d_s) + st * C::BQ;
      if (wgi == 0) {
        // P^T = valid ? exp(S^T scale - lse) : 0 (never exp then mask), as
        // 2^(S^T scale log2(e) - lse log2(e)): element 4 j + e is key row
        // kr[e / 2], query column 8 j + 2 tig + e % 2
#pragma unroll
        for (int j = 0; j < C::BQ / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * j + 2 * tig + (e & 1), qi = q0 + ql;
            const bool ok = key_ok[e >> 1] && qi < Sq &&
                            (!causal || kr[e >> 1] <= qi);
            s[4 * j + e] =
                ok ? exp2f(s[4 * j + e] * scale2 - rows[ql] * LOG2E) : 0.f;
          }
        }
        // hand P^T (fp32) to warpgroup 1, whose thread t holds dP^T at the
        // same places, once it has read the previous tile's
        if (i > 0) bar_sync(P_FREE, CONSUMERS);
#pragma unroll
        for (int e = 0; e < C::BQ / 2; ++e) xch[e * 128 + t] = s[e];
        bar_arrive(P_READY, CONSUMERS);
      } else {
        bar_sync(P_READY, CONSUMERS);
        // dS^T = P^T (dP^T - D) scale; P^T is 0 wherever it is masked
#pragma unroll
        for (int e = 0; e < C::BQ / 2; ++e) {
          const int ql = 8 * (e >> 2) + 2 * tig + (e & 1);
          s[e] = xch[e * 128 + t] * (s[e] - rows[ql]) * scale;
        }
        if (i + 1 < count) bar_arrive(P_FREE, CONSUMERS);
      }
      // P^T and dS^T rounded to bf16 (the Pallas cast points) as the
      // register A operand of dV += P^T dO and dK += dS^T Q: 64 keys x DP
      // over the tile's BQ queries, B = dO or Q read MN-major
      to_a_fragments<C::BQ>(s, a);
      const uint32_t g_tile = wgi == 0 ? do_tile : q_tile;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C::BQ / 16; ++kk)
        Wgmma<DP>::template rs<1>(acc, a[kk], T::mnmajor(g_tile, C::BQ, kk),
                                  1);
      wgmma_commit();
      prev = st;
    }
    wgmma_wait<0>();                     // (nothing in flight: no wait)
    keep_live(a);
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
    fence_operands(acc);
    store_rows<DP>(acc, (wgi == 0 ? dv : dk) + (size_t)bh * Sk * d, kr, Sk, d,
                   tig);
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int DP> struct Dq {
  static constexpr int BQ = 64;          // query rows a block
  static constexpr int BK = 64;          // key rows a tile
  static constexpr int STAGES = DP == 256 ? 2 : 4;
  static constexpr uint32_t Q_TILE = BQ * DP * 2;
  static constexpr uint32_t KV_TILE = BK * DP * 2;
  // byte offsets from the 1024-aligned base: Q, dO, then STAGES of K, of V
  // and of the key mask, the P hand-over (128 threads x BK / 2 floats), the
  // barriers qdo_full, full[STAGES], empty[STAGES]
  static constexpr uint32_t Q_OFF = 0, DO_OFF = Q_TILE;
  static constexpr uint32_t K_OFF = 2 * Q_TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr uint32_t MASK_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr uint32_t XCH_OFF = MASK_OFF + STAGES * BK * 4;
  static constexpr uint32_t BAR_OFF = XCH_OFF + 128 * (BK / 2) * 4;
  static constexpr size_t SMEM = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "dQ: shared memory");
};

// Block (x, y, z): query rows [64 x, 64 x + 64) of head y, batch z; key
// tiles of BK rows in order. Warpgroup 0 computes S = Q K^T and P;
// warpgroup 1 computes dP = dO V^T and dS and holds dQ; warp 8 (the first
// of warpgroup 2) loads the tiles
template <int DP>
__global__ void __launch_bounds__(THREADS, Occupancy<DP>::BLOCKS)
flash_attn_bwd_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const int32_t* __restrict__ key_mask,
                              const float* __restrict__ lse,
                              const float* __restrict__ drow,
                              bf16* __restrict__ dq, int H, int Sq, int Sk,
                              int d, int causal, float scale) {
  using C = Dq<DP>;
  using T = HeadDim<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t qdo_full = base + C::BAR_OFF;
  const uint32_t full0 = qdo_full + 8, empty0 = full0 + 8 * C::STAGES;
  int32_t* mask_s = reinterpret_cast<int32_t*>(smem + C::MASK_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * C::BQ, h = blockIdx.y, b = blockIdx.z;
  const int bh = b * H + h;
  int n_tiles = (Sk + C::BK - 1) / C::BK;
  // causal: the block's last valid row sees keys up to itself
  if (causal) n_tiles = min(n_tiles, (min(q0 + C::BQ, Sq) - 1) / C::BK + 1);

  if (tid == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    // the producer warp: Q and dO once, then each key tile's K and V (by
    // TMA) and its key validity (by cp.async, 0 past Sk)
    setmaxnreg_dec<Occupancy<DP>::PRODUCER_REGS>();
    if (warp_of(tid) == 8) {
      if (lane == 0) {
        mbar_arrive_expect_tx(qdo_full, 2 * C::Q_TILE);
        for (int r = 0; r < T::REGIONS; ++r) {
          tma_load_3d(base + C::Q_OFF + r * C::BQ * T::SW, &tm_q, qdo_full,
                      r * T::COLS, q0, bh);
          tma_load_3d(base + C::DO_OFF + r * C::BQ * T::SW, &tm_do,
                      qdo_full, r * T::COLS, q0, bh);
        }
      }
      const int32_t* mask_g = key_mask + (size_t)b * Sk;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES, k0 = i * C::BK;
        const uint32_t full = full0 + 8 * st;
        if (i >= C::STAGES)
          mbar_wait(empty0 + 8 * st, (i / C::STAGES - 1) & 1);
        for (int r = lane; r < C::BK; r += 32) {
          const bool in = k0 + r < Sk;
          cp_async4(mask_s + st * C::BK + r, in ? mask_g + k0 + r : mask_g,
                    in);
        }
        cp_async_mbar_arrive(full);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * C::KV_TILE);
          for (int r = 0; r < T::REGIONS; ++r) {
            const uint32_t off = st * C::KV_TILE + r * C::BK * T::SW;
            tma_load_3d(base + C::K_OFF + off, &tm_k, full, r * T::COLS, k0,
                        bh);
            tma_load_3d(base + C::V_OFF + off, &tm_v, full, r * T::COLS, k0,
                        bh);
          }
        }
      }
    }
  } else {
    setmaxnreg_inc<Occupancy<DP>::CONSUMER_REGS>();
    const int t = tid & 127, warp = t >> 5;
    const int tig = lane & 3;
    // the thread's two query rows (those of its accumulator fragments) and
    // their lse in base-2 units (warpgroup 0) or D (1); rows past Sq read
    // nothing and are masked
    int row[2];
    float row_in[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      row[hf] = q0 + 16 * warp + (lane >> 2) + 8 * hf;
      const size_t at = (size_t)bh * Sq + row[hf];
      row_in[hf] = row[hf] >= Sq ? 0.f
                   : wgi == 0    ? lse[at] * LOG2E
                                 : drow[at];
    }
    const float scale2 = scale * LOG2E;
    float* xch = reinterpret_cast<float*>(smem + C::XCH_OFF);
    // Q (warpgroup 0: S's A operand) or dO (1: dP's)
    const uint32_t a_tile = base + (wgi == 0 ? C::Q_OFF : C::DO_OFF);
    float acc[DP / 2];                   // dQ (warpgroup 1)
    float s[C::BK / 2];                  // S (0) or dP (1)
    uint32_t a[C::BK / 16][4];           // dS in bf16 (1)
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < C::BK / 2; ++i) s[i] = 0.f;
    mbar_wait(qdo_full, 0);

    // warpgroup 1's dQ product of a tile runs on while the next tile's dP
    // is issued; the tile's stage is released once it has finished
    int prev = -1;                       // the stage of the product in flight
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % C::STAGES, k0 = i * C::BK;
      const uint32_t k_tile = base + C::K_OFF + st * C::KV_TILE;
      const uint32_t v_tile = base + C::V_OFF + st * C::KV_TILE;
      mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);

      // S = Q K^T (warpgroup 0) or dP = dO V^T (1): 64 rows x BK keys
      // over the head dim; A = Q or dO, B = K or V, all K-major
      const uint32_t b_tile = wgi == 0 ? k_tile : v_tile;
      fence_operands(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        Wgmma<C::BK>::template ss<0>(
            s, T::kmajor(a_tile, C::BQ, 0, kk),
            T::kmajor(b_tile, C::BK, 0, kk), kk > 0);
      wgmma_commit();
      if (prev >= 0) {
        wgmma_wait<1>();                 // the previous tile's dQ product
        keep_live(a);
        mbar_arrive(empty0 + 8 * prev);
      }
      wgmma_wait<0>();
      fence_operands(s);

      if (wgi == 0) {
        // P = valid ? exp(S scale - lse) : 0 (never exp then mask), as
        // 2^(S scale log2(e) - lse log2(e)): element 4 j + e is query row
        // row[e / 2], key column 8 j + 2 tig + e % 2
        const int32_t* valid = mask_s + st * C::BK;
#pragma unroll
        for (int j = 0; j < C::BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 8 * j + 2 * tig + (e & 1), hf = e >> 1;
            const bool ok = valid[kl] != 0 && row[hf] < Sq &&
                            (!causal || k0 + kl <= row[hf]);
            s[4 * j + e] =
                ok ? exp2f(s[4 * j + e] * scale2 - row_in[hf]) : 0.f;
          }
        }
        // hand P (fp32) to warpgroup 1, whose thread t holds dP at the
        // same places, once it has read the previous tile's; K, V and the
        // mask of this stage are then no longer read here
        if (i > 0) bar_sync(P_FREE, CONSUMERS);
#pragma unroll
        for (int e = 0; e < C::BK / 2; ++e) xch[e * 128 + t] = s[e];
        bar_arrive(P_READY, CONSUMERS);
        mbar_arrive(empty0 + 8 * st);
      } else {
        bar_sync(P_READY, CONSUMERS);
        // dS = P (dP - D) scale; P is 0 wherever it is masked
#pragma unroll
        for (int e = 0; e < C::BK / 2; ++e)
          s[e] = xch[e * 128 + t] * (s[e] - row_in[e >> 1 & 1]) * scale;
        if (i + 1 < n_tiles) bar_arrive(P_FREE, CONSUMERS);
        // dQ += dS K: dS rounded to bf16 (the Pallas cast point) as the
        // register A operand, K read MN-major (rows = keys = the
        // product's k)
        to_a_fragments<C::BK>(s, a);
        fence_operands(acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BK / 16; ++kk)
          Wgmma<DP>::template rs<1>(acc, a[kk],
                                    T::mnmajor(k_tile, C::BK, kk), 1);
        wgmma_commit();
        prev = st;
      }
    }
    wgmma_wait<0>();                     // (nothing in flight: no wait)
    keep_live(a);
    if (prev >= 0) mbar_arrive(empty0 + 8 * prev);
    fence_operands(acc);
    if (wgi == 1) store_rows<DP>(acc, dq + (size_t)bh * Sq * d, row, Sq, d,
                                 tig);
  }
}

// ---------------------------------------------------------------------------
// launches: the tensor maps are encoded on the host at each launch
// (sm90.cuh, tile_map)
// ---------------------------------------------------------------------------

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* key_mask, const void* dout,
                       const void* lse, const void* drow, void* dk, void* dv,
                       int B, int H, int Sq, int Sk, int d, int causal,
                       cudaStream_t stream) {
  using C = Dkv<DP>;
  CUtensorMap tq, tk, tv, tdo;
  // maps baked into a CUDA graph that captures this launch (sm90.cuh)
  if (!tile_map<DP>(&tq, q, d, Sq, B * H, C::BQ) ||
      !tile_map<DP>(&tdo, dout, d, Sq, B * H, C::BQ) ||
      !tile_map<DP>(&tk, k, d, Sk, B * H, C::BK) ||
      !tile_map<DP>(&tv, v, d, Sk, B * H, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_sm90_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + C::BK - 1) / C::BK, H, B);
  flash_attn_bwd_dkv_sm90_kernel<DP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Sq, Sk, d, causal,
      1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* key_mask, const void* dout, const void* lse,
                      const void* drow, void* dq, int B, int H, int Sq, int Sk,
                      int d, int causal, cudaStream_t stream) {
  using C = Dq<DP>;
  CUtensorMap tq, tk, tv, tdo;
  // maps baked into a CUDA graph that captures this launch (sm90.cuh)
  if (!tile_map<DP>(&tq, q, d, Sq, B * H, C::BQ) ||
      !tile_map<DP>(&tdo, dout, d, Sq, B * H, C::BQ) ||
      !tile_map<DP>(&tk, k, d, Sk, B * H, C::BK) ||
      !tile_map<DP>(&tv, v, d, Sk, B * H, C::BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_sm90_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + C::BQ - 1) / C::BQ, H, B);
  flash_attn_bwd_dq_sm90_kernel<DP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<bf16*>(dq), H, Sq, Sk, d,
      causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace wg

bool bad_shape(int B, int H, int Sq, int Sk, int d) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || d <= 0 || d > MAX_D ||
         d % 8 != 0 || B > 65535 || H > 65535;
}

}  // namespace

// q, dout, dq: (B, H, Sq, d); k, v, dk, dv: (B, H, Sk, d); all contiguous,
// 16-byte aligned and of one dtype (is_bf16 ? bfloat16 : float32). key_mask:
// (B, Sk) int32, nonzero = attend. lse, drow: (B, H, Sq) float32 (the
// forward's row log-sum-exp and rowsum(dout * out) with NaN -> 0). The dtype
// picks the kernel, both on tensor cores: 3xTF32 for fp32 (the head dim
// padded to 64 or 256), wgmma for bf16 (padded to 32, 64 or 256; its tensor
// maps are encoded here, and one that does not encode returns
// cudaErrorInvalidValue). Each launches on `stream`, allocates nothing,
// does not synchronise, and returns the cudaError_t of the launch
// (0 = success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* lse, const void* drow, void* dq,
                                 int B, int H, int Sq, int Sk, int d,
                                 int causal, int is_bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (d <= 64)
      return (int)tf32::launch_dq<64>(q, k, v, key_mask, dout, lse, drow, dq,
                                      B, H, Sq, Sk, d, causal, s);
    return (int)tf32::launch_dq<256>(q, k, v, key_mask, dout, lse, drow, dq,
                                     B, H, Sq, Sk, d, causal, s);
  }
  if (d <= 32)
    return (int)wg::launch_dq<32>(q, k, v, key_mask, dout, lse, drow, dq, B,
                                  H, Sq, Sk, d, causal, s);
  if (d <= 64)
    return (int)wg::launch_dq<64>(q, k, v, key_mask, dout, lse, drow, dq, B,
                                  H, Sq, Sk, d, causal, s);
  return (int)wg::launch_dq<256>(q, k, v, key_mask, dout, lse, drow, dq, B, H,
                                 Sq, Sk, d, causal, s);
}

extern "C" int flash_attn_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* key_mask, const void* dout,
                                  const void* lse, const void* drow, void* dk,
                                  void* dv, int B, int H, int Sq, int Sk,
                                  int d, int causal, int is_bf16,
                                  void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (d <= 64)
      return (int)tf32::launch_dkv<64>(q, k, v, key_mask, dout, lse, drow, dk,
                                       dv, B, H, Sq, Sk, d, causal, s);
    return (int)tf32::launch_dkv<256>(q, k, v, key_mask, dout, lse, drow, dk,
                                      dv, B, H, Sq, Sk, d, causal, s);
  }
  if (d <= 32)
    return (int)wg::launch_dkv<32>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                   B, H, Sq, Sk, d, causal, s);
  if (d <= 64)
    return (int)wg::launch_dkv<64>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                   B, H, Sq, Sk, d, causal, s);
  return (int)wg::launch_dkv<256>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                  B, H, Sq, Sk, d, causal, s);
}
