// Masked attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV, in a tensor-core version for each dtype.
//
// Replaces the two Pallas backward kernels of bmt_tpu/ops/pallas_attention.py,
// both launched by `_flash_attention_tiled_bwd`:
//   tf32::flash_attn_bwd_dq_tf32_kernel (fp32),
//   tc::flash_attn_bwd_dq_bf16_kernel (bf16)
//       <- `_dq_kernel`  (:351-389, pallas_call :473)
//   tf32::flash_attn_bwd_dkv_tf32_kernel (fp32),
//   tc::flash_attn_bwd_dkv_bf16_kernel (bf16)
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
// Both run every product on tensor cores by mma.sync: 3xTF32 m16n8k8 for
// float32 (below), bf16 m16n8k16 for bfloat16 (further below); the head dim
// is padded to DP = 64 or 256 (a template parameter; the padded columns load
// as 0 and are not stored), so d need only be a multiple of 8. Ragged edges:
// key rows >= Sk load as 0 and are masked, query rows >= Sq load as 0 and
// get P = 0 (not relying on dO = 0 there), and gradient rows past Sq or Sk
// are not stored. Tiles arrive by 16-byte cp.async copies in a ring of two
// stages, so tile t + 1 loads while tile t computes.
//
// fp32 (the fp32 train steps: make_cap_train_step's and
// make_prop_train_step's default compute dtype, and the parity checks):
// tensor cores in TF32, three products per product (csrc/mma_tf32.cuh), so
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
// bf16 (the bf16 train and serving paths): tensor cores in bf16, with
// mma.sync m16n8k16 (bf16 in, fp32 accumulators) for every product,
// fragments by ldmatrix from tiles with 16-byte row padding (no bank
// conflicts, mma_bf16.cuh). Their calls move 128-170 FLOP per byte at
// d = 256, under the H100's 295, so HBM bounds them (dQ 84.2 MB, 0.0251 ms;
// dK/dV 101.0 MB, 0.0301 ms at the train cell's B=32, S=256 call), but
// mma.sync feeds the tensor cores through registers, so shared-memory
// fragment traffic and issue slots are what they spend their time on.
// Measured in PERF.md.
// - dQ in bf16: a block owns DQ_BQ = 128 query rows and loops over key
//   tiles of DQ_BK = 32 rows, which arrive with their key validity by
//   cp.async into a ring of two stages; Q and dO are loaded once. Its 16
//   warps each own 16 query rows with a partner warp; per key tile a warp
//   computes S = Q K^T and dP = dO V^T for half of the tile's key columns,
//   writes dS (bf16, the Pallas cast point) to a 128 x 32 shared tile, and
//   after a barrier dQ += dS K for half of the head dim, with dS read by
//   ldmatrix and K by ldmatrix .trans (K as stored: rows = keys = the
//   product's k). The 128 x DP fp32 accumulator is spread at DP / 4 a
//   thread (64 at DP = 256). ptxas -v: 128 registers at DP = 256 (98 at
//   64), no spills; 213,248 bytes of dynamic shared memory (Q, dO, two
//   stages of K and V, dS), one block of 16 warps per SM. The 16 warps hide
//   more of the ldmatrix -> mma latency, which is what the mma.sync kernels
//   here wait on, than 8 warps over 64 x 64 tiles (178 registers) did:
//   PERF.md.
// - dK/dV in bf16, the same roles with keys and queries swapped: a block
//   owns BK = 64 key rows and loops over query tiles of BQ = 64 rows, which
//   arrive with their lse and D in a two-stage cp.async ring (K and V are
//   loaded once); its 8 warps each own 16 key rows and compute
//   S^T = K Q^T and dP^T = V dO^T for half of the tile's query columns,
//   write P^T and dS^T (bf16) to shared memory, and then dV += P^T dO and
//   dK += dS^T Q for half of the head dim (dO and Q by ldmatrix .trans), so
//   the 2 x 64 x DP fp32 accumulators are spread at DP / 2 a thread (128 at
//   DP = 256). ptxas -v: 240 registers at DP = 256 (150 at 64), no spills;
//   222,464 bytes of dynamic shared memory (K, V, two stages of Q and dO,
//   P^T, dS^T), one block per SM.
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
// dK/dV in bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators),
// cp.async tiles
// ---------------------------------------------------------------------------

namespace tc {

using namespace mma_bf16;

constexpr int BK = 64;               // key rows per block
constexpr int BQ = 64;               // query rows per tile
constexpr int THREADS = 256;         // 8 warps: 4 key-row groups x 2 halves
constexpr int LP = pad_row(BQ);      // row stride of the P^T and dS^T tiles
constexpr float LOG2E = 1.44269504088896341f;
// dQ: query rows per block, key rows per tile, and two warps for every 16
// query rows (each takes half of the key tile and half of the head dim);
// the fastest of the tile shapes measured (PERF.md)
constexpr int DQ_BQ = 128;
constexpr int DQ_BK = 32;
constexpr int DQ_THREADS = DQ_BQ / 16 * 2 * 32;
constexpr int LS = pad_row(DQ_BK);   // row stride of dQ's dS tile

// K and V tiles, two stages of Q and dO tiles (head dim padded to DP), the
// P^T and dS^T tiles, two stages of the query tile's lse and D, and the
// block's key validity
template <int DP> constexpr size_t dkv_smem_bytes() {
  return (size_t)(2 * BK + 4 * BQ) * pad_row(DP) * sizeof(bf16) +
         2 * BK * LP * sizeof(bf16) + (4 * BQ + BK) * sizeof(float);
}

// DP: the head dim the tiles are padded to (a multiple of 64, >= d); the
// padded columns load as 0 and are not stored
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                               const bf16* __restrict__ k,
                               const bf16* __restrict__ v,
                               const int32_t* __restrict__ key_mask,
                               const bf16* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ drow,
                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                               int H, int Sq, int Sk, int d, int causal,
                               float scale) {
  constexpr int LD = pad_row(DP);
  constexpr int NH = DP / 16;        // 8-wide column tiles in half of DP
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);   // BK x LD
  bf16* Vs = Ks + BK * LD;                        // BK x LD
  bf16* Qs = Vs + BK * LD;                        // 2 x BQ x LD
  bf16* dOs = Qs + 2 * BQ * LD;                   // 2 x BQ x LD
  bf16* Ps = dOs + 2 * BQ * LD;                   // BK x LP: P^T
  bf16* dSs = Ps + BK * LP;                       // BK x LP: dS^T
  float* lse_s = reinterpret_cast<float*>(dSs + BK * LP);   // 2 x BQ
  float* D_s = lse_s + 2 * BQ;                              // 2 x BQ
  int32_t* valid_s = reinterpret_cast<int32_t*>(D_s + 2 * BQ);  // BK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* qb = q + bh * Sq * d;
  const bf16* ob = dout + bh * Sq * d;
  const float* lb = lse + bh * Sq;
  const float* db = drow + bh * Sq;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  load_rows_async<DP, THREADS>(Ks, k + bh * Sk * d, k0, BK, Sk, d, tid);
  load_rows_async<DP, THREADS>(Vs, v + bh * Sk * d, k0, BK, Sk, d, tid);
  if (tid < BK) {
    const bool in = k0 + tid < Sk;
    cp_async4(valid_s + tid, in ? mb + k0 + tid : mb, in);   // 0 past Sk
  }
  // query tile t into stage st: Q, dO rows (0 past Sq), lse and D
  auto load_q = [&](int t, int st) {
    const int q0 = t * BQ;
    load_rows_async<DP, THREADS>(Qs + st * BQ * LD, qb, q0, BQ, Sq, d, tid);
    load_rows_async<DP, THREADS>(dOs + st * BQ * LD, ob, q0, BQ, Sq, d, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      cp_async4(lse_s + st * BQ + tid, in ? lb + q0 + tid : lb, in);
      cp_async4(D_s + st * BQ + tid, in ? db + q0 + tid : db, in);
    }
  };
  const int n_tiles = (Sq + BQ - 1) / BQ;
  // causal: tile t ends at row t BQ + BQ - 1, before k0 for t < k0 / BQ
  const int first = causal ? k0 / BQ : 0;
  if (first < n_tiles) load_q(first, 0);
  cp_async_commit();

  // warp roles: key rows km..km+15 of the block throughout; query columns
  // qn..qn+31 of the tile for S^T and dP^T; head-dim columns dn..dn+DP/2-1
  // for dK and dV (each thread holds 2 x NH x 4 = DP/2 fp32 accumulators)
  const int km = (warp & 3) * 16;
  const int qn = (warp >> 2) * 32;
  const int dn = (warp >> 2) * (DP / 2);
  const float scale2 = scale * LOG2E;
  float dk_acc[NH][4], dv_acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  for (int t = first; t < n_tiles; ++t) {
    const int st = (t - first) & 1;
    if (t + 1 < n_tiles) load_q(t + 1, st ^ 1);   // overlaps this tile
    cp_async_commit();
    cp_async_wait<1>();                           // K, V and tile t landed
    __syncthreads();
    const int q0 = t * BQ;
    const bf16* Qt = Qs + st * BQ * LD;
    const bf16* dOt = dOs + st * BQ * LD;
    const float* lt = lse_s + st * BQ;
    const float* Dt = D_s + st * BQ;

    // S^T = K Q^T and dP^T = V dO^T: 16 key rows x 32 query columns. Warp-
    // uniform skip when the columns all lie past Sq or (causal) every key
    // row lies after every query column; P and dS are then 0
    const bool live =
        q0 + qn < Sq && !(causal && k0 + km > q0 + qn + 31);
    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if (live) {
      // every fragment of step kk is loaded before its products, so only
      // the first mma of a step can wait on an ldmatrix (in-order issue)
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t ak[4], av[4], bq[2][4], bo[2][4];
        ldmatrix_x4(ak, frag_a(Ks, LD, km, kk, lane));
        ldmatrix_x4(av, frag_a(Vs, LD, km, kk, lane));
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ldmatrix_x4(bq[j], frag_b_nk(Qt, LD, qn + j * 16, kk, lane));
          ldmatrix_x4(bo[j], frag_b_nk(dOt, LD, qn + j * 16, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          mma(s[2 * j], ak, bq[j][0], bq[j][1]);
          mma(s[2 * j + 1], ak, bq[j][2], bq[j][3]);
          mma(dp[2 * j], av, bo[j][0], bo[j][1]);
          mma(dp[2 * j + 1], av, bo[j][2], bo[j][3]);
        }
      }
    }
    // P^T = valid ? exp(S^T scale - lse) : 0 (never exp then mask), as
    // 2^(S^T scale log2(e) - lse log2(e)) with one exp2f, and
    // dS^T = P^T (dP^T - D) scale, rounded to bf16 into shared memory:
    // element e of s[j] is key row km + group + 8 (e / 2), query column
    // qn + j 8 + 2 tig + e % 2
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int kl = km + group + 8 * hf;
        const int ql = qn + j * 8 + 2 * tig;
        float p[2], ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int qi = q0 + ql + u;
          const bool ok = live && valid_s[kl] != 0 && qi < Sq &&
                          (!causal || k0 + kl <= qi);
          p[u] = ok ? exp2f(s[j][2 * hf + u] * scale2 - lt[ql + u] * LOG2E)
                    : 0.f;
          ds[u] = ok ? p[u] * (dp[j][2 * hf + u] - Dt[ql + u]) * scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(Ps + kl * LP + ql) = pack(p[0], p[1]);
        *reinterpret_cast<uint32_t*>(dSs + kl * LP + ql) = pack(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q: 16 key rows x DP/2 columns; the dO
    // and Q fragments are loaded one column pair ahead of their products
    constexpr int NP = NH / 2;             // column-tile pairs
    uint32_t fo[2][4], fq[2][4];
    ldmatrix_x4_trans(fo[0], frag_b_kn(dOt, LD, dn, 0, lane));
    ldmatrix_x4_trans(fq[0], frag_b_kn(Qt, LD, dn, 0, lane));
#pragma unroll
    for (int kk = 0; kk < BQ; kk += 16) {
      uint32_t ap[4], as[4];
      ldmatrix_x4(ap, frag_a(Ps, LP, km, kk, lane));
      ldmatrix_x4(as, frag_a(dSs, LP, km, kk, lane));
#pragma unroll
      for (int np = 0; np < NP; ++np) {
        const int i = kk / 16 * NP + np, cur = i & 1;
        if (i + 1 < BQ / 16 * NP) {
          const int nc = dn + (i + 1) % NP * 16, nk = (i + 1) / NP * 16;
          ldmatrix_x4_trans(fo[cur ^ 1], frag_b_kn(dOt, LD, nc, nk, lane));
          ldmatrix_x4_trans(fq[cur ^ 1], frag_b_kn(Qt, LD, nc, nk, lane));
        }
        mma(dv_acc[2 * np], ap, fo[cur][0], fo[cur][1]);
        mma(dv_acc[2 * np + 1], ap, fo[cur][2], fo[cur][3]);
        mma(dk_acc[2 * np], as, fq[cur][0], fq[cur][1]);
        mma(dk_acc[2 * np + 1], as, fq[cur][2], fq[cur][3]);
      }
    }
    __syncthreads();   // every read of this stage is done before its refill
  }
  cp_async_wait<0>();  // nothing left in flight (no query tile at all)

#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int kr = k0 + km + group + 8 * hf;
    if (kr >= Sk) continue;
    bf16* gk = dk + (bh * Sk + kr) * d;
    bf16* gv = dv + (bh * Sk + kr) * d;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c = dn + n * 8 + 2 * tig;
      if (c >= d) continue;
      *reinterpret_cast<uint32_t*>(gk + c) =
          pack(dk_acc[n][2 * hf], dk_acc[n][2 * hf + 1]);
      *reinterpret_cast<uint32_t*>(gv + c) =
          pack(dv_acc[n][2 * hf], dv_acc[n][2 * hf + 1]);
    }
  }
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* key_mask, const void* dout,
                       const void* lse, const void* drow, void* dk, void* dv,
                       int B, int H, int Sq, int Sk, int d, int causal,
                       cudaStream_t stream) {
  constexpr size_t smem = dkv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, H, B);
  flash_attn_bwd_dkv_bf16_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), H, Sq, Sk, d, causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// dQ in bf16: tensor cores, the same building blocks
// ---------------------------------------------------------------------------

// Q and dO tiles (loaded once), two stages of K and V tiles and of their key
// validity, and the dS tile
template <int DP> constexpr size_t dq_smem_bytes() {
  return (size_t)(2 * DQ_BQ + 4 * DQ_BK) * pad_row(DP) * sizeof(bf16) +
         DQ_BQ * LS * sizeof(bf16) + 2 * DQ_BK * sizeof(int32_t);
}

// DP: the head dim the tiles are padded to (64 or 256, >= d); the padded
// columns load as 0 and are not stored
template <int DP>
__global__ void __launch_bounds__(DQ_THREADS, 1)
flash_attn_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const int32_t* __restrict__ key_mask,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ drow,
                              bf16* __restrict__ dq, int H, int Sq, int Sk,
                              int d, int causal, float scale) {
  constexpr int LD = pad_row(DP);
  constexpr int NH = DP / 16;        // 8-wide column tiles in half of DP
  constexpr int RG = DQ_BQ / 16;     // 16-row groups of the query tile
  constexpr int NJ = DQ_BK / 32;     // 16-key column pairs a warp takes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // DQ_BQ x LD
  bf16* dOs = Qs + DQ_BQ * LD;                    // DQ_BQ x LD
  bf16* Ks = dOs + DQ_BQ * LD;                    // 2 x DQ_BK x LD
  bf16* Vs = Ks + 2 * DQ_BK * LD;                 // 2 x DQ_BK x LD
  bf16* dSs = Vs + 2 * DQ_BK * LD;                // DQ_BQ x LS: dS
  int32_t* valid_s =
      reinterpret_cast<int32_t*>(dSs + DQ_BQ * LS);   // 2 x DQ_BK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * DQ_BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + bh * Sk * d;
  const bf16* vb = v + bh * Sk * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  int n_tiles = (Sk + DQ_BK - 1) / DQ_BK;
  // causal: the tile's last valid row sees keys up to itself
  if (causal) n_tiles = min(n_tiles, (min(q0 + DQ_BQ, Sq) - 1) / DQ_BK + 1);

  // key tile t into stage t & 1: K, V rows (0 past Sk) and key validity
  auto load_kv = [&](int t) {
    const int k0 = t * DQ_BK, st = t & 1;
    load_rows_async<DP, DQ_THREADS>(Ks + st * DQ_BK * LD, kb, k0, DQ_BK, Sk,
                                    d, tid);
    load_rows_async<DP, DQ_THREADS>(Vs + st * DQ_BK * LD, vb, k0, DQ_BK, Sk,
                                    d, tid);
    if (tid < DQ_BK) {
      const bool in = k0 + tid < Sk;
      cp_async4(valid_s + st * DQ_BK + tid, in ? mb + k0 + tid : mb, in);
    }
  };
  load_rows_async<DP, DQ_THREADS>(Qs, q + bh * Sq * d, q0, DQ_BQ, Sq, d, tid);
  load_rows_async<DP, DQ_THREADS>(dOs, dout + bh * Sq * d, q0, DQ_BQ, Sq, d,
                                  tid);
  load_kv(0);
  cp_async_commit();

  // warp roles: query rows mq..mq+15 of the tile throughout; key columns
  // kn..kn+DQ_BK/2-1 of each key tile for S and dP; head-dim columns
  // dn..dn+DP/2-1 for dQ (each thread holds NH x 4 = DP/4 fp32 accumulators)
  const int mq = warp % RG * 16;
  const int kn = warp / RG * (DQ_BK / 2);
  const int dn = warp / RG * (DP / 2);
  const float scale2 = scale * LOG2E;
  // this thread's two query rows (those of its C fragments), their lse in
  // base-2 units and their D; rows past Sq read nothing and are masked
  int row[2];
  float lse2[2], D[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = q0 + mq + group + 8 * hf;
    const bool in = row[hf] < Sq;
    lse2[hf] = in ? lse[bh * Sq + row[hf]] * LOG2E : -INFINITY;
    D[hf] = in ? drow[bh * Sq + row[hf]] : 0.f;
  }
  // warp-uniform: false when the warp's rows all lie past Sq (decoder
  // calls have Sq = 21 in a 128-row tile); such a warp skips its products
  // but takes part in every barrier
  const bool rows_live = q0 + mq < Sq;
  float acc[NH][4];
#pragma unroll
  for (int n = 0; n < NH; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  // two barriers a tile: after this one, tile t has landed and every warp
  // is done with tile t - 1, so its stage (which tile t + 1 takes) and the
  // dS tile are free
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();                    // Q, dO and tile t have landed
    __syncthreads();
    if (t + 1 < n_tiles) load_kv(t + 1);   // overlaps this tile
    cp_async_commit();
    const int k0 = t * DQ_BK;
    const bf16* Kt = Ks + (t & 1) * DQ_BK * LD;
    const bf16* Vt = Vs + (t & 1) * DQ_BK * LD;
    const int32_t* vt = valid_s + (t & 1) * DQ_BK;

    // S = Q K^T and dP = dO V^T: 16 query rows x DQ_BK/2 key columns. Warp-
    // uniform skip when the rows all lie past Sq or (causal) every key
    // column lies after every row; s and dp stay 0 and the mask below
    // gives P = dS = 0
    const bool live =
        rows_live && !(causal && k0 + kn > q0 + mq + 15);
    float s[2 * NJ][4], dp[2 * NJ][4];
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    if (live) {
      // every fragment of step kk is loaded before its products, so only
      // the first mma of a step can wait on an ldmatrix (in-order issue)
#pragma unroll
      for (int kk = 0; kk < DP; kk += 16) {
        uint32_t aq[4], ao[4], bk[NJ][4], bv[NJ][4];
        ldmatrix_x4(aq, frag_a(Qs, LD, mq, kk, lane));
        ldmatrix_x4(ao, frag_a(dOs, LD, mq, kk, lane));
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          ldmatrix_x4(bk[j], frag_b_nk(Kt, LD, kn + j * 16, kk, lane));
          ldmatrix_x4(bv[j], frag_b_nk(Vt, LD, kn + j * 16, kk, lane));
        }
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          mma(s[2 * j], aq, bk[j][0], bk[j][1]);
          mma(s[2 * j + 1], aq, bk[j][2], bk[j][3]);
          mma(dp[2 * j], ao, bv[j][0], bv[j][1]);
          mma(dp[2 * j + 1], ao, bv[j][2], bv[j][3]);
        }
      }
    }
    // P = valid ? exp(S scale - lse) : 0 (never exp then mask), as
    // 2^(S scale log2(e) - lse log2(e)) with one exp2f, and
    // dS = P (dP - D) scale, rounded to bf16 into shared memory (the Pallas
    // cast point): element e of s[j] is query row mq + group + 8 (e / 2),
    // key column kn + j 8 + 2 tig + e % 2
#pragma unroll
    for (int j = 0; j < 2 * NJ; ++j) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int ql = mq + group + 8 * hf;
        const int kl = kn + j * 8 + 2 * tig;
        float ds[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const bool ok = live && vt[kl + u] != 0 && row[hf] < Sq &&
                          (!causal || k0 + kl + u <= row[hf]);
          const float p =
              ok ? exp2f(s[j][2 * hf + u] * scale2 - lse2[hf]) : 0.f;
          ds[u] = ok ? p * (dp[j][2 * hf + u] - D[hf]) * scale : 0.f;
        }
        *reinterpret_cast<uint32_t*>(dSs + ql * LS + kl) = pack(ds[0], ds[1]);
      }
    }
    __syncthreads();

    // dQ += dS K: 16 query rows x DP/2 columns, K read as it is stored
    // (rows = keys, the product's k) by ldmatrix .trans; its fragments are
    // loaded one column pair ahead of their products. Warp-uniform skip
    // when (causal) every key of the tile lies after the warp's rows: their
    // dS is 0
    if (rows_live && !(causal && k0 > q0 + mq + 15)) {
      constexpr int NP = NH / 2;           // column-tile pairs
      uint32_t fk[2][4];
      ldmatrix_x4_trans(fk[0], frag_b_kn(Kt, LD, dn, 0, lane));
#pragma unroll
      for (int kk = 0; kk < DQ_BK; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, frag_a(dSs, LS, mq, kk, lane));
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          const int i = kk / 16 * NP + np, cur = i & 1;
          if (i + 1 < DQ_BK / 16 * NP) {
            const int nc = dn + (i + 1) % NP * 16, nk = (i + 1) / NP * 16;
            ldmatrix_x4_trans(fk[cur ^ 1], frag_b_kn(Kt, LD, nc, nk, lane));
          }
          mma(acc[2 * np], a, fk[cur][0], fk[cur][1]);
          mma(acc[2 * np + 1], a, fk[cur][2], fk[cur][3]);
        }
      }
    }
  }

  bf16* gq = dq + bh * Sq * d;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= Sq) continue;
#pragma unroll
    for (int n = 0; n < NH; ++n) {
      const int c = dn + n * 8 + 2 * tig;
      if (c >= d) continue;
      *reinterpret_cast<uint32_t*>(gq + (size_t)row[hf] * d + c) =
          pack(acc[n][2 * hf], acc[n][2 * hf + 1]);
    }
  }
}

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* key_mask, const void* dout, const void* lse,
                      const void* drow, void* dq, int B, int H, int Sq, int Sk,
                      int d, int causal, cudaStream_t stream) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + DQ_BQ - 1) / DQ_BQ, H, B);
  flash_attn_bwd_dq_bf16_kernel<DP><<<grid, DQ_THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<bf16*>(dq), H, Sq, Sk, d,
      causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace tc

bool bad_shape(int B, int H, int Sq, int Sk, int d) {
  return B <= 0 || H <= 0 || Sq <= 0 || Sk <= 0 || d <= 0 || d > MAX_D ||
         d % 8 != 0 || B > 65535 || H > 65535;
}

}  // namespace

// q, dout, dq: (B, H, Sq, d); k, v, dk, dv: (B, H, Sk, d); all contiguous,
// 16-byte aligned and of one dtype (is_bf16 ? bfloat16 : float32). key_mask:
// (B, Sk) int32, nonzero = attend. lse, drow: (B, H, Sq) float32 (the
// forward's row log-sum-exp and rowsum(dout * out) with NaN -> 0). The dtype
// picks the kernel, both on tensor cores with the head dim padded to 64 or
// 256: 3xTF32 for fp32, bf16 for bf16. Each launches on `stream`, allocates
// nothing, does not synchronise, and returns the cudaError_t of the launch
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
  if (d <= 64)
    return (int)tc::launch_dq<64>(q, k, v, key_mask, dout, lse, drow, dq, B,
                                  H, Sq, Sk, d, causal, s);
  return (int)tc::launch_dq<256>(q, k, v, key_mask, dout, lse, drow, dq, B, H,
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
  if (d <= 64)
    return (int)tc::launch_dkv<64>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                   B, H, Sq, Sk, d, causal, s);
  return (int)tc::launch_dkv<256>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                  B, H, Sq, Sk, d, causal, s);
}
