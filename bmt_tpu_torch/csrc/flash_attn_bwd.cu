// Masked attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV.
//
// Replaces the two Pallas backward kernels of bmt_tpu/ops/pallas_attention.py,
// both launched by `_flash_attention_tiled_bwd`:
//   flash_attn_bwd_dq_kernel (fp32), tc::flash_attn_bwd_dq_bf16_kernel
//       <- `_dq_kernel`  (:351-389, pallas_call :473)
//   flash_attn_bwd_dkv_kernel (fp32), tc::flash_attn_bwd_dkv_bf16_kernel
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
// gradients are deterministic run to run. The input's dtype picks each
// kernel: fp32 FMA for float32, tensor cores for bfloat16.
// - dQ: one thread block per (query tile of BQ rows, head, batch). It keeps
//   its Q and dO tiles in shared memory and loops over key tiles of BK rows,
//   rebuilding P and dS per tile; dQ accumulates in registers (fp32: 2 rows x
//   d/16 columns a thread, as the forward's output; bf16: below). With
//   `causal`, key tiles wholly above the diagonal are never loaded.
// - dK/dV: one block per (key tile of BK rows, head, batch). It keeps its K
//   and V tiles in shared memory and loops over query tiles; dK and dV
//   accumulate in registers for the block's life (fp32: 2 key rows x d/16
//   columns each, 64 fp32 a thread; bf16: below). With `causal`, query
//   tiles that end before the key tile starts (q0 + BQ - 1 < k0) are
//   skipped. The sequential grid axis that carried the Pallas accumulators
//   in VMEM becomes this in-block loop; nothing crosses blocks.
// Ragged edges: key rows >= Sk load as 0 and are masked, query rows >= Sq
// load as 0 and get P = 0 (not relying on dO = 0 there), and gradient rows
// past Sq or Sk are not stored.
//
// What bounds them on this card, and what the design does about it.
// - In fp32 both run every product as fp32 FMA from shared-memory tiles.
//   Each (query tile, key tile) pair costs 2 BQ BK d FMAs for S and dO v^T,
//   plus BQ BK d (dQ) or 2 BQ BK d (dK, dV), and the S / dO v^T loop issues
//   one shared-memory load per FMA, so they are bound by shared-memory
//   bandwidth and, at one block per SM, by latency. At d = 256 a dQ block
//   holds Q, dO, K and V tiles of 32 x 257 fp32 plus the dS tile: 136,192
//   bytes of dynamic shared memory; a dK/dV block adds a P tile: 140,416
//   bytes. Either allows one block (8 warps) per SM. ptxas -v (sm_90a,
//   CUDA 12.8): dQ 104, dK/dV 137 registers, no spills. They serve fp32
//   callers (the parity checks), not the bf16 train path.
// - In bf16 both run on tensor cores, with mma.sync m16n8k16 (bf16 in, fp32
//   accumulators) for every product, fragments by ldmatrix from tiles with
//   16-byte row padding (no bank conflicts, mma_bf16.cuh) and the head dim
//   padded to DP = 64 or 256 as in the forward. Their calls move 128-170
//   FLOP per byte at d = 256, under the H100's 295, so HBM bounds them
//   (dQ 84.2 MB, 0.0251 ms; dK/dV 101.0 MB, 0.0301 ms at the train cell's
//   B=32, S=256 call), but mma.sync feeds the tensor cores through
//   registers, so shared-memory fragment traffic and issue slots are what
//   they spend their time on. Measured in PERF.md.
// - dQ in bf16: a block owns DQ_BQ = 128 query rows and loops over key
//   tiles of DQ_BK = 32 rows, which arrive with their key validity by
//   cp.async into a ring of two stages, so tile t + 1 loads while tile t
//   computes; Q and dO are loaded once. Its 16 warps each own 16 query
//   rows with a partner warp; per key tile a warp computes S = Q K^T and
//   dP = dO V^T for half of the tile's key columns, writes dS (bf16, the
//   Pallas cast point) to a 128 x 32 shared tile, and after a barrier
//   dQ += dS K for half of the head dim, with dS read by ldmatrix and K by
//   ldmatrix .trans (K as stored: rows = keys = the product's k). The
//   128 x DP fp32 accumulator is spread at DP / 4 a thread (64 at
//   DP = 256). ptxas -v: 128 registers at DP = 256 (98 at 64), no spills;
//   213,248 bytes of dynamic shared memory (Q, dO, two stages of K and V,
//   dS), one block of 16 warps per SM. The 16 warps hide more of the
//   ldmatrix -> mma latency, which is what the mma.sync kernels here wait
//   on, than 8 warps over 64 x 64 tiles (178 registers) did: PERF.md.
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

namespace {

constexpr int BQ = 32;               // query rows per tile
constexpr int BK = 32;               // key rows per tile
constexpr int THREADS = 256;         // 16 x 16 threads
constexpr int MAX_D = 256;
constexpr int COLS = MAX_D / 16;     // accumulator columns per thread and row

// The FMA kernels below are instantiated for T = float only (bf16 runs on
// the tensor-core kernels in namespace tc)
__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}

// x rounded to T and read back as fp32: the Pallas kernels' cast points
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [r0, r0 + R) of a (S, d) matrix into an R x ld fp32 tile, 0 past S
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int R, int S, int d, int ld,
                                          int tid) {
  for (int i = tid; i < R * d; i += THREADS) {
    const int r = i / d, c = i - r * d;
    dst[r * ld + c] = r0 + r < S ? to_float(src[(size_t)(r0 + r) * d + c]) : 0.f;
  }
}

// S = A B^T and dP = G W^T for rows (ty, ty + 16) of the A/G tiles and rows
// (tx, tx + 16) of the B/W tiles: a 2x2 micro-tile of each
__device__ __forceinline__ void two_products(const float* A, const float* G,
                                             const float* Bt, const float* W,
                                             int ld, int d, int ty, int tx,
                                             float s[2][2], float dp[2][2]) {
  const float* a0 = A + ty * ld;
  const float* a1 = A + (ty + 16) * ld;
  const float* g0 = G + ty * ld;
  const float* g1 = G + (ty + 16) * ld;
  const float* b0 = Bt + tx * ld;
  const float* b1 = Bt + (tx + 16) * ld;
  const float* w0 = W + tx * ld;
  const float* w1 = W + (tx + 16) * ld;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < d; ++c) {
    const float qa = a0[c], qb = a1[c], ka = b0[c], kb = b1[c];
    const float ga = g0[c], gb = g1[c], va = w0[c], vb = w1[c];
    s[0][0] = fmaf(qa, ka, s[0][0]);
    s[0][1] = fmaf(qa, kb, s[0][1]);
    s[1][0] = fmaf(qb, ka, s[1][0]);
    s[1][1] = fmaf(qb, kb, s[1][1]);
    dp[0][0] = fmaf(ga, va, dp[0][0]);
    dp[0][1] = fmaf(ga, vb, dp[0][1]);
    dp[1][0] = fmaf(gb, va, dp[1][0]);
    dp[1][1] = fmaf(gb, vb, dp[1][1]);
  }
}

size_t dq_smem_bytes(int d) {
  const size_t ld = d + 1;
  return ((2 * BQ + 2 * BK) * ld + BQ * (BK + 1) + 2 * BQ + BK) *
         sizeof(float);
}

size_t dkv_smem_bytes(int d) {
  const size_t ld = d + 1;
  return ((2 * BQ + 2 * BK) * ld + 2 * BQ * (BK + 1) + 2 * BQ + BK) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int32_t* __restrict__ key_mask,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ drow, T* __restrict__ dq,
                         int H, int Sq, int Sk, int d, int causal,
                         float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Qs = smem;                         // BQ x ld
  float* dOs = Qs + BQ * ld;                // BQ x ld
  float* Ks = dOs + BQ * ld;                // BK x ld
  float* Vs = Ks + BK * ld;                 // BK x ld
  float* dSs = Vs + BK * ld;                // BQ x (BK + 1)
  float* lse_s = dSs + BQ * (BK + 1);       // this tile's row lse
  float* D_s = lse_s + BQ;                  // this tile's row dot D
  float* valid_s = D_s + BQ;                // this key tile's validity

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* kb = k + bh * Sk * d;
  const T* vb = v + bh * Sk * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  load_tile(Qs, q + bh * Sq * d, q0, BQ, Sq, d, ld, tid);
  load_tile(dOs, dout + bh * Sq * d, q0, BQ, Sq, d, ld, tid);
  if (tid < BQ) {
    const bool in = q0 + tid < Sq;
    lse_s[tid] = in ? lse[bh * Sq + q0 + tid] : -INFINITY;
    D_s[tid] = in ? drow[bh * Sq + q0 + tid] : 0.f;
  }

  float acc[2][COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) acc[0][j] = acc[1][j] = 0.f;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (q0 + BQ - 1) / BK + 1);

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();  // the previous tile's readers of Ks and dSs are done
    load_tile(Ks, kb, k0, BK, Sk, d, ld, tid);
    load_tile(Vs, vb, k0, BK, Sk, d, ld, tid);
    if (tid < BK)
      valid_s[tid] = (k0 + tid < Sk && mb[k0 + tid] != 0) ? 1.f : 0.f;
    __syncthreads();

    float s[2][2], dp[2][2];
    two_products(Qs, dOs, Ks, Vs, ld, d, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const bool ok = valid_s[col] != 0.f && q0 + row < Sq &&
                        (!causal || k0 + col <= q0 + row);
        const float p = ok ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        dSs[row * (BK + 1) + col] =
            round_to<T>(p * (dp[i][j] - D_s[row]) * scale);
      }
    }
    __syncthreads();

    // dQ += dS K for rows (ty, ty + 16), columns tx + 16 j
    for (int kk = 0; kk < BK; ++kk) {
      const float d0 = dSs[ty * (BK + 1) + kk];
      const float d1 = dSs[(ty + 16) * (BK + 1) + kk];
      const float* kr = Ks + kk * ld;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float kv = kr[col];
          acc[0][j] = fmaf(d0, kv, acc[0][j]);
          acc[1][j] = fmaf(d1, kv, acc[1][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ty + 16 * i;
    if (q0 + row >= Sq) continue;
    T* o = dq + (bh * Sq + q0 + row) * d;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = tx + 16 * j;
      if (col < d) o[col] = from_float<T>(acc[i][j]);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v,
                          const int32_t* __restrict__ key_mask,
                          const T* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ drow, T* __restrict__ dk,
                          T* __restrict__ dv, int H, int Sq, int Sk, int d,
                          int causal, float scale) {
  extern __shared__ float smem[];
  const int ld = d + 1;
  float* Ks = smem;                         // BK x ld
  float* Vs = Ks + BK * ld;                 // BK x ld
  float* Qs = Vs + BK * ld;                 // BQ x ld
  float* dOs = Qs + BQ * ld;                // BQ x ld
  float* Ps = dOs + BQ * ld;                // BQ x (BK + 1)
  float* dSs = Ps + BQ * (BK + 1);          // BQ x (BK + 1)
  float* lse_s = dSs + BQ * (BK + 1);       // this query tile's row lse
  float* D_s = lse_s + BQ;                  // this query tile's row dot D
  float* valid_s = D_s + BQ;                // this block's key validity

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * BK;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const T* qb = q + bh * Sq * d;
  const T* ob = dout + bh * Sq * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  load_tile(Ks, k + bh * Sk * d, k0, BK, Sk, d, ld, tid);
  load_tile(Vs, v + bh * Sk * d, k0, BK, Sk, d, ld, tid);
  if (tid < BK)
    valid_s[tid] = (k0 + tid < Sk && mb[k0 + tid] != 0) ? 1.f : 0.f;

  // key rows (ty, ty + 16) x columns tx + 16 j
  float dk_acc[2][COLS], dv_acc[2][COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j)
    dk_acc[0][j] = dk_acc[1][j] = dv_acc[0][j] = dv_acc[1][j] = 0.f;

  const int n_tiles = (Sq + BQ - 1) / BQ;
  // causal: tile i ends at row i BQ + BQ - 1, before k0 for i < k0 / BQ
  const int first = causal ? k0 / BQ : 0;

  for (int t = first; t < n_tiles; ++t) {
    const int q0 = t * BQ;
    __syncthreads();  // the previous tile's readers of Qs, dOs, Ps, dSs done
    load_tile(Qs, qb, q0, BQ, Sq, d, ld, tid);
    load_tile(dOs, ob, q0, BQ, Sq, d, ld, tid);
    if (tid < BQ) {
      const bool in = q0 + tid < Sq;
      lse_s[tid] = in ? lse[bh * Sq + q0 + tid] : -INFINITY;
      D_s[tid] = in ? drow[bh * Sq + q0 + tid] : 0.f;
    }
    __syncthreads();

    // query rows (ty, ty + 16) x key columns (tx, tx + 16)
    float s[2][2], dp[2][2];
    two_products(Qs, dOs, Ks, Vs, ld, d, ty, tx, s, dp);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int row = ty + 16 * i, col = tx + 16 * j;
        const bool ok = valid_s[col] != 0.f && q0 + row < Sq &&
                        (!causal || k0 + col <= q0 + row);
        const float p = ok ? expf(s[i][j] * scale - lse_s[row]) : 0.f;
        Ps[row * (BK + 1) + col] = round_to<T>(p);
        dSs[row * (BK + 1) + col] =
            round_to<T>(p * (dp[i][j] - D_s[row]) * scale);
      }
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q for key rows (ty, ty + 16)
    for (int qq = 0; qq < BQ; ++qq) {
      const float p0 = Ps[qq * (BK + 1) + ty];
      const float p1 = Ps[qq * (BK + 1) + ty + 16];
      const float s0 = dSs[qq * (BK + 1) + ty];
      const float s1 = dSs[qq * (BK + 1) + ty + 16];
      const float* gr = dOs + qq * ld;
      const float* qr = Qs + qq * ld;
#pragma unroll
      for (int j = 0; j < COLS; ++j) {
        const int col = tx + 16 * j;
        if (col < d) {
          const float g = gr[col], x = qr[col];
          dv_acc[0][j] = fmaf(p0, g, dv_acc[0][j]);
          dv_acc[1][j] = fmaf(p1, g, dv_acc[1][j]);
          dk_acc[0][j] = fmaf(s0, x, dk_acc[0][j]);
          dk_acc[1][j] = fmaf(s1, x, dk_acc[1][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = ty + 16 * i;
    if (k0 + row >= Sk) continue;
    T* gk = dk + (bh * Sk + k0 + row) * d;
    T* gv = dv + (bh * Sk + k0 + row) * d;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int col = tx + 16 * j;
      if (col < d) {
        gk[col] = from_float<T>(dk_acc[i][j]);
        gv[col] = from_float<T>(dv_acc[i][j]);
      }
    }
  }
}

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

template <typename T>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* key_mask, const void* dout, const void* lse,
                      const void* drow, void* dq, int B, int H, int Sq, int Sk,
                      int d, int causal, cudaStream_t stream) {
  const size_t smem = dq_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dq_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn_bwd_dq_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<T*>(dq), H, Sq, Sk, d,
      causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* key_mask, const void* dout,
                       const void* lse, const void* drow, void* dk, void* dv,
                       int B, int H, int Sq, int Sk, int d, int causal,
                       cudaStream_t stream) {
  const size_t smem = dkv_smem_bytes(d);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_bwd_dkv_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sk + BK - 1) / BK, H, B);
  flash_attn_bwd_dkv_kernel<T><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(drow), static_cast<T*>(dk),
      static_cast<T*>(dv), H, Sq, Sk, d, causal, 1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace

// q, dout, dq: (B, H, Sq, d); k, v, dk, dv: (B, H, Sk, d); all contiguous and
// of one dtype (is_bf16 ? bfloat16 : float32). key_mask: (B, Sk) int32,
// nonzero = attend. lse, drow: (B, H, Sq) float32 (the forward's row
// log-sum-exp and rowsum(dout * out) with NaN -> 0). Each launches on
// `stream`, allocates nothing, does not synchronise, and returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attn_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* key_mask, const void* dout,
                                 const void* lse, const void* drow, void* dq,
                                 int B, int H, int Sq, int Sk, int d,
                                 int causal, int is_bf16, void* stream) {
  if (bad_shape(B, H, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return (int)launch_dq<float>(q, k, v, key_mask, dout, lse, drow, dq, B, H,
                                 Sq, Sk, d, causal, s);
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
  if (!is_bf16)
    return (int)launch_dkv<float>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                  B, H, Sq, Sk, d, causal, s);
  if (d <= 64)
    return (int)tc::launch_dkv<64>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                   B, H, Sq, Sk, d, causal, s);
  return (int)tc::launch_dkv<256>(q, k, v, key_mask, dout, lse, drow, dk, dv,
                                  B, H, Sq, Sk, d, causal, s);
}
