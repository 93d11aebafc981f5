// Masked attention backward for Hopper (sm_90a), written by hand: two
// kernels, dQ and dK/dV, in a tensor-core version for each dtype.
//
// Replaces the two Pallas backward kernels of bmt_tpu/ops/pallas_attention.py,
// both launched by `_flash_attention_tiled_bwd`:
//   tf32::flash_attn_bwd_dq_tf32_sm90_kernel (fp32),
//   wg::flash_attn_bwd_dq_sm90_kernel (bf16)
//       <- `_dq_kernel`  (:351-389, pallas_call :473)
//   tf32::flash_attn_bwd_dkv_tf32_sm90_kernel (fp32),
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
// Both run every product on the tensor cores by wgmma.mma_async on tiles
// that TMA brings into shared memory (csrc/sm90.cuh): three TF32 products
// for float32 (below), bf16 for bfloat16 (further below). The head dim is
// padded to DP (a template parameter: 64 or 256 in fp32, 32, 64 or 256 in
// bf16; the padded columns load as 0 and are not stored), so d need only
// be a multiple of 8. Ragged edges: key rows >= Sk load as 0 and are
// masked, query rows >= Sq load as 0 and get P = 0 (not relying on dO = 0
// there), and gradient rows past Sq or Sk are not stored. Tiles arrive in a
// ring of stages, so tile t + 1 loads while tile t computes.
//
// fp32 (the fp32 train steps: make_cap_train_step's and
// make_prop_train_step's default compute dtype, and the parity checks).
// Every product is three TF32 wgmma products (m64nNk8, fp32 accumulators),
// lo(A) hi(B) + hi(A) lo(B) + hi(A) hi(B), so the gradients keep fp32
// accuracy; one TF32 product misses the fp32 tolerances
// (tests/test_torch_port_tf32.py emulates both). The tensor core reads an
// fp32 word as TF32 by dropping its low 13 bits, so a B operand's raw word
// in shared memory serves as hi = trunc(x), beside lo = rna(x - trunc(x));
// an A operand, split in registers, takes hi = rna(x), lo = rna(x - hi)
// (rna: round to nearest); S's and dP's two small products go into an
// accumulator of their own. So the errors against the plain backward read
// as the mma.sync kernels' did; with the raw word as A's hi, lo = x -
// trunc(x) read truncated and one accumulator they read 1.3-2.3x those,
// 12% faster (PERF.md). What bounds them on this card: three TF32
// products per fp32 product make the peak 495 / 3 = 165 TFLOP/s, and the
// train cell's 256x256 calls do 77-85 FLOP per byte against the 49 at
// which that peak and HBM's 3.35 TB/s cross: operations bound them (dQ
// 12.9 GFLOP, 0.078 ms; dK/dV 17.2 GFLOP, 0.104 ms; 800x800 B = 16: 0.381
// and 0.508 ms).
// Before them come each tile's steps between the products (below). The
// design, alike in both kernels ("rows" are the block's queries in dQ and
// its keys in dK/dV, "columns" those of the loop's tiles):
// - TF32 wgmma reads a shared-memory operand K-major only (the transposed
//   B is for 16-bit types), so every product takes its A operand from
//   registers, where any layout is a matter of addressing: S = Q K^T and
//   dP = dO V^T (dQ), S^T = K Q^T and dP^T = V dO^T (dK/dV) read the
//   block's own tile by rows; the gradients are computed transposed,
//   dQ^T = K^T dS^T, dV^T = dO^T P and dK^T = Q^T dS, reading the loop's
//   tile by columns. An A fragment is split in registers, two
//   instructions a value. B is K-major in shared memory: the loop's raw
//   tile as TMA landed it (hi) beside its lo parts, which a pass of the
//   consuming warpgroup writes at the same offsets; and dS, P^T, dS^T,
//   written from the accumulators as hi and lo tiles (64 rows x 32).
// - 64 rows a block, loop tiles of 32. A 64 x 256 fp32 tile takes 64 KB,
//   so at DP = 256 a cluster of two blocks shares a block's work, each with
//   128 head-dim columns: its own two tiles (64 KB), two stages of the
//   loop's raw tiles (64 KB), their lo parts (32 KB), the 64 x 32 tiles
//   and the partials' receive buffers fit 227 KB. Each block takes S and dP
//   over its columns and sends the partials (64 x 32 a warpgroup) to the
//   other by st.async, which completes the other's mbarrier; both add, x +
//   y being y + x, so both hold the same S and dP, P and dS, and each
//   computes its columns of the gradient. At DP = 64 one block takes all.
// - 384 threads: warpgroups 0 and 1 compute, warp 8 loads (rank-3 TMA
//   maps of fp32 (d, S, B H), regions of 32 columns with the 128-byte
//   swizzle, tile_map_f32), setmaxnreg 40 / 232. dQ: warpgroup 0 takes K's
//   lo parts, S and dP, sums them with the other block's and hands them
//   over; warpgroup 1 takes P, dS and dQ^T = K^T dS^T a tile behind, and
//   V's lo parts a tile ahead, so that its steps run under the next
//   tile's products (S and dP in one warpgroup each, P and dS passed
//   between them, ran 5% slower). dK/dV: 0 takes S^T, P^T and dV^T, 1
//   dP^T, dS^T and dK^T (each holds a 64 x 128 gradient at DP = 256).
// - A product's k-steps run in groups of 12 products (4 k-steps; 6 in
//   dQ's gradient), one group in flight: the next group's fragments load
//   while it runs (with two in flight, ptxas serialised every product,
//   C7514). A tile's gradient products go into a zeroed accumulator that
//   one fp32 add joins to the gradient (the tensor core adds each product
//   to its accumulator truncated, and the long runs of small terms of a
//   causal call's first rows drift).
// - Where the time goes (dQ at 800x800, clock64 marks in a copy of the
//   kernel before dQ's warpgroups took their present roles; PERF.md):
//   ~6,500 cycles a tile against 2,304 of tensor-core work, the rest the
//   split pass (64 KB of shared-memory traffic a tile), the partials'
//   round trip (~1,000), P's exp2 (700 with exp2f, 350 on the SFU) and
//   the hand-overs.
// - Short query blocks (the decoder's Sq = 21-23): dQ's block is a third
//   full; dK/dV's query tile two thirds. Grids: ceil(S / 64) x H x B
//   clusters, one block an SM (140-231 KB); at 800x800 B = 16 1,664
//   blocks, 12.6 waves on 132 SMs; the decoder's 128 clusters two waves.
// ptxas -v (sm_90a, CUDA 12.8): 168 registers at DP = 64 and 256 (the
// launch bound; setmaxnreg 40 and 232), no spills; dynamic shared memory
// at DP = 256: dQ 230,712 bytes, dK/dV 230,984; at 64: 149,080 and
// 149,608.
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
#include "sm90.cuh"

namespace {

constexpr int MAX_D = 256;

// ---------------------------------------------------------------------------
// fp32: TF32 wgmma, three products, on TMA tiles; at DP = 256 a cluster of
// two blocks, each with half the head dim
// ---------------------------------------------------------------------------

namespace tf32 {

using namespace sm90;
using mma_bf16::cp_async4;

constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = 384;         // and the producer warpgroup
constexpr int BM = 64;               // rows a block: dQ queries, dK/dV keys
constexpr int BN = 32;               // rows a tile of the block's loop
constexpr float LOG2E = 1.44269504088896341f;
// named barriers (0 is __syncthreads): each consumer warpgroup's own
// (WG_BAR + its index); in dK/dV the P^T hand-over, in dQ the S and dP
// hand-over (HO_*) and V's lo parts written
constexpr int P_READY = 1, P_FREE = 2, WG_BAR = 3;
constexpr int HO_READY = 1, HO_FREE = 2, V_READY = 5;
// k-steps whose A fragments a ring slot holds (product3): groups of 4
// k-steps, 12 products, took 2-5% less time than groups of 2 (the wait
// after each group is exposed); 8 would not fit in the registers
constexpr int STEP = 4;

template <int DP> struct Cfg {
  static constexpr int CL = DP == 256 ? 2 : 1;     // blocks a cluster
  static constexpr int DH = DP / CL;               // head-dim columns a block
  static constexpr int MB = DH / 64;               // 64-row blocks of dX^T
  static constexpr int STAGES = DP == 256 ? 2 : 4;
  static constexpr uint32_t OWN = BM * DH * 4;     // one of the block's tiles
  static constexpr uint32_t LOOP = BN * DH * 4;    // one of a loop tile's
  static constexpr uint32_t GRAD = BM * BN * 4;    // a 64 x 32 fp32 tile
  // k-steps a group of dK/dV's gradient products (product3; S and dP's
  // take STEP, dQ's 2): two groups or more
  static constexpr int G_GRAD = MB * (BN / 8) / STEP >= 2 ? STEP : STEP / 2;
};

// the A operands in flight (product3, sm90.cuh, with the splits,
// cluster_sum and store_grad_tile): two slots of K k-steps, hi = rna(x)
// and lo = rna(x - hi), four registers each. Ring
// holds STEP; RingG 2, for dQ's gradient, whose accumulators take the
// registers; RingS 8 for dQ's S and dP, whose groups take STEP all the
// same: with a ring of STEP there ptxas serialised dQ's products at
// DP = 64 (C7515), and groups of 8 slowed the decoder's 21-row calls
typedef uint32_t Ring[2][STEP][2][4];
typedef uint32_t RingG[2][2][2][4];
typedef uint32_t RingS[2][8][2][4];

// acc += t, once a tile's products into t have finished: one rounded add
// a tile (the tensor core adds its products to an accumulator truncated,
// and a long run of small terms into a large one drifts)
template <int MB, int R>
__device__ __forceinline__ void add_tile(float (&acc)[MB][R],
                                         float (&t)[MB][R]) {
#pragma unroll
  for (int m = 0; m < MB; ++m) {
    fence_operands(t[m]);
#pragma unroll
    for (int i = 0; i < R; ++i) acc[m][i] += t[m][i];
  }
}

// dX^T (DH x N, rows the block's head-dim columns from c0, columns N of
// its rows from r0) into rows < S, columns < d of out (row stride d)
template <int MB, int N>
__device__ __forceinline__ void store_transposed(
    const float (&acc)[MB][N / 2], float* out, int r0, int S, int c0, int d,
    int w, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < MB; ++m)
#pragma unroll
    for (int j = 0; j < N / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = c0 + 64 * m + 16 * w + g + 8 * (e >> 1);
        const int row = r0 + 8 * j + 2 * t + (e & 1);
        if (row < S && col < d) out[(size_t)row * d + col] = acc[m][4 * j + e];
      }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int DP> struct Dq {
  using C = Cfg<DP>;
  // byte offsets from the 1024-aligned base: Q, dO, STAGES of K and of V,
  // the lo parts of K and V, dS's hi and lo tiles, the S and dP hand-over,
  // the receive buffers of a cluster ([parity]: S, dP), the key mask's
  // STAGES, the barriers own_full, full[STAGES], empty[STAGES],
  // recv[parity]
  static constexpr uint32_t Q_OFF = 0, DO_OFF = C::OWN;
  static constexpr uint32_t K_OFF = 2 * C::OWN;
  static constexpr uint32_t V_OFF = K_OFF + C::STAGES * C::LOOP;
  static constexpr uint32_t KLO_OFF = V_OFF + C::STAGES * C::LOOP;
  static constexpr uint32_t VLO_OFF = KLO_OFF + C::LOOP;
  static constexpr uint32_t DS_OFF = VLO_OFF + C::LOOP;
  static constexpr uint32_t HO_OFF = DS_OFF + 2 * C::GRAD;
  static constexpr uint32_t RECV_OFF = HO_OFF + 2 * C::GRAD;
  static constexpr uint32_t MASK_OFF =
      RECV_OFF + (C::CL > 1 ? 4 * C::GRAD : 0);
  static constexpr uint32_t BAR_OFF = MASK_OFF + C::STAGES * BN * 4;
  static constexpr size_t SMEM = BAR_OFF + (3 + 2 * C::STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "dQ: shared memory");
};

// Block x of a cluster of CL along x, (y, z): query rows [64 (x / CL),
// + 64) of head y, batch z, head-dim columns [DH (x % CL), + DH); key
// tiles of BN rows in order. Warpgroup 0 computes S = Q K^T and dP =
// dO V^T and sums them with the other block's; warpgroup 1 computes P,
// dS and dQ^T = K^T dS^T a tile behind, and V's lo parts a tile ahead;
// warp 8 (the first of warpgroup 2) loads the tiles
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dq_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const int32_t* __restrict__ key_mask,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ drow,
                                   float* __restrict__ dq, int H, int Sq,
                                   int Sk, int d, int causal, float scale) {
  using C = Cfg<DP>;
  using L = Dq<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t own_full = base + L::BAR_OFF;
  const uint32_t full0 = own_full + 8, empty0 = full0 + 8 * C::STAGES;
  const uint32_t recv_bar0 = empty0 + 8 * C::STAGES;
  int32_t* mask_s = reinterpret_cast<int32_t*>(smem + L::MASK_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = (blockIdx.x / C::CL) * BM, h = blockIdx.y, b = blockIdx.z;
  const int c0 = (blockIdx.x % C::CL) * C::DH;
  const int bh = b * H + h;
  int n_tiles = (Sk + BN - 1) / BN;
  // causal: the block's last valid row sees keys up to itself
  if (causal) n_tiles = min(n_tiles, (min(q0 + BM, Sq) - 1) / BN + 1);

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    for (int r = 0; r < 2; ++r) mbar_init(recv_bar0 + 8 * r, 1);
    fence_barrier_init();
  }
  // the other block's barriers are ready before either block uses them
  if (C::CL > 1) cluster_sync(); else __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    // the producer warp: Q and dO once, then each key tile's K and V (by
    // TMA) and its key validity (by cp.async, 0 past Sk)
    setmaxnreg_dec<40>();
    if (warp_of(tid) == 8) {
      if (lane == 0) {
        mbar_arrive_expect_tx(own_full, 2 * C::OWN);
        for (int r = 0; r < C::DH / 32; ++r) {
          const uint32_t off = r * F32Tile<BM>::REGION;
          tma_load_3d(base + L::Q_OFF + off, &tm_q, own_full, c0 + 32 * r,
                      q0, bh);
          tma_load_3d(base + L::DO_OFF + off, &tm_do, own_full, c0 + 32 * r,
                      q0, bh);
        }
      }
      const int32_t* mask_g = key_mask + (size_t)b * Sk;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES, k0 = i * BN;
        const uint32_t full = full0 + 8 * st;
        if (i >= C::STAGES)
          mbar_wait(empty0 + 8 * st, (i / C::STAGES - 1) & 1);
        const bool in = k0 + lane < Sk;
        cp_async4(mask_s + st * BN + lane, in ? mask_g + k0 + lane : mask_g,
                  in);
        cp_async_mbar_arrive(full);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * C::LOOP);
          for (int r = 0; r < C::DH / 32; ++r) {
            const uint32_t off = st * C::LOOP + r * F32Tile<BN>::REGION;
            tma_load_3d(base + L::K_OFF + off, &tm_k, full, c0 + 32 * r, k0,
                        bh);
            tma_load_3d(base + L::V_OFF + off, &tm_v, full, c0 + 32 * r, k0,
                        bh);
          }
        }
      }
    }
    if (C::CL > 1) cluster_sync();   // neither block leaves while the other
                                     // may still write to it
  } else {
    setmaxnreg_inc<232>();
    const int t = tid & 127, warp = t >> 5;
    const int g = lane >> 2, tig = lane & 3;
    float* ho = reinterpret_cast<float*>(smem + L::HO_OFF);
    const uint32_t klo = base + L::KLO_OFF, vlo = base + L::VLO_OFF;
    // the receive buffers of tile i's S and dP (cluster_sum)
    auto recv_addr = [&](int i) {
      return base + L::RECV_OFF + (i & 1) * 2 * C::GRAD;
    };
    if (wgi == 0) {
      // S and dP, and their products' small terms
      float sp[1][16], dpv[1][16], spc[1][16], dpc[1][16];
      RingS ring;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        sp[0][e] = dpv[0][e] = spc[0][e] = dpc[0][e] = 0.f;
      mbar_wait(own_full, 0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES;
        const uint32_t k_tile = base + L::K_OFF + st * C::LOOP;
        const uint32_t v_tile = base + L::V_OFF + st * C::LOOP;
        mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);
        // K's lo parts, once the last tile's S has read the last ones in
        // every warp: HO_FREE follows each warp's wait, from tile 2 on
        if (i == 1) bar_sync(WG_BAR, 128);
        split_tile<C::LOOP>(smem + (k_tile - base), smem + (klo - base), t);
        bar_sync(WG_BAR, 128);
        // S = Q K^T and dP = dO V^T: 64 query rows x BN keys over this
        // block's DH columns; A = Q or dO (registers), B = K or V
        fence_operands(sp[0]);
        fence_operands(dpv[0]);
        fence_operands(spc[0]);
        fence_operands(dpc[0]);
        product3<32, 1, C::DH / 8, STEP, true>(
            sp, spc, ring,
            [&](int m, int kk, float (&x)[4]) {
              frag_rows<BM>(smem + L::Q_OFF, warp, lane, m, kk, x);
            },
            [&](int kk) { return F32Tile<BN>::kmajor(k_tile, kk); },
            [&](int kk) { return F32Tile<BN>::kmajor(klo, kk); }, false);
        bar_sync(V_READY, CONSUMERS);    // V's lo parts, from warpgroup 1
        product3<32, 1, C::DH / 8, STEP, true>(
            dpv, dpc, ring,
            [&](int m, int kk, float (&x)[4]) {
              frag_rows<BM>(smem + L::DO_OFF, warp, lane, m, kk, x);
            },
            [&](int kk) { return F32Tile<BN>::kmajor(v_tile, kk); },
            [&](int kk) { return F32Tile<BN>::kmajor(vlo, kk); }, false);
        wgmma_wait<0>();
        keep_ring(ring);
        fence_operands(sp[0]);
        fence_operands(dpv[0]);
        fence_operands(spc[0]);
        fence_operands(dpc[0]);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          sp[0][e] = spc[0][e] + sp[0][e];
          dpv[0][e] = dpc[0][e] + dpv[0][e];
        }
        mbar_arrive(empty0 + 8 * st);
        cluster_sum<C::CL, 2>(sp[0], dpv[0], recv_addr(i),
                              reinterpret_cast<const float4*>(
                                  smem + (recv_addr(i) - base)),
                              recv_bar0 + 8 * (i & 1), (i >> 1) & 1, t);
        // hand S and dP to warpgroup 1, whose thread t takes the same
        // places, once it has read the last tile's
        if (i > 0) bar_sync(HO_FREE, CONSUMERS);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          ho[e * 128 + t] = sp[0][e];
          ho[(16 + e) * 128 + t] = dpv[0][e];
        }
        bar_arrive(HO_READY, CONSUMERS);
      }
    } else {
      // the thread's two query rows (those of its S and dP fragments),
      // their lse in base-2 units and their D; rows past Sq read nothing
      // and are masked
      int row[2];
      float lse2[2], D[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        row[hf] = q0 + 16 * warp + g + 8 * hf;
        const size_t at = (size_t)bh * Sq + row[hf];
        const bool in = row[hf] < Sq;
        lse2[hf] = in ? lse[at] * LOG2E : 0.f;
        D[hf] = in ? drow[at] : 0.f;
      }
      const float scale2 = scale * LOG2E;
      const uint32_t ds = base + L::DS_OFF;
      float acc[C::MB][32], tmp[C::MB][32];   // dQ^T, and a tile's of it
      RingG ring;
#pragma unroll
      for (int m = 0; m < C::MB; ++m)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[m][e] = tmp[m][e] = 0.f;
      // V's lo parts of tile i, for warpgroup 0's dP; the last tile's dP,
      // which read the last ones, finished before HO_READY
      auto split_v = [&](int i) {
        const int st = i % C::STAGES;
        mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);
        split_tile<C::LOOP>(smem + L::V_OFF + st * C::LOOP,
                            smem + (vlo - base), t);
        bar_arrive(V_READY, CONSUMERS);
      };
      split_v(0);
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % C::STAGES, k0 = i * BN;
        float p[16], dsv[16];
        bar_sync(HO_READY, CONSUMERS);
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          p[e] = ho[e * 128 + t];
          dsv[e] = ho[(16 + e) * 128 + t];
        }
        if (i + 1 < n_tiles) bar_arrive(HO_FREE, CONSUMERS);
        // P = valid ? exp(S scale - lse) : 0 (never exp then mask), as
        // 2^(S scale log2(e) - lse log2(e)), and dS = P (dP - D) scale:
        // element 4 j + e is query row row[e / 2], key column 8 j + 2 tig
        // + e % 2
        const int32_t* valid = mask_s + st * BN;
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kl = 8 * j + 2 * tig + (e & 1), hf = e >> 1;
            const bool ok = valid[kl] != 0 && row[hf] < Sq &&
                            (!causal || k0 + kl <= row[hf]);
            const float pe =
                ok ? exp2_fast(p[4 * j + e] * scale2 - lse2[hf]) : 0.f;
            dsv[4 * j + e] = pe * (dsv[4 * j + e] - D[hf]) * scale;
          }
        }
        // once the last tile's dQ^T product has read dS in every warp, the
        // new one's hi and lo tiles (query rows, key columns), dQ^T's B
        // operand
        wgmma_wait<0>();
        keep_ring(ring);
        if (i > 0) add_tile<C::MB, 32>(acc, tmp);
        bar_sync(WG_BAR + 1, 128);
        store_grad_tile(dsv, smem + L::DS_OFF, smem + L::DS_OFF + C::GRAD,
                        warp, lane);
        fence_proxy_async();
        bar_sync(WG_BAR + 1, 128);
        // dQ^T += K^T dS^T: this block's DH columns x 64 query rows over
        // the tile's keys, into tmp; A = K^T (registers, from K's tile)
        product3<64, C::MB, BN / 8, 2, false>(
            tmp, tmp, ring,
            [&](int m, int kk, float (&x)[4]) {
              frag_cols<BN>(smem + L::K_OFF + st * C::LOOP, warp, lane, m,
                            kk, x);
            },
            [&](int kk) { return F32Tile<BM>::kmajor(ds, kk); },
            [&](int kk) { return F32Tile<BM>::kmajor(ds + C::GRAD, kk); },
            false);
        mbar_arrive(empty0 + 8 * st);
        if (i + 1 < n_tiles) split_v(i + 1);
      }
      wgmma_wait<0>();
      keep_ring(ring);
      add_tile<C::MB, 32>(acc, tmp);
      store_transposed<C::MB, 64>(acc, dq + (size_t)bh * Sq * d, q0, Sq, c0,
                                  d, warp, lane);
    }
    if (C::CL > 1) cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

template <int DP> struct Dkv {
  using C = Cfg<DP>;
  // byte offsets from the 1024-aligned base: K, V, STAGES of Q and of dO,
  // the lo parts of Q (warpgroup 0) and dO (1), P^T's and dS^T's hi and lo
  // tiles, the receive buffers of a cluster, STAGES of lse and of D, the
  // barriers own_full, full[STAGES], empty[STAGES], recv[warpgroup][parity]
  static constexpr uint32_t K_OFF = 0, V_OFF = C::OWN;
  static constexpr uint32_t Q_OFF = 2 * C::OWN;
  static constexpr uint32_t DO_OFF = Q_OFF + C::STAGES * C::LOOP;
  static constexpr uint32_t LO_OFF = DO_OFF + C::STAGES * C::LOOP;
  static constexpr uint32_t PT_OFF = LO_OFF + 2 * C::LOOP;
  static constexpr uint32_t DST_OFF = PT_OFF + 2 * C::GRAD;
  static constexpr uint32_t RECV_OFF = DST_OFF + 2 * C::GRAD;
  static constexpr uint32_t LSE_OFF =
      RECV_OFF + (C::CL > 1 ? 4 * C::GRAD : 0);
  static constexpr uint32_t D_OFF = LSE_OFF + C::STAGES * BN * 4;
  static constexpr uint32_t BAR_OFF = D_OFF + C::STAGES * BN * 4;
  static constexpr size_t SMEM = BAR_OFF + (5 + 2 * C::STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "dK/dV: shared memory");
};

// Block x of a cluster of CL along x, (y, z): key rows [64 (x / CL), + 64)
// of head y, batch z, head-dim columns [DH (x % CL), + DH); query tiles of
// BN rows in order. Warpgroup 0 computes S^T = K Q^T, P^T and dV^T =
// dO^T P; warpgroup 1 computes dP^T = V dO^T, dS^T and dK^T = Q^T dS;
// warp 8 (the first of warpgroup 2) loads the tiles
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_bwd_dkv_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const int32_t* __restrict__ key_mask,
                                    const float* __restrict__ lse,
                                    const float* __restrict__ drow,
                                    float* __restrict__ dk,
                                    float* __restrict__ dv, int H, int Sq,
                                    int Sk, int d, int causal, float scale) {
  using C = Cfg<DP>;
  using L = Dkv<DP>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t own_full = base + L::BAR_OFF;
  const uint32_t full0 = own_full + 8, empty0 = full0 + 8 * C::STAGES;
  const uint32_t recv_bar0 = empty0 + 8 * C::STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* d_s = reinterpret_cast<float*>(smem + L::D_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int k0 = (blockIdx.x / C::CL) * BM, h = blockIdx.y, b = blockIdx.z;
  const int c0 = (blockIdx.x % C::CL) * C::DH;
  const int bh = b * H + h;
  const int n_tiles = (Sq + BN - 1) / BN;
  // causal: query tile t ends at row t BN + BN - 1, before k0 for
  // t < k0 / BN; with Sq < Sk a block may see no tile at all
  const int first = causal ? min(k0 / BN, n_tiles) : 0;
  const int count = n_tiles - first;

  if (tid == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < C::STAGES; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    for (int r = 0; r < 4; ++r) mbar_init(recv_bar0 + 8 * r, 1);
    fence_barrier_init();
  }
  if (C::CL > 1) cluster_sync(); else __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    // the producer warp: K and V once, then each query tile's Q and dO (by
    // TMA) and its lse and D (by cp.async, 0 past Sq) into the ring as
    // soon as the tile's stage is free; the full barrier waits for both
    setmaxnreg_dec<40>();
    if (warp_of(tid) == 8 && count > 0) {
      if (lane == 0) {
        mbar_arrive_expect_tx(own_full, 2 * C::OWN);
        for (int r = 0; r < C::DH / 32; ++r) {
          const uint32_t off = r * F32Tile<BM>::REGION;
          tma_load_3d(base + L::K_OFF + off, &tm_k, own_full, c0 + 32 * r,
                      k0, bh);
          tma_load_3d(base + L::V_OFF + off, &tm_v, own_full, c0 + 32 * r,
                      k0, bh);
        }
      }
      const float* lse_g = lse + (size_t)bh * Sq;
      const float* d_g = drow + (size_t)bh * Sq;
      for (int i = 0; i < count; ++i) {
        const int st = i % C::STAGES, q0 = (first + i) * BN;
        const uint32_t full = full0 + 8 * st;
        if (i >= C::STAGES)
          mbar_wait(empty0 + 8 * st, (i / C::STAGES - 1) & 1);
        const bool in = q0 + lane < Sq;
        cp_async4(lse_s + st * BN + lane, in ? lse_g + q0 + lane : lse_g, in);
        cp_async4(d_s + st * BN + lane, in ? d_g + q0 + lane : d_g, in);
        cp_async_mbar_arrive(full);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(full, 2 * C::LOOP);
          for (int r = 0; r < C::DH / 32; ++r) {
            const uint32_t off = st * C::LOOP + r * F32Tile<BN>::REGION;
            tma_load_3d(base + L::Q_OFF + off, &tm_q, full, c0 + 32 * r, q0,
                        bh);
            tma_load_3d(base + L::DO_OFF + off, &tm_do, full, c0 + 32 * r,
                        q0, bh);
          }
        }
      }
    }
    if (C::CL > 1) cluster_sync();
  } else {
    setmaxnreg_inc<232>();
    const int t = tid & 127, warp = t >> 5;
    const int g = lane >> 2, tig = lane & 3;
    // the thread's two key rows (those of its S^T fragments)
    int kr[2];
    bool key_ok[2];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      kr[hf] = k0 + 16 * warp + g + 8 * hf;
      key_ok[hf] = kr[hf] < Sk && key_mask[(size_t)b * Sk + kr[hf]] != 0;
    }
    const float scale2 = scale * LOG2E;
    // S^T's A operand K (warpgroup 0) or dP^T's V (1), the lo parts of its
    // B operand, Q or dO, and the B operand of its gradient product, P^T
    // (dV^T = dO^T P) or dS^T (dK^T = Q^T dS), hi then lo
    const unsigned char* own = smem + (wgi == 0 ? L::K_OFF : L::V_OFF);
    const uint32_t lo = base + L::LO_OFF + wgi * C::LOOP;
    const uint32_t grad = base + (wgi == 0 ? L::PT_OFF : L::DST_OFF);
    const unsigned char* pt = smem + L::PT_OFF;
    const uint32_t recv = base + L::RECV_OFF + wgi * 2 * C::GRAD;
    const uint32_t recv_bar = recv_bar0 + wgi * 16;
    // S^T (0) or dP^T (1), and its products' small terms
    float s[1][16], sc[1][16];
    float acc[C::MB][32], tmp[C::MB][32];   // dV^T (0) or dK^T (1)
    Ring ring;
#pragma unroll
    for (int e = 0; e < 16; ++e) s[0][e] = sc[0][e] = 0.f;
#pragma unroll
    for (int m = 0; m < C::MB; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[m][e] = tmp[m][e] = 0.f;
    if (count > 0) mbar_wait(own_full, 0);

    // each tile's gradient product runs on while the next tile's S^T or
    // dP^T is issued
    for (int i = 0; i < count; ++i) {
      const int st = i % C::STAGES, q0 = (first + i) * BN;
      const uint32_t q_tile = base + L::Q_OFF + st * C::LOOP;
      const uint32_t do_tile = base + L::DO_OFF + st * C::LOOP;
      const uint32_t b_tile = wgi == 0 ? q_tile : do_tile;
      mbar_wait(full0 + 8 * st, (i / C::STAGES) & 1);
      // the lo parts of Q (0) or dO (1): the last tile's S^T or dP^T, which
      // read the last ones, finished before the warpgroup's barrier after
      // P^T or dS^T
      split_tile<C::LOOP>(smem + (b_tile - base), smem + (lo - base), t);
      bar_sync(WG_BAR + wgi, 128);

      // S^T = K Q^T (0) or dP^T = V dO^T (1): 64 keys x BN queries over
      // this block's DH columns; A = K or V (registers), B = Q or dO
      fence_operands(s[0]);
      fence_operands(sc[0]);
      product3<32, 1, C::DH / 8, STEP, true>(
          s, sc, ring,
          [&](int m, int kk, float (&x)[4]) {
            frag_rows<BM>(own, warp, lane, m, kk, x);
          },
          [&](int kk) { return F32Tile<BN>::kmajor(b_tile, kk); },
          [&](int kk) { return F32Tile<BN>::kmajor(lo, kk); }, false);
      wgmma_wait<0>();                   // and the last tile's gradient
      keep_ring(ring);
      fence_operands(s[0]);
      fence_operands(sc[0]);
#pragma unroll
      for (int e = 0; e < 16; ++e) s[0][e] = sc[0][e] + s[0][e];
      if (i > 0) add_tile<C::MB, 32>(acc, tmp);
      cluster_sum<C::CL, 1>(s[0], s[0], recv + (i & 1) * C::GRAD,
                            reinterpret_cast<const float4*>(
                                smem + (recv - base) + (i & 1) * C::GRAD),
                            recv_bar + 8 * (i & 1), (i >> 1) & 1, t);

      const float* rows = (wgi == 0 ? lse_s : d_s) + st * BN;
      if (wgi == 0) {
        // P^T = valid ? exp(S^T scale - lse) : 0 (never exp then mask), as
        // 2^(S^T scale log2(e) - lse log2(e)): element 4 j + e is key row
        // kr[e / 2], query column 8 j + 2 tig + e % 2
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int ql = 8 * j + 2 * tig + (e & 1), qi = q0 + ql;
            const bool ok = key_ok[e >> 1] && qi < Sq &&
                            (!causal || kr[e >> 1] <= qi);
            s[0][4 * j + e] =
                ok ? exp2_fast(s[0][4 * j + e] * scale2 - rows[ql] * LOG2E)
                   : 0.f;
          }
        }
        // P^T (key rows, query columns) is dV^T's B operand and warpgroup
        // 1's P: written once warpgroup 1 has read the last tile's
        if (i > 0) bar_sync(P_FREE, CONSUMERS);
        store_grad_tile(s[0], smem + L::PT_OFF, smem + L::PT_OFF + C::GRAD,
                        warp, lane);
        fence_proxy_async();
        bar_sync(WG_BAR, 128);
        bar_arrive(P_READY, CONSUMERS);
      } else {
        bar_sync(P_READY, CONSUMERS);
        // dS^T = P^T (dP^T - D) scale; P^T is 0 wherever it is masked
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int ql = 8 * j + 2 * tig;
            const float2 p = *reinterpret_cast<const float2*>(
                pt + F32Tile<BM>::at(16 * warp + g + 8 * hf, ql));
            float* x = &s[0][4 * j + 2 * hf];
            x[0] = p.x * (x[0] - rows[ql]) * scale;
            x[1] = p.y * (x[1] - rows[ql + 1]) * scale;
          }
        if (i + 1 < count) bar_arrive(P_FREE, CONSUMERS);
        store_grad_tile(s[0], smem + L::DST_OFF, smem + L::DST_OFF + C::GRAD,
                        warp, lane);
        fence_proxy_async();
        bar_sync(WG_BAR + 1, 128);
      }
      // dV^T += dO^T P (0) or dK^T += Q^T dS (1): this block's DH columns
      // x 64 keys over the tile's queries, into tmp; A = dO^T or Q^T
      // (registers, from the tile)
      const unsigned char* a_tile =
          smem + ((wgi == 0 ? do_tile : q_tile) - base);
      product3<64, C::MB, BN / 8, C::G_GRAD, false>(
          tmp, tmp, ring,
          [&](int m, int kk, float (&x)[4]) {
            frag_cols<BN>(a_tile, warp, lane, m, kk, x);
          },
          [&](int kk) { return F32Tile<BM>::kmajor(grad, kk); },
          [&](int kk) { return F32Tile<BM>::kmajor(grad + C::GRAD, kk); },
          false);
      mbar_arrive(empty0 + 8 * st);
    }
    wgmma_wait<0>();
    keep_ring(ring);
    if (count > 0) add_tile<C::MB, 32>(acc, tmp);
    store_transposed<C::MB, 64>(acc, (wgi == 0 ? dv : dk) + (size_t)bh * Sk * d,
                            k0, Sk, c0, d, warp, lane);
    if (C::CL > 1) cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// launches: the tensor maps are encoded on the host at each launch
// (sm90.cuh, tile_map_f32), and a cluster of Cfg::CL blocks along x
// ---------------------------------------------------------------------------

template <int DP>
cudaError_t launch_dq(const void* q, const void* k, const void* v,
                      const void* key_mask, const void* dout, const void* lse,
                      const void* drow, void* dq, int B, int H, int Sq, int Sk,
                      int d, int causal, cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  // maps baked into a CUDA graph that captures this launch (sm90.cuh)
  if (!tile_map_f32(&tq, q, d, Sq, B * H, BM) ||
      !tile_map_f32(&tdo, dout, d, Sq, B * H, BM) ||
      !tile_map_f32(&tk, k, d, Sk, B * H, BN) ||
      !tile_map_f32(&tv, v, d, Sk, B * H, BN))
    return cudaErrorInvalidValue;
  const dim3 grid(C::CL * ((Sq + BM - 1) / BM), H, B);
  return launch_clusters(
      flash_attn_bwd_dq_tf32_sm90_kernel<DP>, grid, C::CL, Dq<DP>::SMEM,
      stream, tq, tk, tv, tdo, static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<float*>(dq), H, Sq, Sk, d, causal, 1.0f / sqrtf((float)d));
}

template <int DP>
cudaError_t launch_dkv(const void* q, const void* k, const void* v,
                       const void* key_mask, const void* dout,
                       const void* lse, const void* drow, void* dk, void* dv,
                       int B, int H, int Sq, int Sk, int d, int causal,
                       cudaStream_t stream) {
  using C = Cfg<DP>;
  CUtensorMap tq, tk, tv, tdo;
  if (!tile_map_f32(&tq, q, d, Sq, B * H, BN) ||
      !tile_map_f32(&tdo, dout, d, Sq, B * H, BN) ||
      !tile_map_f32(&tk, k, d, Sk, B * H, BM) ||
      !tile_map_f32(&tv, v, d, Sk, B * H, BM))
    return cudaErrorInvalidValue;
  const dim3 grid(C::CL * ((Sk + BM - 1) / BM), H, B);
  return launch_clusters(
      flash_attn_bwd_dkv_tf32_sm90_kernel<DP>, grid, C::CL, Dkv<DP>::SMEM,
      stream, tq, tk, tv, tdo, static_cast<const int32_t*>(key_mask),
      static_cast<const float*>(lse), static_cast<const float*>(drow),
      static_cast<float*>(dk), static_cast<float*>(dv), H, Sq, Sk, d, causal,
      1.0f / sqrtf((float)d));
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
// picks the kernel, both on wgmma: three TF32 products for fp32 (the head
// dim padded to 64 or 256; clusters of two blocks at 256), bf16 for bf16
// (padded to 32, 64 or 256). The tensor maps are encoded here, and one that
// does not encode returns cudaErrorInvalidValue. Each launches on
// `stream`, allocates nothing,
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
