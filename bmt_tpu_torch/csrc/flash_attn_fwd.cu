// Fused masked attention forward for Hopper (sm_90a), written by hand.
//
// Replaces the two Pallas forward kernels of bmt_tpu/ops/pallas_attention.py:
// `_attn_kernel` (single block per (b, h), launched by
// `_flash_attention_impl`) and `_attn_kernel_tiled` /
// `_attn_kernel_tiled_nolse` (online softmax over key blocks, launched by
// `_flash_attention_tiled`). The single-block case is this kernel with one
// key tile, so one kernel serves every shape.
//
// What it computes, per (b, h):
//   out = softmax(where(valid, q k^T / sqrt(d), -inf)) v
//   valid[i, j] = key_mask[b, j] != 0 && j < Sk && (!causal || j <= i)
// Logits, softmax and the output accumulator are fp32; the output takes the
// input dtype. A row with no valid key ends as 0/0 = NaN, as in the plain
// version. With a non-null `lse` the kernel also writes each row's
// log-sum-exp of the scaled, masked logits, lse = m + log(l), fp32 (B, H, Sq):
// the backward kernels (flash_attn_bwd.cu) rebuild p = exp(s - lse) from it.
// An empty row gets m = -inf and l = 0, so lse = -inf. This is the lse
// output of `_attn_kernel_tiled` (pallas_attention.py:199-207) without the
// 8-lane broadcast, which only Mosaic's layout needed.
//
// Design. One thread block (in fp32 at d > 64 a cluster of two) per
// (query tile, head, batch). The block keeps
// its Q tile in shared memory and loops over key tiles with the
// online-softmax recurrence (running row max m, running row sum l,
// accumulator rescaled by exp(m_old - m_new) whenever the max grows; a row
// whose max is still -inf gets correction 0 and p 0). With `causal`, key
// tiles wholly above the diagonal are never loaded. Key rows >= Sk are
// masked and their V rows are loaded as 0, so they never enter the sum.
// The input's dtype picks one of two kernels, both on wgmma:
//
// bf16 (the serving and training path): wgmma.mma_async (bf16 in, fp32
// accumulators) on tiles that TMA brings into shared memory (csrc/sm90.cuh).
// What bounds it on this card: the train cell's B=32, S=256 call moves 128
// FLOP per byte at d = 256 against the H100's 295, so HBM bounds it (67.3
// MB, 0.0201 ms); the proposal cell's 800x800 calls do 41.9 GFLOP and
// the tensor cores bound them (0.0424 ms at B=16); at d = 32 a call does 8
// times fewer products for the same softmax, whose per-element steps
// (mask, max, exp2, sum) come before either bound. The design:
// - 384 threads: warpgroups 0 and 1 compute 64 query rows each (BQ = 128
//   a block), warp 8 (of warpgroup 2) loads; setmaxnreg moves registers
//   from the loading warpgroup to the computing ones (40 and 232 a thread,
//   168 at launch; at DP = 32 two blocks an SM, 32 and 104 of 80).
// - The loading warp brings the block's Q once and each 64-key K and V
//   tile into a ring of stages (2 at DP = 256, 4 below) by TMA from rank-3
//   tensor maps (d, S, B H) encoded at each launch: regions of 64 columns
//   with the 128-byte swizzle (32 and the 64-byte one at DP = 32); rows
//   past S and columns past d arrive as zeros, so d need only be a
//   multiple of 8. A tile's key validity comes by cp.async (0 past Sk),
//   tracked by K's full mbarrier. K and V have full and empty mbarriers of
//   their own: a K stage is free once the tile's S is computed, a V stage
//   only after its P V, so the next K tile loads while P V still runs.
// - Each computing warpgroup runs S = Q K^T as m64n64k16 products, Q and
//   K both K-major from shared memory, then the online softmax on the
//   accumulator registers (row max by quad shuffles, base-2 units with
//   exp2f, the running max m, a running sum kept per thread and added
//   across the row's four threads at the end, the accumulator rescaled by
//   exp2(m_old - m_new) only while some row max grows; a row whose max is
//   still -inf gets correction 0 and p 0). p, rounded to bf16 unnormalised
//   as the Pallas kernel does, turns in place into the register A operand
//   of O += P V (m64nDPk16), V read MN-major straight from its tile.
// - Overlap within a warpgroup: tile t's S is issued before tile t - 1's
//   P V, and tile t's softmax runs while that P V does; the two
//   warpgroups, each on its own rows, overlap each other besides.
// - The O accumulator is 64 x DP fp32 a warpgroup (128 registers a thread
//   at DP = 256), S 32 and P 16 more. Shared memory at DP = 256: Q 64 KB,
//   two stages of K and V 128 KB, 198,216 bytes with the masks and
//   barriers: one block an SM.
// - Causal: key tiles wholly above a block's last row are never loaded,
//   and those above a warpgroup's last row never computed; the compare by
//   position masks elements only in the tiles that cross the diagonal.
// - Grid ceil(Sq / 128) x H x B splits, no persistent tile loop: 256
//   blocks at the train cell (1.9 waves on 132 SMs), 448 at 800x800 B=16.
// - Key split, as in fp32 below (ops/flash_attention.py,
//   `bf16_key_splits`): when the blocks do not fill one wave, as a served
//   video's B=1 calls do, each row's key loop is split over blocks; each
//   split writes its fp32 partial and flash_attn_fwd_combine_kernel<bf16>
//   joins them in split order and rounds to bf16 once.
// Registers and shared memory from ptxas -v and the times are in PERF.md.
//
// fp32 (the single-video app, whose checkpoints are fp32, and the fp32
// train steps): TF32 wgmma.mma_async on tiles that TMA brings into shared
// memory, three products for each product, lo(A) hi(B) + hi(A) lo(B) +
// hi(A) hi(B), so the result keeps fp32 accuracy: one TF32 product misses
// the fp32 tolerances (tests/test_torch_port_tf32.py emulates both). What
// bounds it on this card: three TF32 products per fp32 product make the
// peak 495 / 3 = 165 TFLOP/s; the train cell's 256x256 calls (B=32, H=4,
// d=256; 8.6 GFLOP, 0.052 ms) and the app's caption batch (B=100, 512x512:
// 107.4 GFLOP, 0.651 ms) move ~128 FLOP per byte against the 49 at which
// that peak and HBM's 3.35 TB/s cross, so operations bound them, and so
// do the proposal calls but the B=1 300x300 one. Before the tensor cores
// come the steps between the products: the operands' splits, the softmax,
// P's tiles, the cluster's exchange. The design (alike in its roles to the
// fp32 dQ kernel of flash_attn_bwd.cu, whose header has the reasons):
// - Operands. TF32 wgmma reads a shared-memory operand K-major only, and
//   an A operand from registers in any layout.
//   S = Q K^T: A = Q, B = K, both K-major (the head dim is k). Q is the
//   same for the block's whole key loop, so warpgroup 0 splits it once
//   into registers, hi = rna(x), lo = rna(x - hi) (its 64 rows x 128
//   columns: 128 registers a thread), and the products (m64n32k8) read it
//   there: no split a tile, and B's 1 KB a product is all they read from
//   shared memory. (Q's hi and lo as shared-memory tiles read by
//   descriptor would make each product read 3 KB there, 24 clocks at 128
//   bytes a clock, against its 16 clocks of tensor-core work.) K's raw
//   tile serves as hi (read truncated) beside its lo parts rna(x -
//   trunc(x)), which the producer warpgroup's warps 9-11 write into a
//   lo tile of each stage. hi(Q) lo(K) and lo(Q) hi(K) go into an
//   accumulator of their own, added to hi(Q) hi(K) once the products
//   have finished. (The two small products' order is the one whose bits
//   keep chip_smoke's phase 23a, the mp-2 LoRA steps against one process,
//   on one side of a ReLU tie: PERF.md, section 6. The other order is as
//   accurate.)
//   O += P V would need V as a K-major B operand (keys as k), which V's
//   rows are not, so the block computes O^T += V^T P^T (m64n64k8, M the
//   head dim, N the 64 query rows, k the keys): A = V^T from registers,
//   read by columns from V's raw tile and split there (hi = rna(x), lo =
//   rna(x - hi); sm90.cuh, frag_cols and product3); B = P, written by
//   warpgroup 1 from its softmax registers as a 64 x 32 tile (query rows,
//   key columns: K-major), hi the raw word beside lo = rna(p - trunc(p)).
//   P is not rounded: the Pallas kernel casts p to v's dtype, fp32 here.
// - Shared memory and clusters. A 64 x 256 fp32 tile takes 64 KB; Q, three
//   stages of K, V and K's lo parts and P's tiles would take 352 KB. So at
//   DP = 256 a cluster of two blocks shares the 64 query rows, each with
//   128 head-dim columns: Q (32 KB), three stages of K, V and K's lo
//   (144 KB), P's two tiles (16 KB), the S hand-over (8 KB) and the
//   receive buffers (16 KB): 222,952 bytes with the masks and barriers.
//   Each block takes S over its columns and sends its partial (64 x 32) to
//   the other by st.async, which completes the other's mbarrier; both add,
//   x + y being y + x, so both hold the same S, softmax and P, and each
//   computes its columns of O^T. At DP = 64 one block takes all (DH = 64,
//   four stages).
// - Roles: 384 threads, setmaxnreg 40 / 232 (168 at launch). Warp 8 loads
//   each item's Q and each 32-key K and V tile with its key validity (TMA
//   from rank-3 maps of fp32 (d, S, B H), regions of 32 columns with the
//   128-byte swizzle, tile_map_f32; the mask by cp.async, 0 past Sk); warps
//   9-11 write K's lo parts and complete the stage's lo barrier. Warpgroup 0:
//   S, the cluster's sum, S handed to warpgroup 1 through shared memory
//   (thread t of either warpgroup holds the same elements). Warpgroup 1, a
//   tile behind: the mask and the online softmax, P's tiles, O^T += V^T
//   P^T, whose products run under the next tile's S.
// - The online softmax, as in the bf16 kernel: base-2 units, the running
//   max m and the thread's share of l, a row whose max is still -inf gets
//   correction 0 and p 0; exp2 on the special-function unit
//   (ex2.approx.ftz, within 2^-22). The corrections go through shared
//   memory to the threads that hold each query's column of O^T.
// - O's drift. A tile's products go into a zeroed accumulator (the tensor
//   core adds each product to its accumulator truncated, and long runs of
//   small terms drift); one fma per element then folds it in, acc = acc
//   corr + tile, the rescale with it (corr = 1 while no row max grows).
// - Causal: key tiles wholly above the block's last row are never loaded;
//   the compare by position masks the rest. Rows past Sq load as 0 and are
//   not stored.
// - Persistent clusters: a launch's work is ceil(Sq / 64) H B splits items
//   (query tile, head, batch row, split), and min(items, SMs / CL)
//   clusters (66 at DP = 256 on 132 SMs, one block an SM) each take every
//   clusters-th item, query tiles fastest so that the clusters at work
//   share their heads' K and V in L2. The K and V ring, the S hand-over
//   and the cluster's exchange run on across a cluster's items, and the
//   producer loads an item's Q as soon as warpgroup 0 has split the last
//   one's into registers: an item's first tiles load and its S runs while
//   warpgroup 1 folds and stores the item before. (A block for each item,
//   as the bf16 kernel launches, ran 1.20x slower at 256x256 B=32, whose
//   items have 8 key tiles each, and 1.09x at 800x800 B=16, but took 0.76x
//   the time at S=2048 causal, whose items differ in length up to 32-fold
//   and fall to the clusters in a fixed order: PERF.md.) The
//   decoder's 21-row calls (B=32, H=4) have 128 items of one to eight key
//   tiles, two a cluster, where the mma.sync kernel launched 128 blocks
//   of 8 warps: their times beside that kernel's are in PERF.md.
// - Key split: when the blocks (a cluster's two counted) do not fill one
//   wave, as the app's B=1 proposal calls at 300 query rows do (40 blocks),
//   the wrapper (ops/flash_attention.py, `fp32_key_splits`) splits each
//   row's key loop over splits = min(key tiles, SMs // blocks) blocks, cut
//   to ceil(tiles / ceil(tiles / splits)) so no split is empty, which makes
//   at most one wave. Each split writes its (m, l, unnormalised O) to fp32
//   scratch that the wrapper allocates; flash_attn_fwd_combine_kernel
//   weighs the partials by exp2(m_s - max m) in split order and writes out
//   and lse. No atomics: the same bits in every run.
// Registers and shared memory from ptxas -v and the times are in PERF.md.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (bmt_tpu_torch/ops/_build.py). No
// fast-math: the empty-row NaN relies on IEEE 0/0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

constexpr int MAX_D = 256;
constexpr float LN2 = 0.693147180559945309f;

// ---------------------------------------------------------------------------
// the key split's combine, for both dtypes
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(sm90::pack_bf16(v.x, v.y), sm90::pack_bf16(v.z, v.w));
}

// out (of type OUT) and lse of `rows` = B H Sq rows from `splits` fp32
// partials: one warp a row; weights w_s = exp2(m_s - max m) (0 for an empty
// partial), l = sum w_s l_s, out = sum w_s O_s / l, rounded to OUT once,
// lse = max m ln 2 + log l, summed in split order. A row empty in every
// split: l = 0, O = 0, so out is NaN and lse -inf, as without the split.
template <typename OUT>
__global__ void __launch_bounds__(128)
flash_attn_fwd_combine_kernel(const float* __restrict__ part,
                              OUT* __restrict__ out,
                              float* __restrict__ lse, long long rows, int d,
                              int splits) {
  const long long row = (long long)blockIdx.x * 4 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float* pm = part + (size_t)splits * rows * d + row;
  const float* pl = pm + (size_t)splits * rows;
  float m = -INFINITY;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, pm[s * rows]);
  auto weight = [&](int s) {
    const float ms = pm[s * rows];
    return ms == -INFINITY ? 0.f : exp2f(ms - m);
  };
  float l = 0.f;
  for (int s = 0; s < splits; ++s) l += weight(s) * pl[s * rows];
  const float inv = 1.f / l;
  for (int c = lane * 4; c < d; c += 128) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s = 0; s < splits; ++s) {
      const float w = weight(s);
      const float4 x = *reinterpret_cast<const float4*>(
          part + ((size_t)s * rows + row) * d + c);
      acc.x += w * x.x;
      acc.y += w * x.y;
      acc.z += w * x.z;
      acc.w += w * x.w;
    }
    store4(out + row * d + c,
           make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv));
  }
  if (lse != nullptr && lane == 0) lse[row] = m * LN2 + logf(l);
}

// ---------------------------------------------------------------------------
// fp32: TF32 wgmma, three products, on TMA tiles; at DP = 256 a cluster of
// two blocks, each with half the head dim; optional key split with a
// combine kernel
// ---------------------------------------------------------------------------

namespace tf32 {

using namespace sm90;
using mma_bf16::cp_async4;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = 384;         // and the producer warpgroup
constexpr int LO_THREADS = 96;       // its warps 9-11: K's lo parts
constexpr int BQ = 64;               // query rows a block (a cluster)
constexpr int BK = 32;               // key rows a tile
constexpr float LOG2E = 1.44269504088896341f;
// named barriers (0 is __syncthreads): the S hand-over from warpgroup 0
// to warpgroup 1, and each consumer warpgroup's own (WG_BAR + its index)
constexpr int HO_READY = 1, HO_FREE = 2, WG_BAR = 3;

template <int DP> struct Fwd {
  static constexpr int CL = DP == 256 ? 2 : 1;     // blocks a cluster
  static constexpr int DH = DP / CL;               // head-dim columns a block
  static constexpr int MB = DH / 64;               // 64-row blocks of O^T
  static constexpr int STAGES = DP == 256 ? 3 : 4;
  static constexpr uint32_t OWN = BQ * DH * 4;     // Q's tile
  static constexpr uint32_t LOOP = BK * DH * 4;    // a K or V tile
  static constexpr uint32_t P_TILE = BQ * BK * 4;  // a 64 x 32 fp32 tile
  // byte offsets from the 1024-aligned base: Q, STAGES of K, of V and of
  // K's lo parts, P's hi and lo tiles, the S hand-over, the receive buffers
  // of a cluster ([parity]), the rows' corrections (then 1 / l), STAGES of
  // the key mask, the barriers own_full, own_empty, full[STAGES],
  // lo_full[STAGES], empty[STAGES], recv[parity]
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = OWN;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * LOOP;
  static constexpr uint32_t KLO_OFF = V_OFF + STAGES * LOOP;
  static constexpr uint32_t P_OFF = KLO_OFF + STAGES * LOOP;
  static constexpr uint32_t HO_OFF = P_OFF + 2 * P_TILE;
  static constexpr uint32_t RECV_OFF = HO_OFF + P_TILE;
  static constexpr uint32_t CORR_OFF = RECV_OFF + (CL > 1 ? 2 * P_TILE : 0);
  static constexpr uint32_t MASK_OFF = CORR_OFF + BQ * 4;
  static constexpr uint32_t BAR_OFF = MASK_OFF + STAGES * BK * 4;
  static constexpr size_t SMEM = BAR_OFF + (4 + 3 * STAGES) * 8 + 1024;
  static_assert(SMEM <= 232448, "fp32 forward: shared memory");
};

// the work of one (query tile, head, batch row, split) of a launch: its
// first query row, b H + h, batch row, split, first key tile and key tiles
// (under causal, none wholly above the diagonal; a split may be left with
// none: it writes an empty partial)
struct Item {
  int q0, bh, b, sp, t0, count;
};

__device__ __forceinline__ Item item_of(int w, int H, int Sq, int Sk,
                                        int causal, int splits, int chunk) {
  const int qt = (Sq + BQ - 1) / BQ;
  Item it;
  it.q0 = (w % qt) * BQ;
  const int hz = w / qt, h = hz % H, z = hz / H;
  it.b = z / splits;
  it.sp = z % splits;
  it.bh = it.b * H + h;
  it.t0 = it.sp * chunk;
  int t1 = min((Sk + BK - 1) / BK, it.t0 + chunk);
  if (causal) t1 = min(t1, (min(it.q0 + BQ, Sq) - 1) / BK + 1);
  it.count = max(t1 - it.t0, 0);
  return it;
}

// Persistent clusters of CL blocks along x: cluster c takes the items c,
// c + clusters, ... of the launch's ceil(Sq / 64) H B splits (query tiles
// fastest, so that the clusters at work share their heads' K and V in L2),
// each block head-dim columns [DH (x % CL), + DH) of them. The K and V
// ring, the S hand-over and the cluster's receive buffers run on across
// the items, and so does the producer: it loads an item's Q once
// warpgroup 0 has split the last one's into registers, so that a block's
// next item starts while warpgroup 1 still folds and stores the last.
// Warpgroup 0 splits each item's Q into registers, then takes S = Q K^T
// over the block's columns and sums it with the other block's; warpgroup
// 1 takes the online softmax, P's tiles and O^T += V^T P^T a tile behind;
// warp 8 (the first of warpgroup 2) loads the tiles, warps 9-11 write K's
// lo parts. With `part` null (splits = 1) a block writes out and lse;
// else each item's partial (m in base-2 units, l, unnormalised O) into
// `part` (see flash_attn_fwd_split)
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_fwd_tf32_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const int32_t* __restrict__ key_mask,
                                float* __restrict__ out,
                                float* __restrict__ lse,
                                float* __restrict__ part, int B, int H,
                                int Sq, int Sk, int d, int causal,
                                int splits, int chunk, float scale) {
  using L = Fwd<DP>;
  constexpr int S = L::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t own_full = base + L::BAR_OFF, own_empty = own_full + 8;
  const uint32_t full0 = own_empty + 8, lo_full0 = full0 + 8 * S;
  const uint32_t empty0 = lo_full0 + 8 * S, recv_bar0 = empty0 + 8 * S;
  int32_t* mask_s = reinterpret_cast<int32_t*>(smem + L::MASK_OFF);
  float* ho = reinterpret_cast<float*>(smem + L::HO_OFF);
  float* corr_s = reinterpret_cast<float*>(smem + L::CORR_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int c0 = (blockIdx.x % L::CL) * L::DH;
  const int items = (Sq + BQ - 1) / BQ * H * B * splits;
  const int w0 = blockIdx.x / L::CL, dw = gridDim.x / L::CL;
  auto item = [&](int w) {
    return item_of(w, H, Sq, Sk, causal, splits, chunk);
  };

  if (tid == 0) {
    mbar_init(own_full, 1);
    mbar_init(own_empty, 128);
    for (int s = 0; s < S; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(lo_full0 + 8 * s, LO_THREADS);
      mbar_init(empty0 + 8 * s, CONSUMERS);
    }
    for (int r = 0; r < 2; ++r) mbar_init(recv_bar0 + 8 * r, 1);
    fence_barrier_init();
  }
  // the other block's barriers are ready before either block uses them
  if (L::CL > 1) cluster_sync(); else __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    setmaxnreg_dec<40>();
    if (warp_of(tid) == 8) {
      // the producer warp: each item's Q once its buffer is free, then
      // each of its key tiles' K and V (by TMA) and key validity (by
      // cp.async, 0 past Sk) as soon as its stage is free; the full
      // barrier waits for both. n counts the key tiles, nq the Q tiles
      int n = 0, nq = 0;
      for (int w = w0; w < items; w += dw) {
        const Item it = item(w);
        if (it.count == 0) continue;
        if (lane == 0) {
          if (nq > 0) mbar_wait(own_empty, (nq - 1) & 1);
          mbar_arrive_expect_tx(own_full, L::OWN);
          for (int r = 0; r < L::DH / 32; ++r)
            tma_load_3d(base + L::Q_OFF + r * F32Tile<BQ>::REGION, &tm_q,
                        own_full, c0 + 32 * r, it.q0, it.bh);
        }
        ++nq;
        const int32_t* mask_g = key_mask + (size_t)it.b * Sk;
        for (int i = 0; i < it.count; ++i, ++n) {
          const int st = n % S, k0 = (it.t0 + i) * BK;
          const uint32_t full = full0 + 8 * st;
          if (n >= S) mbar_wait(empty0 + 8 * st, (n / S - 1) & 1);
          const bool in = k0 + lane < Sk;
          cp_async4(mask_s + st * BK + lane,
                    in ? mask_g + k0 + lane : mask_g, in);
          cp_async_mbar_arrive(full);
          __syncwarp();
          if (lane == 0) {
            mbar_arrive_expect_tx(full, 2 * L::LOOP);
            for (int r = 0; r < L::DH / 32; ++r) {
              const uint32_t off = st * L::LOOP + r * F32Tile<BK>::REGION;
              tma_load_3d(base + L::K_OFF + off, &tm_k, full, c0 + 32 * r,
                          k0, it.bh);
              tma_load_3d(base + L::V_OFF + off, &tm_v, full, c0 + 32 * r,
                          k0, it.bh);
            }
          }
        }
      }
    } else {
      // warps 9-11: K's lo parts of each tile into the stage's lo tile, at
      // the same offsets (so in the same swizzled layout). A stage's lo
      // tile is free when its K is: S, which reads both, finished before
      // the stage was released and refilled
      const int u = tid - (THREADS - LO_THREADS);
      int n = 0;
      for (int w = w0; w < items; w += dw) {
        const int count = item(w).count;
        for (int i = 0; i < count; ++i, ++n) {
          const int st = n % S;
          const unsigned char* src = smem + L::K_OFF + st * L::LOOP;
          unsigned char* dst = smem + L::KLO_OFF + st * L::LOOP;
          mbar_wait(full0 + 8 * st, (n / S) & 1);
#pragma unroll 2
          for (int j = u; j < (int)(L::LOOP / 16); j += LO_THREADS) {
            const float4 x = *reinterpret_cast<const float4*>(src + j * 16);
            *reinterpret_cast<float4*>(dst + j * 16) = make_float4(
                lo_part(x.x), lo_part(x.y), lo_part(x.z), lo_part(x.w));
          }
          fence_proxy_async();
          mbar_arrive(lo_full0 + 8 * st);
        }
      }
    }
    if (L::CL > 1) cluster_sync();   // neither block leaves while the other
                                     // may still write to it
    return;
  }

  setmaxnreg_inc<232>();
  const int t = tid & 127, warp = t >> 5;
  const int g = lane >> 2, tig = lane & 3;
  if (wgi == 0) {
    // S = Q K^T, 64 query rows x BK keys over this block's DH columns: A
    // = Q from registers, split once for each item's whole key loop (hi =
    // rna(x), lo = rna(x - hi)); B = K, its raw tile (hi) and lo parts
    // from shared memory. hi(Q) lo(K) and lo(Q) hi(K) into spc (in this
    // order: see the header), hi(Q) hi(K) into sp, added once the
    // products have finished
    float sp[16], spc[16];
    uint32_t qa[L::DH / 8][2][4];
#pragma unroll
    for (int e = 0; e < 16; ++e) sp[e] = spc[e] = 0.f;
    int n = 0, nq = 0;                 // key tiles and Q tiles so far
    for (int w = w0; w < items; w += dw) {
      const int count = item(w).count;
      if (count == 0) continue;
      mbar_wait(own_full, nq & 1);
#pragma unroll
      for (int kk = 0; kk < L::DH / 8; ++kk) {
        float x[4];
        frag_rows<BQ>(smem + L::Q_OFF, warp, lane, 0, kk, x);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          qa[kk][0][e] = rna_tf32(x[e]);
          qa[kk][1][e] = rna_tf32(x[e] - __uint_as_float(qa[kk][0][e]));
        }
      }
      mbar_arrive(own_empty);          // Q's buffer: the next item's
      ++nq;
      for (int i = 0; i < count; ++i, ++n) {
        const int st = n % S;
        const uint32_t k_tile = base + L::K_OFF + st * L::LOOP;
        const uint32_t klo = base + L::KLO_OFF + st * L::LOOP;
        mbar_wait(full0 + 8 * st, (n / S) & 1);
        mbar_wait(lo_full0 + 8 * st, (n / S) & 1);
        fence_operands(sp);
        fence_operands(spc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < L::DH / 8; ++kk) {
          WgmmaTf32<32>::rs(spc, qa[kk][0], F32Tile<BK>::kmajor(klo, kk),
                            kk > 0);
          WgmmaTf32<32>::rs(spc, qa[kk][1],
                            F32Tile<BK>::kmajor(k_tile, kk), 1);
          WgmmaTf32<32>::rs(sp, qa[kk][0], F32Tile<BK>::kmajor(k_tile, kk),
                            kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_operands(sp);
        fence_operands(spc);
#pragma unroll
        for (int e = 0; e < 16; ++e) sp[e] = spc[e] + sp[e];
        mbar_arrive(empty0 + 8 * st);
        // the other block's S over its columns (st.async into this
        // block's receive buffer of tile n's parity), added
        const uint32_t recv = base + L::RECV_OFF + (n & 1) * L::P_TILE;
        cluster_sum<L::CL, 1>(sp, sp, recv,
                              reinterpret_cast<const float4*>(
                                  smem + (recv - base)),
                              recv_bar0 + 8 * (n & 1), (n >> 1) & 1, t);
        // hand S to warpgroup 1, whose thread t takes the same places,
        // once it has read the last tile's
        if (n > 0) bar_sync(HO_FREE, CONSUMERS);
#pragma unroll
        for (int e = 0; e < 16; ++e) ho[e * 128 + t] = sp[e];
        bar_arrive(HO_READY, CONSUMERS);
      }
    }
    // warpgroup 1 frees the hand-over after each tile: the last one's too
    if (n > 0) bar_sync(HO_FREE, CONSUMERS);
  } else {
    // logits in base-2 units, s log2(e) / sqrt(d): p = 2^(s2 - m2) is
    // exp(s / sqrt(d) - m), and m is kept in these units
    const float scale2 = scale * LOG2E;
    const uint32_t p_hi = base + L::P_OFF, p_lo = p_hi + L::P_TILE;
    // O^T (DH x 64: the block's head-dim columns x the query rows), and a
    // tile's P V^T, summed from zero and folded into it once finished
    float acc[L::MB][32], tmp[L::MB][32];
    uint32_t ring[2][2][2][4];
#pragma unroll
    for (int m = 0; m < L::MB; ++m)
#pragma unroll
      for (int e = 0; e < 32; ++e) tmp[m][e] = 0.f;
    // acc = acc c + tmp, c the correction of each query column (in corr_s
    // from the tile of tmp's P): one fp32 rounding a tile (the tensor core
    // adds its products to an accumulator truncated, and long runs of
    // small terms into a large one drift), and the rescale with it
    auto fold = [&]() {
#pragma unroll
      for (int m = 0; m < L::MB; ++m) {
        fence_operands(tmp[m]);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 c =
              *reinterpret_cast<const float2*>(corr_s + 8 * j + 2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[m][4 * j + e] =
                fmaf(acc[m][4 * j + e], (e & 1) ? c.y : c.x, tmp[m][4 * j + e]);
        }
      }
    };
    int n = 0;                         // key tiles so far
    for (int w = w0; w < items; w += dw) {
      const Item it = item(w);
      // the thread's two query rows (those of its S fragments)
      int row[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        row[hf] = it.q0 + 16 * warp + g + 8 * hf;
#pragma unroll
      for (int m = 0; m < L::MB; ++m)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[m][e] = 0.f;
      // the running row max (base-2 units) and the thread's share of the
      // row sum: the four threads of a row hold the same max, so their
      // shares are added only at the end
      float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
      for (int i = 0; i < it.count; ++i, ++n) {
        const int st = n % S, k0 = (it.t0 + i) * BK;
        float s[16];
        bar_sync(HO_READY, CONSUMERS);
#pragma unroll
        for (int e = 0; e < 16; ++e) s[e] = ho[e * 128 + t];
        bar_arrive(HO_FREE, CONSUMERS);
        // scale (to base-2 units) and mask (-inf): element 4 j + e is
        // query row row[e / 2], key k0 + 8 j + 2 tig + e % 2
        const int32_t* valid = mask_s + st * BK;
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
          const int kl = 8 * j + 2 * tig;
          const int2 vm = *reinterpret_cast<const int2*>(valid + kl);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int hf = e >> 1;
            const bool ok = ((e & 1) ? vm.y : vm.x) != 0 &&
                            (!causal || k0 + kl + (e & 1) <= row[hf]);
            const float x = ok ? s[4 * j + e] * scale2 : -INFINITY;
            s[4 * j + e] = x;
            mx[hf] = fmaxf(mx[hf], x);
          }
        }
        // the online softmax: a row whose max is still -inf gets
        // correction 0 and p 0
        float corr[2], neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float m_new = fmaxf(m_run[hf], quad_max(mx[hf]));
          corr[hf] = m_new == -INFINITY ? 0.f : exp2_fast(m_run[hf] - m_new);
          neg[hf] = m_new == -INFINITY ? 0.f : -m_new;
          m_run[hf] = m_new;
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int hf = (e >> 1) & 1;
          const float p = exp2_fast(s[e] + neg[hf]);
          s[e] = p;
          sum[hf] += p;
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf)
          l_run[hf] = corr[hf] * l_run[hf] + sum[hf];
        // the last tile's product has finished: fold it in with its tile's
        // corrections; then, once every warp has, this tile's P (query
        // rows, key columns: O^T's K-major B operand, not rounded, as fp32
        // is v's dtype) and corrections
        wgmma_wait<0>();
        keep_ring(ring);
        if (i > 0) fold();
        bar_sync(WG_BAR + 1, 128);
        store_grad_tile(s, smem + L::P_OFF, smem + L::P_OFF + L::P_TILE,
                        warp, lane);
        if (tig == 0) {
          corr_s[16 * warp + g] = corr[0];
          corr_s[16 * warp + g + 8] = corr[1];
        }
        fence_proxy_async();
        bar_sync(WG_BAR + 1, 128);
        // O^T += V^T P^T: this block's DH columns x 64 query rows over the
        // tile's keys, into tmp; A = V^T (registers, from V's tile)
        product3<64, L::MB, BK / 8, 2, false>(
            tmp, tmp, ring,
            [&](int m, int kk, float (&x)[4]) {
              frag_cols<BK>(smem + L::V_OFF + st * L::LOOP, warp, lane, m,
                            kk, x);
            },
            [&](int kk) { return F32Tile<BQ>::kmajor(p_hi, kk); },
            [&](int kk) { return F32Tile<BQ>::kmajor(p_lo, kk); }, false);
        mbar_arrive(empty0 + 8 * st);
      }
      wgmma_wait<0>();
      keep_ring(ring);
      if (it.count > 0) fold();
      // each query column's 1 / l (an empty row: l = 0, o = 0, so o (1 /
      // l) = 0 inf = NaN), through corr_s once every warp has folded
      float l[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) l[hf] = quad_sum(l_run[hf]);
      bar_sync(WG_BAR + 1, 128);
      if (tig == 0) {
        corr_s[16 * warp + g] = part == nullptr ? 1.f / l[0] : 1.f;
        corr_s[16 * warp + g + 8] = part == nullptr ? 1.f / l[1] : 1.f;
      }
      bar_sync(WG_BAR + 1, 128);
      // lse (or the partial's m and l): from the first block of a
      // cluster, both of which hold the same rows' m and l. The partial
      // of split sp: O (splits, B H Sq, d), then m and l (splits, B H Sq)
      // each
      const size_t rows = (size_t)B * H * Sq;
      const size_t p0 = it.sp * rows + (size_t)it.bh * Sq;
      if (c0 == 0 && tig == 0) {
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          if (row[hf] >= Sq) continue;
          if (part == nullptr) {      // empty row: -inf + log(0) = -inf
            if (lse != nullptr)
              lse[(size_t)it.bh * Sq + row[hf]] =
                  m_run[hf] * LN2 + logf(l[hf]);
          } else {
            float* pm = part + (size_t)splits * rows * d + p0;
            pm[row[hf]] = m_run[hf];
            pm[(size_t)splits * rows + row[hf]] = l[hf];
          }
        }
      }
      // O (or the partial's unnormalised O): element 4 j + e of acc[m] is
      // head-dim column c0 + 64 m + 16 warp + g + 8 (e / 2), query row q0
      // + 8 j + 2 tig + e % 2
      float* ob =
          part == nullptr ? out + (size_t)it.bh * Sq * d : part + p0 * d;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 inv =
            *reinterpret_cast<const float2*>(corr_s + 8 * j + 2 * tig);
#pragma unroll
        for (int m = 0; m < L::MB; ++m)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c0 + 64 * m + 16 * warp + g + 8 * (e >> 1);
            const int r = it.q0 + 8 * j + 2 * tig + (e & 1);
            if (r < Sq && col < d)
              ob[(size_t)r * d + col] =
                  acc[m][4 * j + e] * ((e & 1) ? inv.y : inv.x);
          }
      }
    }
  }
  if (L::CL > 1) cluster_sync();
}

// the SMs of the current device, read once
inline int sm_count() {
  static int n = [] {
    int dev = 0, sms = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 1;
    return sms;
  }();
  return n;
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* out, float* lse, float* part,
                   int B, int H, int Sq, int Sk, int d, int causal,
                   int splits, cudaStream_t stream) {
  using L = Fwd<DP>;
  CUtensorMap tq, tk, tv;
  // maps baked into a CUDA graph that captures this launch (sm90.cuh)
  if (!tile_map_f32(&tq, q, d, Sq, B * H, BQ) ||
      !tile_map_f32(&tk, k, d, Sk, B * H, BK) ||
      !tile_map_f32(&tv, v, d, Sk, B * H, BK))
    return cudaErrorInvalidValue;
  const int tiles = (Sk + BK - 1) / BK;
  const int chunk = (tiles + splits - 1) / splits;
  // one cluster for each item, at most one a CL SMs: one wave
  const long long items = (long long)((Sq + BQ - 1) / BQ) * H * B * splits;
  const int clusters =
      (int)std::min<long long>(items, std::max(1, sm_count() / L::CL));
  cudaError_t err = launch_clusters(
      flash_attn_fwd_tf32_sm90_kernel<DP>, dim3(L::CL * clusters), L::CL,
      L::SMEM, stream, tq, tk, tv, static_cast<const int32_t*>(key_mask),
      static_cast<float*>(out), lse, splits > 1 ? part : nullptr, B, H, Sq,
      Sk, d, causal, splits, chunk, 1.0f / sqrtf((float)d));
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * Sq;
  flash_attn_fwd_combine_kernel<<<(unsigned)((rows + 3) / 4), 128, 0,
                                  stream>>>(part, static_cast<float*>(out),
                                            lse, rows, d, splits);
  return cudaGetLastError();
}

}  // namespace tf32

// ---------------------------------------------------------------------------
// bf16: TMA tiles, a producer warp and two consumer warpgroups on wgmma
// ---------------------------------------------------------------------------

namespace wg {

using namespace sm90;
using mma_bf16::cp_async4;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;
typedef __nv_bfloat16 bf16;

constexpr int BQ = 128;              // query rows a block, 64 a warpgroup
constexpr int BK = 64;               // key rows a tile
constexpr int CONSUMERS = 256;       // two consumer warpgroups
constexpr int THREADS = 384;         // and the producer warpgroup
constexpr float LOG2E = 1.44269504088896341f;

// the tiles and the ring at the head dim padded to DP (blocks an SM and
// registers: sm90.cuh, Occupancy)
template <int DP> struct Fwd {
  static constexpr int STAGES = DP == 256 ? 2 : 4;
  static constexpr uint32_t Q_TILE = BQ * DP * 2;
  static constexpr uint32_t KV_TILE = BK * DP * 2;
  // byte offsets from the 1024-aligned base: Q, then STAGES of K, of V and
  // of the key mask, the barriers q_full, k_full[STAGES], v_full[STAGES],
  // k_empty[STAGES], v_empty[STAGES]
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t K_OFF = Q_TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KV_TILE;
  static constexpr uint32_t MASK_OFF = V_OFF + STAGES * KV_TILE;
  static constexpr uint32_t BAR_OFF = MASK_OFF + STAGES * BK * 4;
  static constexpr size_t SMEM = BAR_OFF + (1 + 4 * STAGES) * 8 + 1024;
  static_assert(SMEM * Occupancy<DP>::BLOCKS <= 232448,
                "forward: shared memory");
};

// 2^x in one instruction (MUFU.EX2): exp2f adds steps that keep results
// below 2^-126 as denormals, while these p and corrections flush them to
// 0, each less than 2^-126 of the row's largest term, which is 1
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Block (x, y, z): query rows [128 x, 128 x + 128) of head y, batch
// z / splits, and the key tiles [s chunk, (s + 1) chunk) with s = z %
// splits. Warpgroup w < 2 takes rows 64 w .. + 63 of the block with its own
// softmax state and O accumulator; warp 8 (the first of warpgroup 2) loads
// the tiles. With `part` null (splits = 1) the block writes out and lse;
// else its partial (m in base-2 units, l, unnormalised O) into `part`
template <int DP>
__global__ void __launch_bounds__(THREADS, Occupancy<DP>::BLOCKS)
flash_attn_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const int32_t* __restrict__ key_mask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           float* __restrict__ part, int H, int Sq, int Sk,
                           int d, int causal, int splits, int chunk,
                           float scale) {
  using C = Fwd<DP>;
  using T = HeadDim<DP>;
  constexpr int S = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = aligned_base(smem_raw);
  unsigned char* smem = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t q_full = base + C::BAR_OFF;
  const uint32_t k_full0 = q_full + 8, v_full0 = k_full0 + 8 * S;
  const uint32_t k_empty0 = v_full0 + 8 * S, v_empty0 = k_empty0 + 8 * S;
  int32_t* mask_s = reinterpret_cast<int32_t*>(smem + C::MASK_OFF);

  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const int bh = b * H + h;
  // this block's key tiles [t0, t0 + count); under causal, none wholly
  // above the diagonal. A split may be left with none: it writes an empty
  // partial
  const int t0 = sp * chunk;
  int t1 = min((Sk + BK - 1) / BK, t0 + chunk);
  if (causal) t1 = min(t1, (min(q0 + BQ, Sq) - 1) / BK + 1);
  const int count = max(t1 - t0, 0);

  if (tid == 256) {                  // the loading warp's first lane
    prefetch_tensormap(&tm_q);
    prefetch_tensormap(&tm_k);
    prefetch_tensormap(&tm_v);
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < S; ++s) {
      mbar_init(k_full0 + 8 * s, 1);
      mbar_init(v_full0 + 8 * s, 1);
      mbar_init(k_empty0 + 8 * s, CONSUMERS);
      mbar_init(v_empty0 + 8 * s, CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wgi = warpgroup(tid);
  if (wgi == 2) {
    // the producer warp: Q once (the 64-row halves that hold rows below
    // Sq), then each key tile's K with its key
    // validity (cp.async, 0 past Sk; the same full barrier waits for both)
    // and its V, each as soon as its stage is free. K and V have barriers
    // of their own: K is free once S is computed, V only after P V
    setmaxnreg_dec<Occupancy<DP>::PRODUCER_REGS>();
    if (warp_of(tid) == 8 && count > 0) {
      if (lane == 0) {
        const int halves = min(2, (Sq - q0 + 63) / 64);
        mbar_arrive_expect_tx(q_full, halves * (C::Q_TILE / 2));
        for (int hh = 0; hh < halves; ++hh)
          for (int r = 0; r < T::REGIONS; ++r)
            tma_load_3d(base + C::Q_OFF + (r * BQ + 64 * hh) * T::SW, &tm_q,
                        q_full, r * T::COLS, q0 + 64 * hh, bh);
      }
      const int32_t* mask_g = key_mask + (size_t)b * Sk;
      for (int i = 0; i < count; ++i) {
        const int st = i % S, k0 = (t0 + i) * BK;
        const uint32_t k_full = k_full0 + 8 * st, v_full = v_full0 + 8 * st;
        if (i >= S) mbar_wait(k_empty0 + 8 * st, (i / S - 1) & 1);
        for (int r = lane; r < BK; r += 32) {
          const bool in = k0 + r < Sk;
          cp_async4(mask_s + st * BK + r, in ? mask_g + k0 + r : mask_g, in);
        }
        cp_async_mbar_arrive(k_full);
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(k_full, C::KV_TILE);
          for (int r = 0; r < T::REGIONS; ++r)
            tma_load_3d(base + C::K_OFF + st * C::KV_TILE + r * BK * T::SW,
                        &tm_k, k_full, r * T::COLS, k0, bh);
        }
        if (i >= S) mbar_wait(v_empty0 + 8 * st, (i / S - 1) & 1);
        if (lane == 0) {
          mbar_arrive_expect_tx(v_full, C::KV_TILE);
          for (int r = 0; r < T::REGIONS; ++r)
            tma_load_3d(base + C::V_OFF + st * C::KV_TILE + r * BK * T::SW,
                        &tm_v, v_full, r * T::COLS, k0, bh);
        }
      }
    }
    return;
  }

  setmaxnreg_inc<Occupancy<DP>::CONSUMER_REGS>();
  const int warp = (tid & 127) >> 5, tig = lane & 3;
  const int wrow0 = q0 + 64 * wgi;   // the warpgroup's first query row
  // the thread's two query rows (those of its accumulator fragments) and,
  // under causal, the last key each may see
  int row[2], lim[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    row[hf] = wrow0 + 16 * warp + (lane >> 2) + 8 * hf;
    lim[hf] = causal ? row[hf] : INT_MAX;
  }
  // the tiles the warpgroup computes, a prefix of the block's: none when
  // its rows all lie past Sq; under causal, none wholly above its last row
  int live = wrow0 < Sq ? count : 0;
  if (causal && live > 0)
    live = max(0, min(count, (min(wrow0 + 64, Sq) - 1) / BK + 1 - t0));
  // logits in base-2 units, s log2(e) / sqrt(d): p = 2^(s2 - m2) is
  // exp(s / sqrt(d) - m) with one exp2f, and m is kept in these units
  const float scale2 = scale * LOG2E;
  const uint32_t q_tile = base + C::Q_OFF;
  float o[DP / 2];                   // O, unnormalised
  float s[BK / 2];                   // S of the tile, then its p
  uint32_t a[BK / 16][4];            // p of the tile before, in bf16
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  // the running row max (base-2 units) and the thread's share of the row
  // sum: the four threads of a row hold the same max, so their shares are
  // added only at the end
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  if (live > 0) mbar_wait(q_full, 0);

  // S = Q K^T of the tile in stage `st`: 64 rows x BK keys over the head
  // dim, both K-major
  auto qk = [&](int st) {
    const uint32_t k_tile = base + C::K_OFF + st * C::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      Wgmma<BK>::template ss<0>(s, T::kmajor(q_tile, BQ, 64 * wgi, kk),
                                T::kmajor(k_tile, BK, 0, kk), kk > 0);
    wgmma_commit();
  };
  // O += P V of the tile in stage `st`, P from `a`, V MN-major
  auto pv = [&](int st) {
    const uint32_t v_tile = base + C::V_OFF + st * C::KV_TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<DP>::template rs<1>(o, a[kk], T::mnmajor(v_tile, BK, kk), 1);
    wgmma_commit();
  };
  // mask (-inf) and the online softmax on S of the tile at key k0 in stage
  // `st`, leaving p in s and the rows' corrections in corr: element 4 j + e
  // is row row[e / 2], key k0 + 8 j + 2 tig + e % 2. The compare by
  // position runs only where the tile crosses the diagonal of the warp's
  // rows. Frees K's stage
  auto mask = [&](const int32_t* valid, int k0, auto by_position,
                  float (&mx)[2]) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int kl = 8 * j + 2 * tig;
      const int2 vm = *reinterpret_cast<const int2*>(valid + kl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hf = e >> 1;
        bool ok = ((e & 1) ? vm.y : vm.x) != 0;
        if (decltype(by_position)::value)
          ok = ok && k0 + kl + (e & 1) <= lim[hf];
        s[4 * j + e] = ok ? s[4 * j + e] : -INFINITY;
        mx[hf] = fmaxf(mx[hf], s[4 * j + e]);
      }
    }
  };
  auto softmax = [&](int st, int k0, float (&corr)[2]) {
    const int32_t* valid = mask_s + st * BK;
    float mx[2] = {-INFINITY, -INFINITY};
    if (causal && k0 + BK - 1 > wrow0 + 16 * warp)
      mask(valid, k0, std::true_type(), mx);
    else
      mask(valid, k0, std::false_type(), mx);
    mbar_arrive(k_empty0 + 8 * st);  // K and the mask are read
    float neg[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const float m_new = fmaxf(m_run[hf], quad_max(mx[hf]) * scale2);
      // a row whose max is still -inf: correction 0 and p 0
      corr[hf] = m_new == -INFINITY ? 0.f : exp2_ftz(m_run[hf] - m_new);
      neg[hf] = m_new == -INFINITY ? 0.f : -m_new;
      m_run[hf] = m_new;
    }
#pragma unroll
    for (int e = 0; e < BK / 2; ++e) {
      const int hf = (e >> 1) & 1;
      const float p = exp2_ftz(fmaf(s[e], scale2, neg[hf]));
      s[e] = p;
      sum[hf] += p;
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) l_run[hf] = corr[hf] * l_run[hf] + sum[hf];
  };
  // once the row maxima stop growing, every correction is 1; then p,
  // rounded to bf16 unnormalised as the Pallas kernel does, becomes the
  // register A operand of O += P V
  auto rescale_and_keep_p = [&](const float (&corr)[2]) {
    if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
      for (int e = 0; e < DP / 2; ++e) o[e] *= corr[(e >> 1) & 1];
    }
    to_a_fragments<BK>(s, a);
  };

  if (live > 0) {
    // the first tile: S alone
    float corr[2];
    mbar_wait(k_full0, 0);
    fence_operands(s);
    wgmma_fence();
    qk(0);
    wgmma_wait<0>();
    fence_operands(s);
    softmax(0, t0 * BK, corr);
    rescale_and_keep_p(corr);
  }
  // each later tile's S = Q K^T is issued with the tile before's P V
  // behind one fence, and its softmax runs while that P V does
  for (int i = 1; i < live; ++i) {
    const int st = i % S, prev = (i - 1) % S;
    float corr[2];
    mbar_wait(k_full0 + 8 * st, (i / S) & 1);
    mbar_wait(v_full0 + 8 * prev, ((i - 1) / S) & 1);
    fence_operands(s);
    fence_operands(o);
    wgmma_fence();
    qk(st);
    pv(prev);
    wgmma_wait<1>();                 // S has landed; P V runs on
    fence_operands(s);
    softmax(st, (t0 + i) * BK, corr);
    wgmma_wait<0>();                 // the tile before's P V
    keep_live(a);
    fence_operands(o);
    mbar_arrive(v_empty0 + 8 * prev);
    rescale_and_keep_p(corr);
  }
  if (live > 0) {                    // the last tile's P V
    const int prev = (live - 1) % S;
    mbar_wait(v_full0 + 8 * prev, ((live - 1) / S) & 1);
    fence_operands(o);
    wgmma_fence();
    pv(prev);
    wgmma_wait<0>();
    keep_live(a);
    fence_operands(o);
    mbar_arrive(v_empty0 + 8 * prev);
  }
  // the block's tiles past the warpgroup's: free their stages
  for (int i = live; i < count; ++i) {
    const int st = i % S;
    const uint32_t parity = (i / S) & 1;
    mbar_wait(k_full0 + 8 * st, parity);
    mbar_arrive(k_empty0 + 8 * st);
    mbar_wait(v_full0 + 8 * st, parity);
    mbar_arrive(v_empty0 + 8 * st);
  }
  if (wrow0 >= Sq) return;

  float l[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) l[hf] = quad_sum(l_run[hf]);
  if (part == nullptr) {
    if (lse != nullptr && tig == 0) {    // empty row: -inf + log(0) = -inf
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        if (row[hf] < Sq)
          lse[(size_t)bh * Sq + row[hf]] = m_run[hf] * LN2 + logf(l[hf]);
    }
    // empty row: l = 0, o = 0, so o (1 / l) = 0 inf = NaN
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      if (row[hf] >= Sq) continue;
      const float inv = 1.f / l[hf];
      bf16* ob = out + ((size_t)bh * Sq + row[hf]) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int c = 8 * j + 2 * tig;
        if (c < d)
          *reinterpret_cast<uint32_t*>(ob + c) = pack_bf16(
              o[4 * j + 2 * hf] * inv, o[4 * j + 2 * hf + 1] * inv);
      }
    }
    return;
  }
  // the partial of split sp: O (splits, B H Sq, d), then m and l (splits,
  // B H Sq) each
  const size_t rows = (size_t)(gridDim.z / splits) * H * Sq;
  const size_t p0 = sp * rows + (size_t)bh * Sq;
  float* pm = part + (size_t)splits * rows * d + p0;
  float* pl = pm + (size_t)splits * rows;
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (row[hf] >= Sq) continue;
    if (tig == 0) pm[row[hf]] = m_run[hf], pl[row[hf]] = l[hf];
    float* po = part + (p0 + row[hf]) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * tig;
      if (c < d)
        *reinterpret_cast<float2*>(po + c) =
            make_float2(o[4 * j + 2 * hf], o[4 * j + 2 * hf + 1]);
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* out, float* lse, float* part,
                   int B, int H, int Sq, int Sk, int d, int causal,
                   int splits, cudaStream_t stream) {
  using C = Fwd<DP>;
  CUtensorMap tq, tk, tv;
  // maps baked into a CUDA graph that captures this launch (sm90.cuh)
  if (!tile_map<DP>(&tq, q, d, Sq, B * H, BQ / 2) ||
      !tile_map<DP>(&tk, k, d, Sk, B * H, BK) ||
      !tile_map<DP>(&tv, v, d, Sk, B * H, BK))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_sm90_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::SMEM);
  if (err != cudaSuccess) return err;
  const int tiles = (Sk + BK - 1) / BK;
  const int chunk = (tiles + splits - 1) / splits;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B * splits);
  flash_attn_fwd_sm90_kernel<DP><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, static_cast<const int32_t*>(key_mask),
      static_cast<bf16*>(out), lse, splits > 1 ? part : nullptr, H, Sq, Sk,
      d, causal, splits, chunk, 1.0f / sqrtf((float)d));
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long rows = (long long)B * H * Sq;
  flash_attn_fwd_combine_kernel<<<(unsigned)((rows + 3) / 4), 128, 0,
                                  stream>>>(part, static_cast<bf16*>(out),
                                            lse, rows, d, splits);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

namespace {

bool valid_dims(int B, int H, int Sq, int Sk, int d) {
  return B > 0 && H > 0 && Sq > 0 && Sk > 0 && d > 0 && d <= MAX_D &&
         d % 8 == 0 && B <= 65535 && H <= 65535;
}

cudaError_t launch_fp32(const void* q, const void* k, const void* v,
                        const void* key_mask, void* out, float* lse,
                        float* part, int B, int H, int Sq, int Sk, int d,
                        int causal, int splits, cudaStream_t s) {
  if (d <= 64)
    return tf32::launch<64>(q, k, v, key_mask, out, lse, part, B, H, Sq, Sk,
                            d, causal, splits, s);
  return tf32::launch<256>(q, k, v, key_mask, out, lse, part, B, H, Sq, Sk, d,
                           causal, splits, s);
}

cudaError_t launch_bf16(const void* q, const void* k, const void* v,
                        const void* key_mask, void* out, float* lse,
                        float* part, int B, int H, int Sq, int Sk, int d,
                        int causal, int splits, cudaStream_t s) {
  if (d <= 32)
    return wg::launch<32>(q, k, v, key_mask, out, lse, part, B, H, Sq, Sk, d,
                          causal, splits, s);
  if (d <= 64)
    return wg::launch<64>(q, k, v, key_mask, out, lse, part, B, H, Sq, Sk, d,
                          causal, splits, s);
  return wg::launch<256>(q, k, v, key_mask, out, lse, part, B, H, Sq, Sk, d,
                         causal, splits, s);
}

}  // namespace

// q: (B, H, Sq, d), k/v: (B, H, Sk, d), out: (B, H, Sq, d), all contiguous,
// 16-byte aligned and of one dtype (is_bf16 ? bfloat16 : float32);
// key_mask: (B, Sk) int32, nonzero = attend; lse: null (no write) or
// (B, H, Sq) float32. The dtype picks the kernel, both on wgmma: three
// TF32 products for fp32 (the head dim padded to 64 or 256; clusters of
// two blocks at 256), bf16 for bf16 (padded to 32, 64 or 256). The tensor
// maps are encoded here, and one that does not encode returns
// cudaErrorInvalidValue. Launches on `stream`,
// allocates nothing, does not synchronise. Returns the cudaError_t of the
// launch (0 = success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int H, int Sq, int Sk, int d, int causal,
                              int is_bf16, void* stream) {
  if (!valid_dims(B, H, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  return (int)(is_bf16 ? launch_bf16 : launch_fp32)(
      q, k, v, key_mask, out, l, nullptr, B, H, Sq, Sk, d, causal, 1, s);
}

// The forward with each row's key loop split over `splits` blocks
// (1 <= splits <= the key tiles, ceil(Sk / 32) in fp32 and ceil(Sk / 64) in
// bf16; B splits <= 65535): the kernel writes each split's partial into
// `part`, fp32 of splits B H Sq (d + 2) floats (O, then m, then l), and
// flash_attn_fwd_combine_kernel, launched right after it on `stream`,
// writes out (in the input's dtype) and lse from them. Arguments otherwise
// as flash_attn_fwd's.
extern "C" int flash_attn_fwd_split(const void* q, const void* k,
                                    const void* v, const void* key_mask,
                                    void* out, void* lse, void* part, int B,
                                    int H, int Sq, int Sk, int d, int causal,
                                    int splits, int is_bf16, void* stream) {
  const int bk = is_bf16 ? wg::BK : tf32::BK;
  if (!valid_dims(B, H, Sq, Sk, d) || part == nullptr || splits < 1 ||
      splits > (Sk + bk - 1) / bk || (long long)B * splits > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)(is_bf16 ? launch_bf16 : launch_fp32)(
      q, k, v, key_mask, out, static_cast<float*>(lse),
      static_cast<float*>(part), B, H, Sq, Sk, d, causal, splits,
      static_cast<cudaStream_t>(stream));
}
