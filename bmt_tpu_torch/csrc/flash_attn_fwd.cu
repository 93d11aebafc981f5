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
// Design. One thread block per (query tile, head, batch). The block keeps
// its Q tile in shared memory and loops over key tiles with the
// online-softmax recurrence (running row max m, running row sum l,
// accumulator rescaled by exp(m_old - m_new) whenever the max grows; a row
// whose max is still -inf gets correction 0 and p 0). With `causal`, key
// tiles wholly above the diagonal are never loaded. Key rows >= Sk are
// masked and their V rows are loaded as 0, so they never enter the sum.
// The input's dtype picks one of two tensor-core kernels:
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
// train steps): tensor cores in TF32, three products per product
// ("3xTF32", csrc/mma_tf32.cuh), so the result is as accurate as fp32 FMA:
// one TF32 product misses the fp32 tolerances (tests/test_torch_port_tf32.py).
// What bounds it on this card: three m16n8k8 products per fp32 product make
// the peak 495 / 3 = 165 TFLOP/s; the app's caption batch (B=100, H=4,
// 512x512, d=256) moves 128 FLOP per byte against the 49 at which that
// peak and HBM's 3.35 TB/s cross, so it is bound by operations (107.4
// GFLOP, 0.651 ms), and so are the B=1 proposal calls but 300x300. Before
// the tensor cores come the instructions around them: every operand is
// split in registers when its fragment loads (hi = rna(x), lo = rna(x -
// hi): five instructions for each value a warp reads). rna is two integer
// instructions with the bits of cvt.rna.tf32.f32: cvt itself runs on the
// conversion unit at 16 results a clock an SM, and with two a split it set
// the kernel's time (PERF.md, section 6). The design, with what registers
// allow:
// - BQ = 64 query rows a block and BK = 32-key tiles, 8 warps: warp w takes
//   rows 16 (w % 4) .. + 15 against keys 16 (w / 4) .. + 15 of every key
//   tile, with its own online softmax state; at the end the second key
//   half's warps hand (m, l, O) to the first half's through shared memory,
//   which joins them as the split's combine does. The O accumulator is
//   16 x 256 fp32 a warp (128 registers a thread), so a block of 4 warps,
//   one a row slice, was the most that fit; that first design ran 1.25-1.6x
//   slower with one warp for each of an SM's four schedulers.
// - Q K^T: the A fragment of Q and the B fragments of K by ldmatrix.x4 on
//   the fp32 tiles (one instruction fills four fp32 fragment registers),
//   loaded one k-step ahead of their products; lo hi, hi lo and hi hi into
//   three fp32 accumulators, so no mma waits on the one just before it,
//   summed (lh + hl) + hh.
// - P stays in registers and is not rounded (the Pallas kernel casts p to
//   v's dtype, fp32 here): the S accumulator gives lane (group, tig) keys
//   2 tig and 2 tig + 1, and the A fragment wants k = tig and tig + 4. P V
//   sums over keys, so the k index is mapped to keys in that order on both
//   sides: the B fragment's k = tig reads V's row 2 tig, k = tig + 4 row
//   2 tig + 1 (scalar reads, free of bank conflicts at the padded stride).
//   The products run in groups of four 8-column tiles of O, product by
//   product.
// - Rows padded by 4 floats (16 bytes). Q, K, V and the key validity arrive
//   by 16- and 4-byte cp.async copies, K/V in a ring of two stages, so tile
//   t + 1 loads while tile t computes.
// - The softmax on the fragments: quad shuffles, base-2 units, no
//   rescale while no row maximum grows.
// - Head dim padded to DP = 64 or 256. At DP = 256 shared memory
//   is 199,936 bytes (Q 66,560, each K or V stage 33,280): one block an SM.
//   ptxas -v (sm_90a, CUDA 12.8): 244 registers (144 at DP = 64), no spills.
// - Key split: B H ceil(Sq / 64) blocks fill 132 SMs only from B ~ 3 at the
//   proposal shapes (B=1, H=4: 52 blocks at 800 query rows, 20 at 300). The
//   wrapper (ops/flash_attention.py, `fp32_key_splits`) then splits each
//   row's key loop over splits = min(key tiles, SMs // blocks) blocks,
//   cut to ceil(tiles / ceil(tiles / splits)) so no split is empty, which
//   makes at most one wave. Each split writes its (m, l, unnormalised O) to
//   fp32 scratch that the wrapper allocates; flash_attn_fwd_combine_kernel
//   weighs the partials by exp2(m_s - max m) in split order and writes out
//   and lse. No atomics: the same bits in every run.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v (bmt_tpu_torch/ops/_build.py). No
// fast-math: the empty-row NaN relies on IEEE 0/0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"
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
// fp32: tensor cores in TF32, three products (mma.sync m16n8k8), cp.async
// tiles, optional key split with a combine kernel
// ---------------------------------------------------------------------------

namespace tf32 {

using namespace mma_tf32;
using mma_bf16::cp_async4;
using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::quad_max;
using mma_bf16::quad_sum;

constexpr int BQ = 64;               // query rows per block, 16 per warp
constexpr int BK = 32;               // key rows per tile, 16 per warp
constexpr int THREADS = 256;         // 8 warps: 4 row slices x 2 key halves
constexpr int NG = 4;                // O column tiles per group of P V products

// Q tile, two stages of K and V tiles (head dim padded to DP), two stages
// of the tile's key validity
template <int DP> constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * pad_f32(DP) * sizeof(float) +
         2 * BK * sizeof(int32_t);
}

// DP: the head dim the tiles are padded to (a multiple of 32, >= d).
// Block (x, y, z) takes query tile x of head y, batch z / splits, and the
// key tiles [s chunk, (s + 1) chunk) with s = z % splits. Warp w takes the
// tile's rows 16 (w % 4) .. + 15 against key half w / 4 of every key tile,
// with its own softmax state; at the end the two halves of each row are
// joined through shared memory. With `part` null (splits = 1) the block
// writes out and lse; else its partial (m in base-2 units, l, unnormalised
// O) into `part` (see flash_attn_fwd_split).
template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_attn_fwd_tf32_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const int32_t* __restrict__ key_mask,
                           float* __restrict__ out, float* __restrict__ lse,
                           float* __restrict__ part, int H, int Sq, int Sk,
                           int d, int causal, int splits, int chunk,
                           float scale) {
  constexpr int LD = pad_f32(DP);
  constexpr int NS = 2;              // 8-key tiles of S: the warp's 16 keys
  constexpr int NO = DP / 8;         // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qs = reinterpret_cast<float*>(smem_raw);                  // BQ x LD
  float* Ks = Qs + BQ * LD;                                         // 2 x BK x LD
  float* Vs = Ks + 2 * BK * LD;                                     // 2 x BK x LD
  int32_t* valid_s = reinterpret_cast<int32_t*>(Vs + 2 * BK * LD);  // 2 x BK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z / splits, sp = blockIdx.z % splits;
  const size_t bh = (size_t)b * H + h;
  const float* kb = k + bh * Sk * d;
  const float* vb = v + bh * Sk * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  // this block's key tiles [t0, t1); under causal, none wholly above the
  // diagonal. A split may be left with none: it writes an empty partial
  const int t0 = sp * chunk;
  int t1 = min((Sk + BK - 1) / BK, t0 + chunk);
  if (causal) t1 = min(t1, (min(q0 + BQ, Sq) - 1) / BK + 1);

  // key tile t into stage (t - t0) & 1: K, V rows (0 past Sk), validity
  auto load_kv = [&](int t) {
    const int k0 = t * BK, st = (t - t0) & 1;
    load_rows_async<DP, THREADS>(Ks + st * BK * LD, kb, k0, BK, Sk, d, tid);
    load_rows_async<DP, THREADS>(Vs + st * BK * LD, vb, k0, BK, Sk, d, tid);
    if (tid < BK) {
      const bool in = k0 + tid < Sk;
      cp_async4(valid_s + st * BK + tid, in ? mb + k0 + tid : mb, in);
    }
  };
  if (t0 < t1) {
    load_rows_async<DP, THREADS>(Qs, q + bh * Sq * d, q0, BQ, Sq, d, tid);
    load_kv(t0);
  }
  cp_async_commit();

  const int m0 = (warp & 3) * 16;    // the warp's rows within the Q tile
  const int kw = (warp >> 2) * 16;   // its keys within each key tile
  const int row0 = q0 + m0 + group;  // this thread's two query rows
  const int row1 = row0 + 8;
  // logits in base-2 units, s log2(e) / sqrt(d), as in the bf16 kernel
  const float scale2 = scale * 1.44269504088896341f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = t0; t < t1; ++t) {
    if (t + 1 < t1) load_kv(t + 1);        // overlaps this tile's products
    cp_async_commit();
    cp_async_wait<1>();                    // Q and tile t have landed
    __syncthreads();
    const int k0 = t * BK + kw, st = (t - t0) & 1;  // the warp's first key
    const float* Kt = Ks + (st * BK + kw) * LD;
    const float* Vt = Vs + (st * BK + kw) * LD;
    const int32_t* vt = valid_s + st * BK + kw;
    // warp-uniform skip: the warp's rows all lie past Sq, or (causal) all
    // its keys lie above them; the state is then unchanged
    if (q0 + m0 < Sq && !(causal && k0 > q0 + m0 + 15)) {
      // S = Q K^T, 16 rows x 16 keys, 3xTF32: lo hi, hi lo and hi hi in
      // three accumulators, so that consecutive products never feed one
      // another, summed small terms first. The fragments of k-step kk + 1
      // are loaded before the products of step kk
      float s[NS][4], slh[NS][4], shl[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = slh[j][e] = shl[j][e] = 0.f;
      uint32_t fq[2][4], fk[2][4];
      ldmatrix_x4(fq[0], frag_a(Qs, LD, m0, 0, lane));
      ldmatrix_x4(fk[0], frag_b_nk(Kt, LD, 0, 0, lane));
#pragma unroll
      for (int kk = 0; kk < DP / 8; ++kk) {
        const int cur = kk & 1;
        if (kk + 1 < DP / 8) {
          ldmatrix_x4(fq[cur ^ 1], frag_a(Qs, LD, m0, kk * 8 + 8, lane));
          ldmatrix_x4(fk[cur ^ 1], frag_b_nk(Kt, LD, 0, kk * 8 + 8, lane));
        }
        uint32_t ah[4], al[4], bhi[NS][2], blo[NS][2];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split(fq[cur][i], ah[i], al[i]);
          split(fk[cur][i], bhi[i >> 1][i & 1], blo[i >> 1][i & 1]);
        }
#pragma unroll
        for (int j = 0; j < NS; ++j) mma(slh[j], al, bhi[j][0], bhi[j][1]);
#pragma unroll
        for (int j = 0; j < NS; ++j) mma(shl[j], ah, blo[j][0], blo[j][1]);
#pragma unroll
        for (int j = 0; j < NS; ++j) mma(s[j], ah, bhi[j][0], bhi[j][1]);
      }
      // scale (to base-2 units) and mask (-inf), then the online softmax
      // on the fragments: element e of s[j] is row e < 2 ? row0 : row1, key
      // k0 + j 8 + 2 tig + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * tig + (e & 1);
          const bool ok =
              vt[c] != 0 && (!causal || k0 + c <= (e < 2 ? row0 : row1));
          const float x = (slh[j][e] + shl[j][e]) + s[j][e];
          s[j][e] = ok ? x * scale2 : -INFINITY;
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      }
      float corr[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m_run[r], quad_max(mx[r]));
        // a row whose max is still -inf: correction 0 and p 0
        corr[r] = m_new == -INFINITY ? 0.f : exp2f(m_run[r] - m_new);
        m_run[r] = m_new;
      }
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mr = m_run[e >> 1];
          const float p = mr == -INFINITY ? 0.f : exp2f(s[j][e] - mr);
          s[j][e] = p;
          sum[e >> 1] += p;
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
        l_run[r] = corr[r] * l_run[r] + quad_sum(sum[r]);
      // once the row maxima stop growing, every correction is 1
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          o[n][0] *= corr[0];
          o[n][1] *= corr[0];
          o[n][2] *= corr[1];
          o[n][3] *= corr[1];
        }
      }
      // O += P V, 3xTF32, p in fp32. Step kk takes the warp's keys
      // 8 kk .. 8 kk + 7 with k = tig <-> key 2 tig and k = tig + 4 <->
      // key 2 tig + 1: the A fragment is s[kk] as it stands (a0..a3 = c0,
      // c2, c1, c3) and the B fragment reads V's rows 2 tig and 2 tig + 1
#pragma unroll
      for (int kk = 0; kk < NS; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[kk][0], ph[0], pl[0]);
        split(s[kk][2], ph[1], pl[1]);
        split(s[kk][1], ph[2], pl[2]);
        split(s[kk][3], ph[3], pl[3]);
        const float* v0 = Vt + (kk * 8 + 2 * tig) * LD + group;
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += NG) {
          uint32_t vh[NG][2], vl[NG][2];
#pragma unroll
          for (int g = 0; g < NG; ++g) {
            split(v0[(n0 + g) * 8], vh[g][0], vl[g][0]);
            split(v0[LD + (n0 + g) * 8], vh[g][1], vl[g][1]);
          }
#pragma unroll
          for (int g = 0; g < NG; ++g) mma(o[n0 + g], pl, vh[g][0], vh[g][1]);
#pragma unroll
          for (int g = 0; g < NG; ++g) mma(o[n0 + g], ph, vl[g][0], vl[g][1]);
#pragma unroll
          for (int g = 0; g < NG; ++g) mma(o[n0 + g], ph, vh[g][0], vh[g][1]);
        }
      }
    }
    __syncthreads();   // every read of this stage is done before its refill
  }
  cp_async_wait<0>();

  // join the key halves: the second half's warps hand their (m, l, O) to
  // the first half's through the K stages' memory (BQ x LD floats), which
  // no warp reads any more
  float* Oh = Ks;
  float* ml = Vs;                    // BQ maxima, then BQ sums
  const int r0 = m0 + group, r1 = r0 + 8;
  if (kw != 0) {
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(Oh + r0 * LD + c) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(Oh + r1 * LD + c) =
          make_float2(o[n][2], o[n][3]);
    }
    if (tig == 0) {
      ml[r0] = m_run[0], ml[r1] = m_run[1];
      ml[BQ + r0] = l_run[0], ml[BQ + r1] = l_run[1];
    }
  }
  __syncthreads();
  if (kw != 0 || q0 + m0 >= Sq) return;
  float w[2], wh[2];                 // weights of this half and the other
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = r ? r1 : r0;
    const float mh = ml[rr], m_new = fmaxf(m_run[r], mh);
    w[r] = m_run[r] == -INFINITY ? 0.f : exp2f(m_run[r] - m_new);
    wh[r] = mh == -INFINITY ? 0.f : exp2f(mh - m_new);
    l_run[r] = w[r] * l_run[r] + wh[r] * ml[BQ + rr];
    m_run[r] = m_new;
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tig;
    const float2 x0 = *reinterpret_cast<const float2*>(Oh + r0 * LD + c);
    const float2 x1 = *reinterpret_cast<const float2*>(Oh + r1 * LD + c);
    o[n][0] = w[0] * o[n][0] + wh[0] * x0.x;
    o[n][1] = w[0] * o[n][1] + wh[0] * x0.y;
    o[n][2] = w[1] * o[n][2] + wh[1] * x1.x;
    o[n][3] = w[1] * o[n][3] + wh[1] * x1.y;
  }

  if (part == nullptr) {
    if (lse != nullptr && tig == 0) {  // empty row: -inf + log(0) = -inf
      if (row0 < Sq) lse[bh * Sq + row0] = m_run[0] * LN2 + logf(l_run[0]);
      if (row1 < Sq) lse[bh * Sq + row1] = m_run[1] * LN2 + logf(l_run[1]);
    }
    float* ob = out + bh * Sq * d;
    // empty row: l = 0, o = 0, so o (1 / l) = 0 inf = NaN
    const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = n * 8 + 2 * tig;
      if (c >= d) continue;
      if (row0 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row0 * d + c) =
            make_float2(o[n][0] * inv0, o[n][1] * inv0);
      if (row1 < Sq)
        *reinterpret_cast<float2*>(ob + (size_t)row1 * d + c) =
            make_float2(o[n][2] * inv1, o[n][3] * inv1);
    }
    return;
  }
  // the partial of split sp: O (splits, B H Sq, d), then m and l (splits,
  // B H Sq) each
  const size_t rows = (size_t)(gridDim.z / splits) * H * Sq;
  const size_t p0 = sp * rows + bh * Sq;
  float* po = part + p0 * d;
  float* pm = part + (size_t)splits * rows * d + p0;
  float* pl = pm + (size_t)splits * rows;
  if (tig == 0) {
    if (row0 < Sq) pm[row0] = m_run[0], pl[row0] = l_run[0];
    if (row1 < Sq) pm[row1] = m_run[1], pl[row1] = l_run[1];
  }
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tig;
    if (c >= d) continue;
    if (row0 < Sq)
      *reinterpret_cast<float2*>(po + (size_t)row0 * d + c) =
          make_float2(o[n][0], o[n][1]);
    if (row1 < Sq)
      *reinterpret_cast<float2*>(po + (size_t)row1 * d + c) =
          make_float2(o[n][2], o[n][3]);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* out, float* lse, float* part,
                   int B, int H, int Sq, int Sk, int d, int causal,
                   int splits, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_tf32_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (Sk + BK - 1) / BK;
  const int chunk = (tiles + splits - 1) / splits;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B * splits);
  flash_attn_fwd_tf32_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<float*>(out), lse, splits > 1 ? part : nullptr, H, Sq, Sk,
      d, causal, splits, chunk, 1.0f / sqrtf((float)d));
  err = cudaGetLastError();
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
// (B, H, Sq) float32. The dtype picks the kernel, both on tensor cores:
// 3xTF32 for fp32 (the head dim padded to 64 or 256), wgmma for bf16
// (padded to 32, 64 or 256; its tensor maps are encoded here, and one that
// does not encode returns cudaErrorInvalidValue). Launches on `stream`,
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
