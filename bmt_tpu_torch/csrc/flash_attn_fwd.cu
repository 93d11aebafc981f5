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
// The input's dtype picks one of two tensor-core kernels of this design:
//
// bf16 (the serving and training path): tensor cores. What bounds it on
// this card: the call moves 128 FLOP per byte at d = 256 against the H100's
// 295, so its bound is HBM (67.3 MB, 0.0201 ms at the train cell's
// B=32, S=256 call), but mma.sync feeds the tensor cores from registers, so
// every product also costs ldmatrix traffic from shared memory and issue
// slots. The design: BQ = 64 query rows per block, 16 per warp (4 warps);
// both products on mma.sync m16n8k16 (bf16 in, fp32 accumulators in
// registers); fragments by ldmatrix (.trans for V) from tiles whose rows are
// padded by 16 bytes, so the reads are free of bank conflicts; Q, K and V
// arrive by 16-byte cp.async copies, K/V in a ring of two BK = 32-row
// stages, so tile t + 1 loads while tile t computes; the softmax runs on
// the S fragments in registers (row max and sum across the 4 lanes of a
// quad by shuffles, no round trip through shared memory), in base-2 units
// with exp2f, and skips the accumulator's rescale while no row maximum
// grows; p is rounded to bf16 unnormalized for P V, as the Pallas kernel
// does. The head dim is padded to DP = 64 or 256 (a template parameter; the
// padded columns load as 0 and are not stored), so d need only be a
// multiple of 8. At DP = 256 the O accumulator is 16 x 256 fp32 a warp, 128
// registers a thread: ptxas -v (sm_90a, CUDA 12.8) gives 244 registers (123
// at DP = 64), no spills, and 101,632 bytes of
// dynamic shared memory, so two blocks share an SM and overlap each other's loads
// and barriers. Measured in PERF.md; wgmma and TMA, the only route to the
// card's full tensor-core rate, are later work.
//
// fp32 (the single-video app, whose checkpoints are fp32, and the fp32
// parity checks): tensor cores in TF32, three products per product
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
// the kernel's time (PERF.md, section 6). The design, that of the bf16
// kernel in fp32, with what registers allow:
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
// - The softmax is the bf16 kernel's (fragments, quad shuffles, base-2
//   units, no rescale while no row maximum grows).
// - Head dim padded to DP = 64 or 256 as in bf16. At DP = 256 shared memory
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
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int MAX_D = 256;

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
constexpr float LN2 = 0.693147180559945309f;

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

// out and lse of `rows` = B H Sq rows from `splits` partials: one warp a
// row; weights w_s = exp2(m_s - max m) (0 for an empty partial), l = sum
// w_s l_s, out = sum w_s O_s / l, lse = max m ln 2 + log l, summed in split
// order. A row empty in every split: l = 0, O = 0, so out is NaN and lse
// -inf, as without the split.
__global__ void __launch_bounds__(128)
flash_attn_fwd_combine_kernel(const float* __restrict__ part,
                              float* __restrict__ out,
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
    *reinterpret_cast<float4*>(out + row * d + c) =
        make_float4(acc.x * inv, acc.y * inv, acc.z * inv, acc.w * inv);
  }
  if (lse != nullptr && lane == 0) lse[row] = m * LN2 + logf(l);
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
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulators), cp.async tiles
// ---------------------------------------------------------------------------

namespace tc {

using namespace mma_bf16;

constexpr int BQ = 64;               // query rows per block, 16 per warp
constexpr int BK = 32;               // key rows per tile
constexpr int THREADS = 2 * BQ;      // 4 warps

// Q tile, two stages of K and V tiles (head dim padded to DP), two stages
// of the tile's key validity
template <int DP> constexpr size_t smem_bytes() {
  return (size_t)(BQ + 4 * BK) * pad_row(DP) * sizeof(bf16) +
         2 * BK * sizeof(int32_t);
}

// DP: the head dim the tiles are padded to (a multiple of 64, >= d); the
// padded columns load as 0 and are not stored
template <int DP>
__global__ void __launch_bounds__(THREADS, 2)
flash_attn_fwd_bf16_kernel(const bf16* __restrict__ q,
                           const bf16* __restrict__ k,
                           const bf16* __restrict__ v,
                           const int32_t* __restrict__ key_mask,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int H, int Sq, int Sk, int d, int causal,
                           float scale) {
  constexpr int LD = pad_row(DP);
  constexpr int NS = BK / 8;         // 8-wide key tiles of S
  constexpr int NO = DP / 8;         // 8-wide column tiles of O
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);              // BQ x LD
  bf16* Ks = Qs + BQ * LD;                                    // 2 x BK x LD
  bf16* Vs = Ks + 2 * BK * LD;                                // 2 x BK x LD
  int32_t* valid_s = reinterpret_cast<int32_t*>(Vs + 2 * BK * LD);  // 2 x BK

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int group = lane >> 2, tig = lane & 3;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const bf16* kb = k + bh * Sk * d;
  const bf16* vb = v + bh * Sk * d;
  const int32_t* mb = key_mask + (size_t)b * Sk;

  int n_tiles = (Sk + BK - 1) / BK;
  if (causal) n_tiles = min(n_tiles, (min(q0 + BQ, Sq) - 1) / BK + 1);

  // key tile t into stage t & 1: K, V rows (0 past Sk) and key validity
  auto load_kv = [&](int t) {
    const int k0 = t * BK, st = t & 1;
    load_rows_async<DP, THREADS>(Ks + st * BK * LD, kb, k0, BK, Sk, d, tid);
    load_rows_async<DP, THREADS>(Vs + st * BK * LD, vb, k0, BK, Sk, d, tid);
    if (tid < BK) {
      const bool in = k0 + tid < Sk;
      cp_async4(valid_s + st * BK + tid, in ? mb + k0 + tid : mb, in);
    }
  };
  load_rows_async<DP, THREADS>(Qs, q + bh * Sq * d, q0, BQ, Sq, d, tid);
  load_kv(0);
  cp_async_commit();

  const int m0 = warp * 16;          // the warp's rows within the Q tile
  const int row0 = q0 + m0 + group;  // this thread's two query rows
  const int row1 = row0 + 8;
  // logits in base-2 units, s log2(e) / sqrt(d): p = 2^(s2 - m2) is
  // exp(s / sqrt(d) - m) with one exp2f, and m is kept in these units
  const float scale2 = scale * 1.44269504088896341f;
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) load_kv(t + 1);   // overlaps this tile's products
    cp_async_commit();
    cp_async_wait<1>();                    // Q and tile t have landed
    __syncthreads();
    const int k0 = t * BK;
    const bf16* Kt = Ks + (t & 1) * BK * LD;
    const bf16* Vt = Vs + (t & 1) * BK * LD;
    const int32_t* vt = valid_s + (t & 1) * BK;
    // warp-uniform skip: the warp's rows all lie past Sq, or (causal) every
    // key of the tile lies above them; the state is then unchanged
    if (q0 + m0 < Sq && !(causal && k0 > q0 + m0 + 15)) {
      // S = Q K^T, 16 rows x BK keys. The fragments of step kk + 1 are
      // loaded before the products of step kk, so no mma waits on the
      // ldmatrix just before it (the warp issues in order)
      float s[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      uint32_t fq[2][4], fk[2][NS / 2][4];
      ldmatrix_x4(fq[0], frag_a(Qs, LD, m0, 0, lane));
#pragma unroll
      for (int j = 0; j < NS / 2; ++j)
        ldmatrix_x4(fk[0][j], frag_b_nk(Kt, LD, j * 16, 0, lane));
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        const int cur = kk & 1;
        if (kk + 1 < DP / 16) {
          ldmatrix_x4(fq[cur ^ 1], frag_a(Qs, LD, m0, kk * 16 + 16, lane));
#pragma unroll
          for (int j = 0; j < NS / 2; ++j)
            ldmatrix_x4(fk[cur ^ 1][j],
                        frag_b_nk(Kt, LD, j * 16, kk * 16 + 16, lane));
        }
#pragma unroll
        for (int j = 0; j < NS / 2; ++j) {
          mma(s[2 * j], fq[cur], fk[cur][j][0], fk[cur][j][1]);
          mma(s[2 * j + 1], fq[cur], fk[cur][j][2], fk[cur][j][3]);
        }
      }
      // scale (to base-2 units) and mask (-inf), then the online softmax
      // on the fragments: element e of s[j] is row e < 2 ? row0 : row1, key
      // j 8 + 2 tig + e % 2
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NS; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = j * 8 + 2 * tig + (e & 1);
          const bool ok =
              vt[c] != 0 && (!causal || k0 + c <= (e < 2 ? row0 : row1));
          s[j][e] = ok ? s[j][e] * scale2 : -INFINITY;
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
      // O += P V, p rounded to bf16 unnormalized: the S fragments of two
      // key tiles are the A fragment of one 16-key step. V's fragments are
      // loaded two column pairs ahead of their products
      constexpr int NP = NO / 2;           // column-tile pairs of O
      constexpr int STEPS = BK / 16 * NP;  // (key step, pair) in order
      uint32_t fv[3][4];
      ldmatrix_x4_trans(fv[0], frag_b_kn(Vt, LD, 0, 0, lane));
      ldmatrix_x4_trans(fv[1], frag_b_kn(Vt, LD, (1 % NP) * 16,
                                         (1 / NP) * 16, lane));
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        const uint32_t a[4] = {pack(s[2 * kk][0], s[2 * kk][1]),
                               pack(s[2 * kk][2], s[2 * kk][3]),
                               pack(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          const int i = kk * NP + np;
          if (i + 2 < STEPS)
            ldmatrix_x4_trans(fv[(i + 2) % 3],
                              frag_b_kn(Vt, LD, (i + 2) % NP * 16,
                                        (i + 2) / NP * 16, lane));
          mma(o[2 * np], a, fv[i % 3][0], fv[i % 3][1]);
          mma(o[2 * np + 1], a, fv[i % 3][2], fv[i % 3][3]);
        }
      }
    }
    __syncthreads();   // every read of this stage is done before its refill
  }

  if (q0 + m0 >= Sq) return;
  if (lse != nullptr && tig == 0) {    // empty row: -inf + log(0) = -inf
    constexpr float LN2 = 0.693147180559945309f;
    if (row0 < Sq) lse[bh * Sq + row0] = m_run[0] * LN2 + logf(l_run[0]);
    if (row1 < Sq) lse[bh * Sq + row1] = m_run[1] * LN2 + logf(l_run[1]);
  }
  bf16* ob = out + bh * Sq * d;
  // empty row: l = 0, o = 0, so o (1 / l) = 0 inf = NaN
  const float inv0 = 1.f / l_run[0], inv1 = 1.f / l_run[1];
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    const int c = n * 8 + 2 * tig;
    if (c >= d) continue;
    if (row0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row0 * d + c) =
          pack(o[n][0] * inv0, o[n][1] * inv0);
    if (row1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + (size_t)row1 * d + c) =
          pack(o[n][2] * inv1, o[n][3] * inv1);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* key_mask, void* out, float* lse, int B, int H,
                   int Sq, int Sk, int d, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_attn_fwd_bf16_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_attn_fwd_bf16_kernel<DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const int32_t*>(key_mask),
      static_cast<bf16*>(out), lse, H, Sq, Sk, d, causal,
      1.0f / sqrtf((float)d));
  return cudaGetLastError();
}

}  // namespace tc

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

}  // namespace

// q: (B, H, Sq, d), k/v: (B, H, Sk, d), out: (B, H, Sq, d), all contiguous,
// 16-byte aligned and of one dtype (is_bf16 ? bfloat16 : float32);
// key_mask: (B, Sk) int32, nonzero = attend; lse: null (no write) or
// (B, H, Sq) float32. The dtype picks the kernel, both on tensor cores with
// the head dim padded to 64 or 256: 3xTF32 for fp32, bf16 for bf16.
// Launches on `stream`, allocates nothing, does not synchronise. Returns the
// cudaError_t of the launch (0 = success).
extern "C" int flash_attn_fwd(const void* q, const void* k, const void* v,
                              const void* key_mask, void* out, void* lse,
                              int B, int H, int Sq, int Sk, int d, int causal,
                              int is_bf16, void* stream) {
  if (!valid_dims(B, H, Sq, Sk, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (!is_bf16)
    return (int)launch_fp32(q, k, v, key_mask, out, l, nullptr, B, H, Sq, Sk,
                            d, causal, 1, s);
  if (d <= 64)
    return (int)tc::launch<64>(q, k, v, key_mask, out, l, B, H, Sq, Sk, d,
                               causal, s);
  return (int)tc::launch<256>(q, k, v, key_mask, out, l, B, H, Sq, Sk, d,
                              causal, s);
}

// The fp32 forward with each row's key loop split over `splits` blocks
// (1 <= splits <= ceil(Sk / 32), B splits <= 65535): the TF32 kernel writes
// each split's partial into `part`, fp32 of splits B H Sq (d + 2) floats
// (O, then m, then l), and flash_attn_fwd_combine_kernel, launched right
// after it on `stream`, writes out and lse from them. Arguments otherwise as
// flash_attn_fwd's; is_bf16 must be 0.
extern "C" int flash_attn_fwd_split(const void* q, const void* k,
                                    const void* v, const void* key_mask,
                                    void* out, void* lse, void* part, int B,
                                    int H, int Sq, int Sk, int d, int causal,
                                    int splits, int is_bf16, void* stream) {
  if (!valid_dims(B, H, Sq, Sk, d) || is_bf16 || part == nullptr ||
      splits < 1 || splits > (Sk + tf32::BK - 1) / tf32::BK ||
      (long long)B * splits > 65535)
    return (int)cudaErrorInvalidValue;
  return (int)launch_fp32(q, k, v, key_mask, out, static_cast<float*>(lse),
                          static_cast<float*>(part), B, H, Sq, Sk, d, causal,
                          splits, static_cast<cudaStream_t>(stream));
}
