// Threefry-2x32 random bits, bit for bit jax.random's threefry2x32 under
// jax_threefry_partitionable (JAX 0.9), and the dropout the JAX package
// draws from them (bmt_tpu/ops/layers.py, dropout).
//
// Element i of a tensor of random bits, i its flat C-order index in the
// global tensor, is y0 ^ y1 of threefry2x32(key, (i >> 32, i & 0xffffffff)).
// Each thread hashes its elements' own global indices, so a launch that
// covers a block of the global tensor (a data-, sequence- or
// tensor-parallel rank's part) draws exactly that block of the one global
// draw: the block's extent, the global strides and the block's offsets
// come in `Index`.
//
// The key is read from device memory (a CUDA graph replays with the key
// its buffer holds then), and up to kMaxPath words are folded into it
// first, fold_in(key, w) = threefry2x32(key, (0, w)), by thread 0 of each
// block into shared memory: a dropout site's key costs no launch of its
// own.
//
// Kernels:
//   threefry_dropout_kernel<T>: out = x / keep where the low 16 bits are
//     below `threshold`, else 0, in T (fp32 or bf16). The division is IEEE
//     (no fast math): in fp32 x / keep correctly rounded, in bf16 x / keep
//     with keep rounded to bf16 by the caller, computed in fp32 and rounded
//     to bf16 once, as XLA divides bf16. The backward runs it on the
//     gradient.
//   threefry_bits32_kernel: the uint32 bits (the Gumbel draw of sampling).
//
// Both are grid-stride loops of one element a thread an iteration; the
// hash's 20 rounds of add, rotate (__funnelshift_l) and xor make them bound
// by integer throughput, not by memory.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPath = 8;
constexpr int kDims = 4;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;

struct Path {
  uint32_t word[kMaxPath];
  int n;
};

struct Index {
  uint32_t block[kDims];   // the block's extent, leading dims 1
  uint32_t magic[kDims];   // i / block[d] = (umulhi(i, magic) + i) >> shift
  uint32_t shift[kDims];
  uint64_t stride[kDims];  // the global tensor's C-order strides
  uint64_t offset[kDims];  // the block's first index in the global tensor
  int whole;               // the block is the whole tensor: index = i
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

// The key with the path folded in, in shared memory for the block.
__device__ __forceinline__ void derive_key(const uint32_t* key,
                                           const Path& path, uint32_t* sk) {
  if (threadIdx.x == 0) {
    uint32_t k0 = key[0], k1 = key[1];
    for (int i = 0; i < path.n; ++i) {
      uint32_t x0 = 0u, x1 = path.word[i];
      threefry(k0, k1, x0, x1);
      k0 = x0;
      k1 = x1;
    }
    sk[0] = k0;
    sk[1] = k1;
  }
  __syncthreads();
}

// The global flat index of the block's element i (i < 2**31, so the
// divider's add does not wrap).
__device__ __forceinline__ uint64_t global_index(uint32_t i,
                                                 const Index& ix) {
  if (ix.whole) return i;
  uint64_t g = 0;
#pragma unroll
  for (int d = kDims - 1; d >= 0; --d) {
    const uint32_t q = (__umulhi(i, ix.magic[d]) + i) >> ix.shift[d];
    g += (i - q * ix.block[d] + ix.offset[d]) * ix.stride[d];
    i = q;
  }
  return g;
}

__device__ __forceinline__ uint32_t random_bits(uint32_t k0, uint32_t k1,
                                                uint64_t g) {
  uint32_t x0 = static_cast<uint32_t>(g >> 32);
  uint32_t x1 = static_cast<uint32_t>(g);
  threefry(k0, k1, x0, x1);
  return x0 ^ x1;
}

__device__ __forceinline__ float divide(float x, float keep) {
  return __fdiv_rn(x, keep);
}

__device__ __forceinline__ __nv_bfloat16 divide(__nv_bfloat16 x,
                                                float keep) {
  return __float2bfloat16_rn(__fdiv_rn(__bfloat162float(x), keep));
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16_rn(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) threefry_dropout_kernel(
    const T* __restrict__ x, T* __restrict__ out,
    const uint32_t* __restrict__ key, const Path path, const Index ix,
    const uint32_t n, const uint32_t threshold, const float keep) {
  __shared__ uint32_t sk[2];
  derive_key(key, path, sk);
  const uint32_t k0 = sk[0], k1 = sk[1];
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    const uint32_t b = random_bits(k0, k1, global_index(i, ix));
    out[i] = (b & 0xFFFFu) < threshold ? divide(x[i], keep) : zero<T>();
  }
}

__global__ void __launch_bounds__(kThreads) threefry_bits32_kernel(
    uint32_t* __restrict__ out, const uint32_t* __restrict__ key,
    const Path path, const Index ix, const uint32_t n) {
  __shared__ uint32_t sk[2];
  derive_key(key, path, sk);
  const uint32_t k0 = sk[0], k1 = sk[1];
  for (uint32_t i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads)
    out[i] = random_bits(k0, k1, global_index(i, ix));
}

// path: n_path words; index: the block's 4 extents, their 4 divider
// magics and 4 shifts, the 4 global strides, the 4 offsets, then the
// whole-tensor flag (int64 each).
bool make_args(const uint32_t* words, int n_path, const long long* index,
               long long n, Path& path, Index& ix) {
  if (n_path < 0 || n_path > kMaxPath || n <= 0 || n >= (1LL << 31))
    return false;
  for (int i = 0; i < kMaxPath; ++i) path.word[i] = i < n_path ? words[i] : 0u;
  path.n = n_path;
  long long count = 1;
  for (int d = 0; d < kDims; ++d) {
    const long long* at = index + d;
    if (at[0] < 1 || at[0] >= (1LL << 31) || at[kDims] < 1 ||
        at[kDims] >= (1LL << 32) || at[2 * kDims] < 0 ||
        at[2 * kDims] > 31 || at[3 * kDims] < 1 || at[4 * kDims] < 0)
      return false;
    ix.block[d] = static_cast<uint32_t>(at[0]);
    ix.magic[d] = static_cast<uint32_t>(at[kDims]);
    ix.shift[d] = static_cast<uint32_t>(at[2 * kDims]);
    ix.stride[d] = static_cast<uint64_t>(at[3 * kDims]);
    ix.offset[d] = static_cast<uint64_t>(at[4 * kDims]);
    count *= at[0];
  }
  ix.whole = static_cast<int>(index[5 * kDims]);
  return count == n;
}

unsigned grid_for(long long n) {
  const long long blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

extern "C" int threefry_dropout(const void* x, void* out, const void* key,
                                const uint32_t* path_words, int n_path,
                                const long long* index, long long n,
                                uint32_t threshold, float keep, int is_bf16,
                                void* stream) {
  Path path;
  Index ix;
  if (!make_args(path_words, n_path, index, n, path, ix))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* k = static_cast<const uint32_t*>(key);
  const uint32_t count = static_cast<uint32_t>(n);
  if (is_bf16)
    threefry_dropout_kernel<__nv_bfloat16><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<__nv_bfloat16*>(out), k, path, ix, count, threshold,
        keep);
  else
    threefry_dropout_kernel<float><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<float*>(out), k, path, ix,
        count, threshold, keep);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int threefry_bits32(void* out, const void* key,
                               const uint32_t* path_words, int n_path,
                               const long long* index, long long n,
                               void* stream) {
  Path path;
  Index ix;
  if (!make_args(path_words, n_path, index, n, path, ix))
    return static_cast<int>(cudaErrorInvalidValue);
  threefry_bits32_kernel<<<grid_for(n), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(key), path,
      ix, static_cast<uint32_t>(n));
  return static_cast<int>(cudaGetLastError());
}
