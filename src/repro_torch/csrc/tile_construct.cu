// Kernel B5: training-time tile construction from the master weight.
//
// Replaces the Pallas TPU kernel repro/kernels/tile_construct.py:48
// `tile_construct_pallas` (body `_construct_kernel`).
//
//   w       (p, q) f32 or bf16, row-major, q % 32 == 0 (the wrapper pads)
//   a       (p, q) like w, the alpha source A, or null when A is W
//   packed  (q / 32,) int32: bit j of word c is [sum_i w[i, 32c + j] > 0]
//   alpha   (p,) f32: sum_k |a[i, k]| / q
//
// What bounds it on an H100: memory. Each element of W (and of A when it
// is a separate tensor) is read once and takes one add and one |.|; the
// outputs are q/8 bytes of tile bits and p floats. At granite-8b's width
// one call reads 8-800 MB of f32 masters, so the floor is that read at
// 3.35 TB/s.
//
// Design: a block owns 2048 consecutive columns, 8 per thread, strided so
// that each warp reads 32 consecutive columns (one 128-byte line of a row)
// at a time. Every lane sums its column over the p replicas in the fixed
// order i = 0..p-1 in f32, so the sign is reproducible: a column sum
// within an ulp of zero must not flip with the order, and the plain
// version adds in the same order. `__ballot_sync(s > 0)` then is the
// packed word itself, lane j -> bit j (the reference's bit order). The
// |A| sums of one tile row are reduced per block in a fixed order (warp
// shuffle, then the warps' partials in turn) into a (blocks, p) scratch
// array, and a second kernel adds the blocks' partials in a fixed order:
// no float atomics, so alpha is deterministic. With A = W each element is
// read once for both outputs (the Pallas kernel reads it twice).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerThread = 8;
constexpr int kColsPerBlock = kThreads * kColsPerThread;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, bool kSeparateA>
__global__ void __launch_bounds__(kThreads)
construct_kernel(const T* __restrict__ w, const T* __restrict__ a,
                 uint32_t* __restrict__ packed, float* __restrict__ partial,
                 int p, long long q) {
  __shared__ float warp_l1[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long first = (long long)blockIdx.x * kColsPerBlock + threadIdx.x;
  float s[kColsPerThread];
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) s[j] = 0.f;

  for (int i = 0; i < p; ++i) {
    const T* wi = w + (size_t)i * q;
    const T* ai = kSeparateA ? a + (size_t)i * q : wi;
    float l1 = 0.f;
#pragma unroll
    for (int j = 0; j < kColsPerThread; ++j) {
      const long long c = first + (long long)j * kThreads;
      if (c < q) {  // warp-uniform: q % 32 == 0 and a warp's 32 columns are aligned
        const float v = to_f32(wi[c]);
        s[j] += v;
        l1 += fabsf(kSeparateA ? to_f32(ai[c]) : v);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    if (lane == 0) warp_l1[warp] = l1;
    __syncthreads();
    if (threadIdx.x == 0) {
      float t = 0.f;
#pragma unroll
      for (int k = 0; k < kWarps; ++k) t += warp_l1[k];
      partial[(size_t)blockIdx.x * p + i] = t;
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kColsPerThread; ++j) {
    const long long c0 = (long long)blockIdx.x * kColsPerBlock + (long long)j * kThreads +
                         warp * 32;
    if (c0 < q) {
      const uint32_t bits = __ballot_sync(0xffffffffu, s[j] > 0.f);
      if (lane == 0) packed[c0 / 32] = bits;
    }
  }
}

// alpha[i] = (sum over blocks of partial[b, i]) / q, one warp per tile row,
// lanes striding over the blocks, then a fixed shuffle tree.
__global__ void __launch_bounds__(kThreads)
alpha_kernel(const float* __restrict__ partial, float* __restrict__ alpha, int p,
             int blocks, long long q) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= p) return;  // warp-uniform
  float t = 0.f;
  for (int b = lane; b < blocks; b += 32) t += partial[(size_t)b * p + i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  if (lane == 0) alpha[i] = t / static_cast<float>(q);
}

template <typename T>
cudaError_t launch(const void* w, const void* a, void* packed, void* partial, void* alpha,
                   int p, long long q, cudaStream_t stream) {
  const long long blocks = (q + kColsPerBlock - 1) / kColsPerBlock;
  const T* wt = static_cast<const T*>(w);
  const T* at = static_cast<const T*>(a);
  uint32_t* pk = static_cast<uint32_t*>(packed);
  float* part = static_cast<float*>(partial);
  if (a != nullptr)
    construct_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(wt, at, pk, part, p, q);
  else
    construct_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(wt, wt, pk, part, p, q);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  alpha_kernel<<<(p + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      part, static_cast<float*>(alpha), p, (int)blocks, q);
  return cudaGetLastError();
}

}  // namespace

// Columns per block of the construction pass: the wrapper sizes the
// (blocks, p) f32 scratch array with it.
extern "C" int tbn_tile_construct_cols_per_block() { return kColsPerBlock; }

extern "C" int tbn_tile_construct(const void* w, const void* a, void* packed, void* partial,
                                  void* alpha, int p, long long q, int w_is_bf16,
                                  void* stream) {
  if (p < 1 || q < 32 || q % 32 != 0 || (q + kColsPerBlock - 1) / kColsPerBlock > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(w_is_bf16 ? launch<__nv_bfloat16>(w, a, packed, partial, alpha, p, q, s)
                         : launch<float>(w, a, packed, partial, alpha, p, q, s));
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
