// Kernel B2: tiled matmul with a reused bit-packed tile, u = x @ T^T, any m.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matmul.py:69
// `tiled_matmul_unique` (body `_matmul_kernel`, unpack `_unpack_block`).
//
//   x       (m, k) bf16 or f32, row-major, k = words * 32 (zero pad columns)
//   packed  (r, words) int32: bit (c % 32) of word c / 32 of row j is
//           T[j, c], bit 1 -> +1, bit 0 -> -1
//   out     (m, r) f32
//
// What bounds it on an H100: operations. A chunked-prefill tick runs m =
// n_slots * chunk_tokens rows (128 by default) against every tile, 2*m*k*r
// flops per call for 4*k*r/32 bytes of tile words, far above the card's
// ~295 flop/byte ridge in bf16. The tile must reach the tensor cores as
// ±1 values without the dense (r, k) weight ever existing in device memory.
//
// Design: a shared-memory-tiled GEMM over 64 x 64 output tiles, one packed
// word (32 k columns) per row per step. At m = 128 a layer has only 4..56
// such tiles for 132 SMs, so the K range is split over blockIdx.z: each
// split writes its partial tile to a workspace slice, and a second pass
// adds the slices in a fixed order (deterministic, unlike atomics). The
// wrapper picks the split count and allocates the workspace.
//  * bf16: 4 warps, each 32 x 32 of the tile, `mma.sync.m16n8k16` bf16 with
//    f32 accumulation. The x tile is staged in shared memory with 16-byte
//    loads; the B operand is never staged unpacked: each lane builds its
//    two bf16x2 B registers straight from the packed word of its n row
//    (0xBF80 is -1.0, clearing the sign bit gives +1.0), so the ±1 tile
//    exists only in registers.
//  * f32: 256 threads, each 4 x 4 outputs, plain FMA (tensor-core TF32
//    would round x to 10 mantissa bits); the word tile is unpacked to ±1
//    f32 in shared memory.
// Ragged m and r edges are masked (zero-filled loads, guarded stores).
// Products of x with ±1 are exact in f32, so the result differs from the
// plain version only by summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // one packed word per tile row per step

// ---------------------------------------------------------------- bf16 path
constexpr int kBf16Threads = 128;
constexpr int kXPitch = kBK + 8;  // bf16 elements; 80-byte rows, conflict-free

__device__ __forceinline__ uint32_t pm1_pair(uint32_t word, int bit) {
  // bf16x2 of (T[bit], T[bit+1]): -1.0 is 0xBF80, a set bit clears the sign
  const uint32_t lo = (word >> bit) & 1u;
  const uint32_t hi = (word >> (bit + 1)) & 1u;
  return 0xBF80BF80u ^ ((lo << 15) | (hi << 31));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(kBf16Threads)
matmul_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                   const uint32_t* __restrict__ packed, float* __restrict__ out,
                   int m, int r, int words, int words_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][kXPitch];
  __shared__ uint32_t ws[kBN];
  const int k = words * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tig = lane & 3;
  const int kw0 = blockIdx.z * words_per_split;
  const int kw1 = min(words, kw0 + words_per_split);
  out += (size_t)blockIdx.z * m * r;  // this split's slice

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int kw = kw0; kw < kw1; ++kw) {
    __syncthreads();  // the previous step's tiles are consumed
    // x tile: 64 rows x 32 bf16 = 256 chunks of 16 bytes, 2 per thread
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = threadIdx.x + e * kBf16Threads;
      const int row = c >> 2, col8 = (c & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + row < m)
        v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + row) * k + kw * 32 + col8);
      *reinterpret_cast<uint4*>(&xs[row][col8]) = v;
    }
    if (threadIdx.x < kBN) {
      const int n = n0 + threadIdx.x;
      ws[threadIdx.x] = n < r ? packed[(size_t)n * words + kw] : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t afr[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int row = wm + mt * 16 + g;
        const int col = kk + tig * 2;
        afr[mt][0] = *reinterpret_cast<const uint32_t*>(&xs[row][col]);
        afr[mt][1] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][col]);
        afr[mt][2] = *reinterpret_cast<const uint32_t*>(&xs[row][col + 8]);
        afr[mt][3] = *reinterpret_cast<const uint32_t*>(&xs[row + 8][col + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint32_t word = ws[wn + nt * 8 + g];
        const uint32_t b0 = pm1_pair(word, kk + tig * 2);
        const uint32_t b1 = pm1_pair(word, kk + tig * 2 + 8);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], afr[mt], b0, b1);
      }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = m0 + wm + mt * 16 + g;
      const int col = n0 + wn + nt * 8 + tig * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // h = 1: rows g + 8
        const int rr = row + h * 8;
        if (rr >= m) continue;
        if (col < r) out[(size_t)rr * r + col] = acc[mt][nt][2 * h];
        if (col + 1 < r) out[(size_t)rr * r + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// ----------------------------------------------------------------- f32 path
constexpr int kF32Threads = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kF32Threads)
matmul_f32_kernel(const float* __restrict__ x, const uint32_t* __restrict__ packed,
                  float* __restrict__ out, int m, int r, int words,
                  int words_per_split) {
  __shared__ float xs[kBK][kBM + 1];  // transposed x tile, odd pitch
  __shared__ float ts[kBK][kBN];      // unpacked ±1 tile
  const int k = words * 32;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int kw0 = blockIdx.z * words_per_split;
  const int kw1 = min(words, kw0 + words_per_split);
  out += (size_t)blockIdx.z * m * r;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int kw = kw0; kw < kw1; ++kw) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kF32Threads) {
      const int row = idx / kBK, col = idx % kBK;  // coalesced along k
      xs[col][row] = m0 + row < m ? x[(size_t)(m0 + row) * k + kw * 32 + col] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBN * kBK; idx += kF32Threads) {
      const int n = idx % kBN, bit = idx / kBN;
      const uint32_t word = n0 + n < r ? packed[(size_t)(n0 + n) * words + kw] : 0u;
      ts[bit][n] = ((word >> bit) & 1u) ? 1.f : -1.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ts[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < r) out[(size_t)row * r + col] = acc[i][j];
    }
  }
}

// -------------------------------------------------- split-K second pass
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int n, int splits) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += ws[(size_t)z * n + idx];
    out[idx] = s;
  }
}

}  // namespace

// splits > 1: `workspace` holds splits * m * r floats; split z covers words
// [z * words_per_split, min(words, (z + 1) * words_per_split)).
extern "C" int tbn_tiled_matmul(const void* x, const void* packed, void* out,
                                void* workspace, int m, int r, int words,
                                int splits, int words_per_split, int x_is_bf16,
                                void* stream) {
  if (m < 1 || r < 1 || words < 1 || splits < 1 || words_per_split < 1 ||
      (long long)splits * words_per_split < words ||
      (long long)(splits - 1) * words_per_split >= words ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* target = static_cast<float*>(splits > 1 ? workspace : out);
  const dim3 grid((r + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
  if (x_is_bf16) {
    matmul_bf16_kernel<<<grid, kBf16Threads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const uint32_t*>(packed),
        target, m, r, words, words_per_split);
  } else {
    matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(packed),
        target, m, r, words, words_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int n = m * r;
  const int blocks = (n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024;
  sum_splits_kernel<<<blocks, 256, 0, s>>>(target, static_cast<float*>(out), n,
                                           splits);
  return (int)cudaGetLastError();
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
