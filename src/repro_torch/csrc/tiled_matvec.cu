// Kernel B1: decode-time tiled matvec, u = x @ T^T, for m <= 32 rows.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_matvec.py:97
// `tiled_matvec_unique` (body `_matvec_kernel`, unpack
// `tiled_matmul._unpack_block`).
//
//   x       (m, k) bf16 or f32, row-major, k = words * 32 (zero pad columns)
//   packed  (r, words) int32: bit (c % 32) of word c / 32 of row j is
//           T[j, c], bit 1 -> +1, bit 0 -> -1
//   out     (m, r) f32
//
// What bounds it on an H100: memory and launch. A decode tick multiplies a
// handful of activation rows against every tile word once, so the work is
// about one 32-bit word read per 32 * m multiply-adds; the packed words are
// the only large operand, and at the per-layer sizes of the main path the
// whole read takes well under the launch latency. What the card must not
// do is leave most of its 132 SMs idle: a layer has only r = 128..6144
// output rows.
//
// Design: four warps share each output row j, splitting its words (warp p
// takes words p*32 + lane, stepping by 128: each warp reads 128 contiguous
// bytes of T[j] per step), and a block holds two rows, so a (4096, 512)
// layer runs 256 blocks of 8 warps. Lane l reads one 32-bit word of T[j],
// loads the 32 activations x[i, 32w : 32w+32] it covers (16-byte loads;
// x is tiny and stays in L1), and adds each with its sign flipped by the
// word's bit (an XOR of the float's sign bit: no multiply, and no dense ±1
// tile anywhere) into acc[i], for every i < m. A warp shuffle sums the
// lanes, and the four partial sums of a row are added in a fixed order
// through shared memory, so results are deterministic. m is a template
// bucket (1, 2, 4, 8, 16, 32); rows past m are never read.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSplit = 4;         // warps sharing one output row
constexpr int kRowsPerBlock = 2;
constexpr int kThreads = kSplit * kRowsPerBlock * 32;

// 32 consecutive activations as f32 (bf16 is the top half of an f32)
__device__ __forceinline__ void load32(const __nv_bfloat16* p, float (&v)[32]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint4 u = __ldg(q + c);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[c * 8 + 2 * e] = __uint_as_float(w[e] << 16);
      v[c * 8 + 2 * e + 1] = __uint_as_float(w[e] & 0xFFFF0000u);
    }
  }
}

__device__ __forceinline__ void load32(const float* p, float (&v)[32]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float4 f = __ldg(q + c);
    v[c * 4] = f.x;
    v[c * 4 + 1] = f.y;
    v[c * 4 + 2] = f.z;
    v[c * 4 + 3] = f.w;
  }
}

template <typename T, int MT>
__global__ void __launch_bounds__(kThreads)
matvec_kernel(const T* __restrict__ x, const uint32_t* __restrict__ packed,
              float* __restrict__ out, int m, int r, int words) {
  __shared__ float partial[kRowsPerBlock][kSplit][MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_local = warp / kSplit, part = warp % kSplit;
  const int j = blockIdx.x * kRowsPerBlock + row_local;
  const size_t k = (size_t)words * 32;
  float acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0.f;

  if (j < r) {
    const uint32_t* prow = packed + (size_t)j * words;
    for (int w = part * 32 + lane; w < words; w += kSplit * 32) {
      const uint32_t nbits = ~__ldg(prow + w);  // set bit b -> negate x[b]
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m) {  // warp-uniform
          float v[32];
          load32(x + i * k + (size_t)w * 32, v);
#pragma unroll
          for (int b = 0; b < 32; ++b)
            acc[i] += __uint_as_float(__float_as_uint(v[b]) ^
                                      ((nbits << (31 - b)) & 0x80000000u));
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    float s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) partial[row_local][part][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock * MT) {
    const int rl = threadIdx.x / MT, i = threadIdx.x % MT;
    const int jj = blockIdx.x * kRowsPerBlock + rl;
    if (jj < r && i < m) {
      float s = 0.f;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) s += partial[rl][p][i];
      out[(size_t)i * r + jj] = s;
    }
  }
}

template <typename T, int MT>
cudaError_t launch(const void* x, const void* packed, void* out, int m, int r,
                   int words, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  matvec_kernel<T, MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const uint32_t*>(packed),
      static_cast<float*>(out), m, r, words);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* packed, void* out, int m, int r,
                     int words, cudaStream_t s) {
  if (m <= 1) return launch<T, 1>(x, packed, out, m, r, words, s);
  if (m <= 2) return launch<T, 2>(x, packed, out, m, r, words, s);
  if (m <= 4) return launch<T, 4>(x, packed, out, m, r, words, s);
  if (m <= 8) return launch<T, 8>(x, packed, out, m, r, words, s);
  if (m <= 16) return launch<T, 16>(x, packed, out, m, r, words, s);
  return launch<T, 32>(x, packed, out, m, r, words, s);
}

}  // namespace

extern "C" int tbn_tiled_matvec(const void* x, const void* packed, void* out,
                                int m, int r, int words, int x_is_bf16,
                                void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(x_is_bf16
                   ? dispatch<__nv_bfloat16>(x, packed, out, m, r, words, s)
                   : dispatch<float>(x, packed, out, m, r, words, s));
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
