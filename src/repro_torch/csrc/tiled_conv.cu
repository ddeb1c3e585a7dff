// Kernel B6: fused-im2col conv with a reused bit-packed tile (implicit GEMM).
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_conv.py:68
// `tiled_conv_unique` (body `_conv_kernel`).
//
//   x       (N, Hp, Wp, C) bf16 or f32, NHWC, already padded so every read
//           is in bounds: Hp >= (OH-1)*sh + kh, Wp >= (OW-1)*sw + kw;
//           C = words * 32 (zero pad channels)
//   packed  (kh*kw, r, words) int32, "conv layout": bit (c % 32) of word
//           c / 32 of row f at position p = i*kw + j is T[f, c, i, j],
//           bit 1 -> +1, bit 0 -> -1
//   out     (N, OH, OW, r) f32:
//           u[n,oh,ow,f] = sum_{i,j,c} x[n, oh*sh+i, ow*sw+j, c] * T[f,c,i,j]
//
// What bounds it on an H100: operations. As a GEMM it is M = N*OH*OW output
// pixels by r filters over K = kh*kw*C; at a ResNet-34 ImageNet layer with
// N = 64 that is 2*M*K*r = 7 GFLOP per call against a few MB of input,
// far above the card's ~295 flop/byte ridge in bf16. Neither the im2col
// matrix (kh*kw times the input) nor the dense ±1 weight may exist in
// device memory.
//
// Design: tiled_matmul.cu's GEMM (64 x 64 output tiles of pixels x
// filters, one packed word = 32 channels per K step) with the A operand
// gathered straight from NHWC: each block decodes its 64 tile rows once
// into (n, oh, ow) base offsets, and K step (i, j, w) reads channels
// 32w..32w+31 of x[n, oh*sh+i, ow*sw+j, :], contiguous in NHWC, so the
// gather costs no more than B2's row loads. B reads the conv-layout word
// packed[i*kw+j, f, w] directly. When the grid has few tiles (N = 1 at
// the 7x7 stage: 4 tiles for 132 SMs) the K steps are split over
// blockIdx.z and a second pass adds the slices in a fixed order
// (deterministic, unlike atomics).
//  * bf16: 4 warps, each 32 x 32 of the tile, `mma.sync.m16n8k16` bf16 with
//    f32 accumulation; each lane builds its B registers from the packed
//    word (0xBF80 is -1.0; a set bit clears the sign), so the ±1 tile lives
//    only in registers.
//  * f32: 256 threads, each 4 x 4 outputs, plain FMA (TF32 would round x).
// Products of x with ±1 are exact in f32, so the result differs from the
// plain version only by summation order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // one packed word (32 channels) per K step

struct ConvShape {
  int n, hp, wp, words, r, kw, sh, sw, oh, ow, steps;
};

// Element offset of tile row m0 + t's patch origin x[n, oh*sh, ow*sw, 0],
// or -1 past the last output pixel.
__device__ __forceinline__ long long row_base(const ConvShape& s, int row) {
  if (row >= s.n * s.oh * s.ow) return -1;
  const int ow = row % s.ow;
  const int t = row / s.ow;
  const int oh = t % s.oh;
  const int n = t / s.oh;
  return (((long long)n * s.hp + (long long)oh * s.sh) * s.wp +
          (long long)ow * s.sw) * (s.words * 32);
}

// Element offset of K step `st` = (i*kw + j)*words + w inside a patch.
__device__ __forceinline__ long long step_offset(const ConvShape& s, int st,
                                                 int* pos, int* w) {
  *pos = st / s.words;
  *w = st - *pos * s.words;
  const int i = *pos / s.kw, j = *pos - i * s.kw;
  return ((long long)i * s.wp + j) * (s.words * 32) + *w * 32;
}

// ---------------------------------------------------------------- bf16 path
constexpr int kBf16Threads = 128;
constexpr int kXPitch = kBK + 8;  // bf16 elements; 80-byte rows, conflict-free

__device__ __forceinline__ uint32_t pm1_pair(uint32_t word, int bit) {
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
conv_bf16_kernel(const __nv_bfloat16* __restrict__ x,
                 const uint32_t* __restrict__ packed, float* __restrict__ out,
                 ConvShape s, int steps_per_split) {
  __shared__ __align__(16) __nv_bfloat16 xs[kBM][kXPitch];
  __shared__ uint32_t ws[kBN];
  __shared__ long long base[kBM];
  const int m = s.n * s.oh * s.ow;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int g = lane >> 2, tig = lane & 3;
  const int st0 = blockIdx.z * steps_per_split;
  const int st1 = min(s.steps, st0 + steps_per_split);
  out += (size_t)blockIdx.z * m * s.r;  // this split's slice
  if (threadIdx.x < kBM) base[threadIdx.x] = row_base(s, m0 + threadIdx.x);

  float acc[2][4][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][b][c] = 0.f;

  for (int st = st0; st < st1; ++st) {
    int pos, w;
    const long long off = step_offset(s, st, &pos, &w);
    __syncthreads();  // the previous step's tiles are consumed (and base set)
    // x tile: 64 patch rows x 32 channels = 256 chunks of 16 bytes, 2 each
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = threadIdx.x + e * kBf16Threads;
      const int row = c >> 2, col8 = (c & 3) * 8;
      const long long b = base[row];
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (b >= 0) v = *reinterpret_cast<const uint4*>(x + b + off + col8);
      *reinterpret_cast<uint4*>(&xs[row][col8]) = v;
    }
    if (threadIdx.x < kBN) {
      const int f = n0 + threadIdx.x;
      ws[threadIdx.x] =
          f < s.r ? packed[((size_t)pos * s.r + f) * s.words + w] : 0u;
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
        if (col < s.r) out[(size_t)rr * s.r + col] = acc[mt][nt][2 * h];
        if (col + 1 < s.r) out[(size_t)rr * s.r + col + 1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// ----------------------------------------------------------------- f32 path
constexpr int kF32Threads = 256;  // 16 x 16, each 4 x 4 outputs

__global__ void __launch_bounds__(kF32Threads)
conv_f32_kernel(const float* __restrict__ x, const uint32_t* __restrict__ packed,
                float* __restrict__ out, ConvShape s, int steps_per_split) {
  __shared__ float xs[kBK][kBM + 1];  // transposed patch tile, odd pitch
  __shared__ float ts[kBK][kBN];      // unpacked ±1 tile
  __shared__ long long base[kBM];
  const int m = s.n * s.oh * s.ow;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int st0 = blockIdx.z * steps_per_split;
  const int st1 = min(s.steps, st0 + steps_per_split);
  out += (size_t)blockIdx.z * m * s.r;
  if (threadIdx.x < kBM) base[threadIdx.x] = row_base(s, m0 + threadIdx.x);
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int st = st0; st < st1; ++st) {
    int pos, w;
    const long long off = step_offset(s, st, &pos, &w);
    __syncthreads();
    for (int idx = threadIdx.x; idx < kBM * kBK; idx += kF32Threads) {
      const int row = idx / kBK, col = idx % kBK;  // coalesced along C
      const long long b = base[row];
      xs[col][row] = b >= 0 ? x[b + off + col] : 0.f;
    }
    for (int idx = threadIdx.x; idx < kBN * kBK; idx += kF32Threads) {
      const int f = idx % kBN, bit = idx / kBN;
      const uint32_t word =
          n0 + f < s.r ? packed[((size_t)pos * s.r + n0 + f) * s.words + w] : 0u;
      ts[bit][f] = ((word >> bit) & 1u) ? 1.f : -1.f;
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
      if (col < s.r) out[(size_t)row * s.r + col] = acc[i][j];
    }
  }
}

// -------------------------------------------------- split-K second pass
__global__ void sum_splits_kernel(const float* __restrict__ ws,
                                  float* __restrict__ out, int n, int splits) {
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < n;
       idx += gridDim.x * blockDim.x) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += ws[(size_t)z * n + idx];
    out[idx] = acc;
  }
}

}  // namespace

// K steps are (i, j, w) in that order, kh*kw*words of them. splits > 1:
// `workspace` holds splits * N*OH*OW * r floats; split z covers steps
// [z * steps_per_split, min(steps, (z + 1) * steps_per_split)).
extern "C" int tbn_tiled_conv(const void* x, const void* packed, void* out,
                              void* workspace, int n, int hp, int wp, int words,
                              int r, int kh, int kw, int sh, int sw, int oh,
                              int ow, int splits, int steps_per_split,
                              int x_is_bf16, void* stream) {
  const long long m = (long long)n * oh * ow;
  const int steps = kh * kw * words;
  if (n < 1 || words < 1 || r < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      oh < 1 || ow < 1 || m * r >= (1ll << 31) || (r + kBN - 1) / kBN > 65535 ||
      splits > 65535 ||
      hp < (oh - 1) * sh + kh || wp < (ow - 1) * sw + kw || splits < 1 ||
      steps_per_split < 1 ||
      (long long)splits * steps_per_split < steps ||
      (long long)(splits - 1) * steps_per_split >= steps ||
      (splits > 1 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  const ConvShape s{n, hp, wp, words, r, kw, sh, sw, oh, ow, steps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* target = static_cast<float*>(splits > 1 ? workspace : out);
  // pixel tiles on x (up to 2^31 - 1), filter tiles on y, K splits on z
  const dim3 grid((unsigned)((m + kBM - 1) / kBM), (r + kBN - 1) / kBN, splits);
  if (x_is_bf16) {
    conv_bf16_kernel<<<grid, kBf16Threads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const uint32_t*>(packed), target, s, steps_per_split);
  } else {
    conv_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const uint32_t*>(packed),
        target, s, steps_per_split);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  const int total = (int)(m * r);
  const int blocks = (total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024;
  sum_splits_kernel<<<blocks, 256, 0, st>>>(target, static_cast<float*>(out),
                                            total, splits);
  return (int)cudaGetLastError();
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
