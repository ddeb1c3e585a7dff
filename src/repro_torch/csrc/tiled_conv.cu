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
// device memory, and only wgmma reaches the tensor cores' rate.
//
// Design, bf16: B2's Hopper mainloop (hopper_gemm.cuh) with the im2col
// gather as its producer. The K loop runs over stages (i, j, pair of words):
// 64 channels of one kernel position, so a stage never straddles two
// positions (C = 32: the second word is missing and its channels read as
// zero). The producer warpgroup decodes its pixels into (n, oh, ow) base
// offsets once; each pixel row of a stage is 128 contiguous bytes of NHWC,
// x[n, oh*sh+i, ow*sw+j, 64w..64w+63], copied as 8 x 16-byte cp.async into
// the swizzled slot (chunk ^ (row % 8)) with zero fill past the last pixel
// or channel, beside the stage's conv-layout words packed[i*kw+j, f, 2w..].
// Each producer thread's copies complete the stage's mbarrier as they land
// (cp.async.mbarrier.arrive), so the producer never waits on its own
// copies; since wgmma reads through the async proxy what cp.async wrote
// through the generic one, the consumers fence the proxies after each
// stage's barrier wait. Two consumer warpgroups run wgmma with the ±1
// operand built in registers from the words (0xBF80 is -1.0; a set bit
// clears the sign). Tiles and the K split come from the wrapper's planner
// (`plan_conv`); split z writes its partial tile to slice z of a workspace
// and a second pass adds the slices in a fixed order (deterministic, unlike
// atomics).
// What bounds it still: at N = 64 the 14x14 layers have 98 tiles of 128
// pixels for 132 SMs (one partial wave), and the epilogue does not overlap
// the next tile's loads (no persistent grid) (PERF.md §6).
// f32: 64 x 64 tiles of pixels x filters, 256 threads, each 4 x 4 outputs,
// plain FMA (TF32 would round x), the A operand gathered from NHWC per
// (i, j, word) step into shared memory; a split K lands in a workspace that
// a second pass adds in a fixed order. Off the main paths.
// Products of x with ±1 are exact in f32, so the result differs from the
// plain version only by summation order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // one packed word (32 channels) per K step

struct ConvShape {
  int n, hp, wp, words, r, kw, sh, sw, oh, ow;
  int steps;  // K units of the body: steps (i, j, w) or stages (i, j, pair)
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

// ------------------------------------------------- bf16 path, Hopper body
// Grid: pixel tiles on x, filter tiles on y, K splits on z (split z writes
// its partial tile to slice z of the workspace; a split starts at an even
// stage). words_tma: the conv-layout words come by TMA (wmap: (kh*kw, r,
// words) int32, boxes of 4 words x kBM filters at one position), one box
// per pair of stages; else (words % 4 != 0) each stage's words by cp.async.
template <int SLABS, int BN>
__global__ void __launch_bounds__(hopper::kThreads, 1)
conv_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                  const uint32_t* __restrict__ packed,
                  const __grid_constant__ CUtensorMap wmap, int words_tma,
                  float* __restrict__ out, ConvShape s, int stages_per_split) {
  using T = hopper::Tile<SLABS, BN>;
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t full[hopper::kStages], empty[hopper::kStages];
  const int m = s.n * s.oh * s.ow;
  const int m0 = blockIdx.x * BN, f0 = blockIdx.y * T::kBM;
  const int pairs = (s.words + 1) / 2;   // stages per kernel position
  out += (size_t)blockIdx.z * m * s.r;  // this split's slice
  const int st0 = blockIdx.z * stages_per_split;
  const int n = min(s.steps, st0 + stages_per_split) - st0;  // steps: stages
  // full: one arrival per producer thread once its copies have landed
  // (cp.async.mbarrier.arrive), plus the words' TMA bytes
  const hopper::Ring ring = hopper::ring_setup<T>(smem, full, empty, 128);

  if (threadIdx.x >= 128 * hopper::kConsumers) {  // producer: the gather
    hopper::producer_regs<SLABS, BN>();
    const int pt = threadIdx.x - 128 * hopper::kConsumers;
    const int chunk = pt & 7, row0 = pt >> 3;      // rows row0 + 16 e
    constexpr int kRows = BN / 16;
    const int c = s.words * 32;
    long long base[kRows];
#pragma unroll
    for (int e = 0; e < kRows; ++e) base[e] = row_base(s, m0 + row0 + 16 * e);
    for (int it = 0; it < n; ++it) {
      const int sl = it % hopper::kStages;
      hopper::mbar_wait(&ring.empty[sl], ((it / hopper::kStages) & 1) ^ 1);
      const int st = st0 + it;
      const int pos = st / pairs, w2 = st - pos * pairs;
      const int i = pos / s.kw, j = pos - i * s.kw;
      uint32_t* wt = hopper::stage_words<T>(ring, it);
      if (words_tma) {
        if (pt == 0 && !(it & 1)) {
          hopper::mbar_expect_tx(&ring.full[sl], T::kPairWBytes);
          hopper::tma_load_3d(wt, &wmap, w2 * hopper::kStageWords, f0, pos,
                              &ring.full[sl]);
        }
      } else {
        for (int e = pt; e < T::kBM * hopper::kStageWords; e += 128) {
          const int row = e / hopper::kStageWords, jw = e % hopper::kStageWords;
          const int f = f0 + row, w = w2 * hopper::kStageWords + jw;
          const bool ok = f < s.r && w < s.words;
          hopper::cp_async4(wt + row * 2 * hopper::kStageWords + jw,
                            ok ? packed + ((size_t)pos * s.r + f) * s.words + w : packed,
                            ok);
        }
      }
      const int ch = w2 * hopper::kStageK + chunk * 8;
      const long long off = ((long long)i * s.wp + j) * c + ch;
      uint8_t* xt = ring.x + sl * T::kXBytes;
#pragma unroll
      for (int e = 0; e < kRows; ++e) {
        const int row = row0 + 16 * e;
        const bool ok = ch < c && base[e] >= 0;
        hopper::cp_async16(xt + row * hopper::kRowBytes + ((chunk ^ (row & 7)) << 4),
                           ok ? x + base[e] + off : x, ok);
      }
      hopper::cp_async_arrive_noinc(&ring.full[sl]);
    }
    hopper::cp_async_wait_all();
    return;
  }
  hopper::consumer_regs<SLABS, BN>();
  float acc[SLABS][BN / 2];
  hopper::consume<SLABS, BN, true>(acc, ring, n);
  hopper::store_tile<SLABS, BN>(acc, ring, out, m, s.r, m0, f0);
}

template <int SLABS, int BN>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint32_t* packed, float* out,
                         const ConvShape& s, long long m, int splits, int per,
                         cudaStream_t stream) {
  using T = hopper::Tile<SLABS, BN>;
  static bool smem_ok = false;
  cudaError_t err = hopper::allow_smem(conv_wgmma_kernel<SLABS, BN>,
                                       T::kSmemBytes, &smem_ok);
  if (err != cudaSuccess) return err;
  if ((s.r + T::kBM - 1) / T::kBM > 65535) return cudaErrorInvalidValue;
  // the words (kh*kw, r, words) in boxes of 4 words x kBM filters x 1
  // position, if rows are 16-byte aligned
  CUtensorMap wmap = {};
  const int words_tma =
      s.words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (words_tma) {
    const hopper::EncodeTiled encode = hopper::encode_tiled();
    if (encode == nullptr) return cudaErrorNotSupported;
    const cuuint64_t dims[3] = {(cuuint64_t)s.words, (cuuint64_t)s.r,
                                (cuuint64_t)s.steps / ((s.words + 1) / 2)};
    const cuuint64_t strides[2] = {(cuuint64_t)s.words * 4,
                                   (cuuint64_t)s.words * 4 * s.r};
    const cuuint32_t box[3] = {2 * hopper::kStageWords, T::kBM, 1};
    const cuuint32_t estr[3] = {1, 1, 1};
    if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 3, const_cast<uint32_t*>(packed),
               dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return cudaErrorInvalidValue;
  }
  const dim3 grid((unsigned)((m + BN - 1) / BN), (s.r + T::kBM - 1) / T::kBM, splits);
  conv_wgmma_kernel<SLABS, BN><<<grid, hopper::kThreads, T::kSmemBytes, stream>>>(
      x, packed, wmap, words_tma, out, s, per);
  return cudaGetLastError();
}

}  // namespace

// bf16 x: the Hopper body with (filters x pixels) tiles 128 x 64 (body 0),
// 128 x 128 (1) or 256 x 128 (2) over K stages (i, j, pair of words),
// kh*kw*ceil(words/2) of them. f32 x: the FMA body (`body` ignored) over K
// steps (i, j, w), kh*kw*words of them. splits > 1: `workspace` holds
// splits * N*OH*OW * r floats, split z covers units [z * per_split,
// min(units, (z + 1) * per_split)), and a second pass adds the slices in a
// fixed order.
extern "C" int tbn_tiled_conv(const void* x, const void* packed, void* out,
                              void* workspace, int n, int hp, int wp, int words,
                              int r, int kh, int kw, int sh, int sw, int oh,
                              int ow, int body, int splits, int per_split,
                              int x_is_bf16, void* stream) {
  const long long m = (long long)n * oh * ow;
  const int units = kh * kw * (x_is_bf16 ? (words + 1) / 2 : words);
  if (n < 1 || words < 1 || r < 1 || kh < 1 || kw < 1 || sh < 1 || sw < 1 ||
      oh < 1 || ow < 1 || m * r >= (1ll << 31) || (r + kBN - 1) / kBN > 65535 ||
      splits > 65535 || body < 0 || body > 2 || hp < (oh - 1) * sh + kh ||
      wp < (ow - 1) * sw + kw || splits < 1 || per_split < 1 ||
      (long long)splits * per_split < units ||
      (long long)(splits - 1) * per_split >= units ||
      (splits > 1 && workspace == nullptr) ||
      (x_is_bf16 && splits > 1 && per_split % 2))   // splits start at even stages
    return (int)cudaErrorInvalidValue;
  const ConvShape s{n, hp, wp, words, r, kw, sh, sw, oh, ow, units};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint32_t*>(packed);
  float* target = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err;
  if (x_is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (body == 0) err = launch_wgmma<1, 64>(xb, pk, target, s, m, splits, per_split, st);
    else if (body == 1) err = launch_wgmma<1, 128>(xb, pk, target, s, m, splits, per_split, st);
    else err = launch_wgmma<2, 128>(xb, pk, target, s, m, splits, per_split, st);
  } else {
    // pixel tiles on x (up to 2^31 - 1), filter tiles on y, K splits on z
    const dim3 grid((unsigned)((m + kBM - 1) / kBM), (r + kBN - 1) / kBN, splits);
    conv_f32_kernel<<<grid, kF32Threads, 0, st>>>(static_cast<const float*>(x), pk,
                                                  target, s, per_split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)hopper::sum_splits(target, static_cast<float*>(out), m * r, splits, st);
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
