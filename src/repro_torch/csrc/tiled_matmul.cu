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
// n_slots * chunk_tokens rows (128 by default) and the fused train step m =
// B*S = 2048 against every tile: 2*m*k*r flops per call for 4*k*r/32 bytes
// of tile words, far above the card's ~295 flop/byte ridge in bf16. Only
// wgmma reaches the tensor cores' rate on Hopper, and it must be kept fed:
// the ±1 tile has to reach it without the dense (r, k) weight ever existing
// in device memory, and x has to arrive while the tensor cores work.
//
// Design, bf16 (the main path; hopper_gemm.cuh holds the shared mainloop):
//  * The tile is the register operand: out^T = T . x^T through
//    `wgmma.m64nNk16` with A built from the packed words in registers and B
//    = a 64-column tile of x in shared memory (128-byte swizzle), so the
//    ±1 weight never exists outside registers.
//  * A 6-stage ring of x tiles, filled by a producer warpgroup: one thread
//    issues TMA loads (`cp.async.bulk.tensor.2d`, zero fill past m and k)
//    and the producer warp copies the stage's packed words with cp.async;
//    both complete the stage's mbarrier. Two consumer warpgroups (64 or
//    128 filters each) run wgmma on the stages that have arrived, keeping
//    one stage's group in flight while they build the next one's operand.
//  * Tiles of 128 or 256 filters x 64 or 128 rows, chosen with the K split
//    by the wrapper's planner (`plan_matmul`). K is split only where the
//    grid has fewer tiles than SMs, into at most 8 ranges that run as one
//    thread-block cluster: the blocks add their partial tiles through
//    distributed shared memory in a fixed rank order (deterministic; no
//    workspace, no second launch, no atomics).
//  * The epilogue stages the f32 tile through shared memory and writes rows
//    of out with 16-byte stores.
// What bounds it still: the epilogue does not overlap the next tile's loads
// (no persistent grid), a 128-row x tile is read again from L2 by every
// filter tile (no TMA multicast across a cluster), and at m = 128 a call is
// a few microseconds of pipeline fill (PERF.md §6).
// f32 x: 64 x 64 tiles, 256 threads, each 4 x 4 outputs, plain FMA
// (tensor-core TF32 would round x to 10 mantissa bits); the word tile is
// unpacked to ±1 f32 in shared memory; a K split lands in a workspace that a
// second pass adds in a fixed order. Off the main paths.
// Ragged m and r edges are masked (zero-filled loads, guarded stores); the
// x columns of a missing word are zero, so the word's ±1 values do not
// matter. Products of x with ±1 are exact in f32, so the result differs from
// the plain version only by summation order.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;  // one packed word per tile row per step

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

// ------------------------------------------------- bf16 path, Hopper body
// Grid: row tiles on x, filter tiles on y, K splits on z (split z writes
// its partial tile to slice z of the workspace; a split starts at an even
// stage). words_tma: the packed words come by TMA too (wmap: (r, words)
// int32, boxes of 4 words x kBM filters), one box per pair of stages; else
// (words % 4 != 0: rows not 16-byte aligned) the producer warp copies each
// stage's words with 4-byte cp.async.
template <int SLABS, int BN>
__global__ void __launch_bounds__(hopper::kThreads, 1)
matmul_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap, int words_tma,
                    const uint32_t* __restrict__ packed, float* __restrict__ out,
                    int m, int r, int words, int stages_per_split) {
  using T = hopper::Tile<SLABS, BN>;
  extern __shared__ uint8_t smem[];
  __shared__ uint64_t full[hopper::kStages], empty[hopper::kStages];
  const int m0 = blockIdx.x * BN, f0 = blockIdx.y * T::kBM;
  const int st0 = blockIdx.z * stages_per_split;
  const int n = min((words + 1) / 2, st0 + stages_per_split) - st0;
  out += (size_t)blockIdx.z * m * r;
  // full: the TMA thread's arrival (+ bytes), and with cp.async words one
  // arrival per producer lane once its copies have landed
  const hopper::Ring ring =
      hopper::ring_setup<T>(smem, full, empty, words_tma ? 1 : 33);

  if (threadIdx.x >= 128 * hopper::kConsumers) {  // producer warpgroup
    hopper::producer_regs<SLABS, BN>();
    const int lane = threadIdx.x & 31;
    if (threadIdx.x < 128 * hopper::kConsumers + 32) {
      for (int it = 0; it < n; ++it) {
        const int s = it % hopper::kStages;
        hopper::mbar_wait(&ring.empty[s], ((it / hopper::kStages) & 1) ^ 1);
        const int st = st0 + it;
        uint32_t* wt = hopper::stage_words<T>(ring, it);
        const bool pair_words = words_tma && !(it & 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(&ring.full[s],
                                        T::kXBytes + (pair_words ? T::kPairWBytes : 0));
          hopper::tma_load_2d(ring.x + s * T::kXBytes, &xmap, st * hopper::kStageK, m0,
                              &ring.full[s]);
          if (pair_words)
            hopper::tma_load_2d(wt, &wmap, st * hopper::kStageWords, f0, &ring.full[s]);
        }
        if (!words_tma) {
          for (int e = lane; e < T::kBM * hopper::kStageWords; e += 32) {
            const int row = e / hopper::kStageWords, j = e % hopper::kStageWords;
            const int f = f0 + row, kw = st * hopper::kStageWords + j;
            const bool ok = f < r && kw < words;
            hopper::cp_async4(wt + row * 2 * hopper::kStageWords + j,
                              ok ? packed + (size_t)f * words + kw : packed, ok);
          }
          hopper::cp_async_arrive_noinc(&ring.full[s]);
        }
      }
      hopper::cp_async_wait_all();
    }
    return;
  }
  hopper::consumer_regs<SLABS, BN>();
  float acc[SLABS][BN / 2];
  hopper::consume<SLABS, BN, false>(acc, ring, n);
  hopper::store_tile<SLABS, BN>(acc, ring, out, m, r, m0, f0);
}

// A 2-D tensor map of a row-major (rows, cols) array: boxes of box_cols x
// box_rows, elements past either edge read as zero.
cudaError_t encode_2d(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
                      const void* base, int rows, int cols, int box_cols,
                      int box_rows, CUtensorMapSwizzle swizzle) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, estr,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

template <int SLABS, int BN>
cudaError_t launch_wgmma(const __nv_bfloat16* x, const uint32_t* packed, float* out,
                         int m, int r, int words, int splits, int per,
                         cudaStream_t stream) {
  using T = hopper::Tile<SLABS, BN>;
  static bool smem_ok = false;
  cudaError_t err = hopper::allow_smem(matmul_wgmma_kernel<SLABS, BN>,
                                       T::kSmemBytes, &smem_ok);
  if (err != cudaSuccess) return err;
  if ((r + T::kBM - 1) / T::kBM > 65535) return cudaErrorInvalidValue;
  // x: boxes of 64 columns x BN rows in the 128-byte swizzle
  CUtensorMap xmap, wmap = {};
  err = encode_2d(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, m, words * 32,
                  hopper::kStageK, BN, CU_TENSOR_MAP_SWIZZLE_128B);
  if (err != cudaSuccess) return err;
  // the words: boxes of 4 words x kBM filters, if rows are 16-byte aligned
  const int words_tma = words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0;
  if (words_tma) {
    err = encode_2d(&wmap, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, packed, r, words,
                    2 * hopper::kStageWords, T::kBM, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((m + BN - 1) / BN, (r + T::kBM - 1) / T::kBM, splits);
  matmul_wgmma_kernel<SLABS, BN><<<grid, hopper::kThreads, T::kSmemBytes, stream>>>(
      xmap, wmap, words_tma, packed, out, m, r, words, per);
  return cudaGetLastError();
}

}  // namespace

// bf16 x: the Hopper body with (filters x rows) tiles 128 x 64 (body 0),
// 128 x 128 (1), 256 x 128 (2) or 128 x 256 (3), K in stages of two words.
// f32 x: the FMA body (`body` ignored), K in words. splits > 1: `workspace`
// holds splits * m * r floats, split z covers units [z * per_split,
// min(units, (z + 1) * per_split)), and a second pass adds the slices in a
// fixed order.
extern "C" int tbn_tiled_matmul(const void* x, const void* packed, void* out,
                                void* workspace, int m, int r, int words, int body,
                                int splits, int per_split, int x_is_bf16,
                                void* stream) {
  const int units = x_is_bf16 ? (words + 1) / 2 : words;
  if (m < 1 || r < 1 || words < 1 || splits < 1 || per_split < 1 || body < 0 ||
      body > 3 || splits > 65535 || (long long)splits * per_split < units ||
      (long long)(splits - 1) * per_split >= units ||
      (splits > 1 && workspace == nullptr) ||
      (x_is_bf16 && splits > 1 && per_split % 2))   // splits start at even stages
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* pk = static_cast<const uint32_t*>(packed);
  float* target = static_cast<float*>(splits > 1 ? workspace : out);
  cudaError_t err;
  if (x_is_bf16) {
    const auto* xb = static_cast<const __nv_bfloat16*>(x);
    if (body == 0) err = launch_wgmma<1, 64>(xb, pk, target, m, r, words, splits, per_split, s);
    else if (body == 1) err = launch_wgmma<1, 128>(xb, pk, target, m, r, words, splits, per_split, s);
    else if (body == 2) err = launch_wgmma<2, 128>(xb, pk, target, m, r, words, splits, per_split, s);
    else err = launch_wgmma<1, 256>(xb, pk, target, m, r, words, splits, per_split, s);
  } else {
    const dim3 grid((r + kBN - 1) / kBN, (m + kBM - 1) / kBM, splits);
    matmul_f32_kernel<<<grid, kF32Threads, 0, s>>>(static_cast<const float*>(x), pk,
                                                   target, m, r, words, per_split);
    err = cudaGetLastError();
  }
  if (err != cudaSuccess || splits == 1) return (int)err;
  return (int)hopper::sum_splits(target, static_cast<float*>(out), (long long)m * r,
                                 splits, s);
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
