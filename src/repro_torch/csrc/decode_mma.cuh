// Shared tensor-core body of kernels B1 (tiled_matvec.cu, bf16 x) and B4
// (tiled_int8.cu, int8 q): a decode matvec, m <= 32 rows, whose weight is a
// bit-packed ±1 tile. Each source supplies an Op (element type, accumulator
// type, bytes of x a packed word covers, and the per-word product: the ±1
// A fragment built in registers and one `mma.sync` per n-tile of 8 rows).
//
// The body computes out transposed, out[:, f0:f0+16]^T = T[f0:f0+16] . x^T:
//  * A block is max(4, FW) warps over 16 * FW filters (FW = 1, 2, 4, 8);
//    the warps of one 16-filter group split the block's words between them
//    and add their accumulators in a fixed order through shared memory at
//    the end.
//  * K is split over blocks (grid.y) until a wave of blocks runs. A block
//    copies all of its split at once with cp.async: every row of x (8 * NT
//    rows, zero past m; a row pitch of 16 mod 128 bytes, so the eight rows
//    a fragment load touches fall on distinct banks) and every filter's
//    words (an odd pitch, for the same reason). It then waits once: one
//    round trip to memory per block, not one per word or chunk.
//  * Split z writes its partial tile to slice z of a workspace, and a second
//    kernel adds the slices in the order z = 0, 1, ... with every SM: the
//    order never depends on which block finishes first, so repeated runs
//    are bit-identical; no float atomics. (Letting the last block of each
//    filter tile add its tile's slices, found through an int32 arrival
//    count, saves the second launch but was slower at every main-path
//    shape on an H100: one block reads every slice of its tile.)
//  * Both kernels are dependent launches (hopper_gemm.cuh launch_dependent):
//    each is set up while the kernel before it on the stream runs, and
//    waits for it before touching memory; the body lets the split pass
//    start once its products are done.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_gemm.cuh"   // cp.async helpers and the split-K pass

namespace decode {

// warps of a block over 16 * FW filters
template <int FW>
constexpr int kWarps = FW > 4 ? FW : 4;
constexpr int kMaxSmem = 96 * 1024;   // dynamic shared memory a block may take

// Bytes of one staged row of x for a split of n words (16-byte aligned and
// 16 mod 128), and words of one staged filter row (odd).
__host__ __device__ constexpr int x_pitch(int n, int word_bytes) {
  return (n * word_bytes + 127) / 128 * 128 + 16;
}
__host__ __device__ constexpr int w_pitch(int n) { return n | 1; }

// Dynamic shared memory of a block whose split has n words: the staged x
// rows and filter words, or the warps' partial sums, whichever is larger.
template <int NT, int FW, int WB>
__host__ __device__ constexpr int smem_bytes(int n) {
  const int stage = 8 * NT * x_pitch(n, WB) + 16 * FW * w_pitch(n) * 4;
  const int red = (kWarps<FW> / FW - 1) * FW * 32 * NT * 4 * 4;
  return stage > red ? stage : red;
}

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_wait_all;

// Grid: filter tiles on x, K splits on y (split z covers words [z * per,
// (z + 1) * per) and writes slice z of `ws`, splits * m * r, when there is
// more than one).
template <class Op, int NT, int FW>
__global__ void __launch_bounds__(32 * kWarps<FW>)
mma_kernel(const typename Op::In* __restrict__ x, const uint32_t* __restrict__ packed,
           typename Op::Acc* __restrict__ out, typename Op::Acc* __restrict__ ws, int m,
           int r, int words, int per) {
  using Acc = typename Op::Acc;
  constexpr int KP = kWarps<FW> / FW;   // warps splitting a group's words
  constexpr int kThreads = 32 * kWarps<FW>;
  constexpr int WB = Op::kWordBytes;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int fg = warp % FW, kp = warp / FW;
  const int f0 = blockIdx.x * 16 * FW;
  const int ra = f0 + fg * 16 + g, rb = ra + 8;
  const int w0 = blockIdx.y * per, n = min(words, w0 + per) - w0;
  const int xp = x_pitch(n, WB), wp = w_pitch(n);
  uint8_t* xs = smem;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(smem + 8 * NT * xp);

  hopper::wait_prior_grid();   // a dependent launch (hopper_gemm.cuh)
  // the whole split: x rows past m and filters past r are zero-filled
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const size_t row_bytes = (size_t)words * WB;
  const int units = n * WB / 16;   // 16-byte units of a row's split
  for (int u = threadIdx.x; u < 8 * NT * units; u += kThreads) {
    const int row = u / units, cu = u - row * units;
    const bool ok = row < m;
    cp_async16(xs + row * xp + cu * 16,
               ok ? xb + row * row_bytes + (size_t)w0 * WB + cu * 16 : xb, ok);
  }
  for (int u = threadIdx.x; u < 16 * FW * n; u += kThreads) {
    const int f = u / n, lw = u - f * n;
    const bool ok = f0 + f < r;
    cp_async4(wsm + f * wp + lw, ok ? packed + (size_t)(f0 + f) * words + w0 + lw : packed,
              ok);
  }
  cp_async_wait_all();
  __syncthreads();

  Acc acc[NT][4] = {};
  const int part = (n + KP - 1) / KP, lo = kp * part, hi = min(n, lo + part);
  const uint32_t* wra = wsm + (fg * 16 + g) * wp;
  const uint32_t* wrb = wra + 8 * wp;
  const uint8_t* xg = xs + g * xp;
#pragma unroll 2
  for (int lw = lo; lw < hi; ++lw)
    Op::template word<NT>(acc, wra[lw], wrb[lw], xg + lw * WB, xp, t);

  if constexpr (KP > 1) {   // fixed-order sum of the warps of a group
    constexpr int kPerWarp = 32 * NT * 4;
    Acc* red = reinterpret_cast<Acc*>(smem);
    __syncthreads();        // every warp is done with the staged split
    if (kp > 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((kp - 1) * FW + fg) * kPerWarp + (j * 4 + e) * 32 + lane] = acc[j][e];
    }
    __syncthreads();
    if (kp == 0) {
#pragma unroll
      for (int q = 1; q < KP; ++q)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[j][e] += red[((q - 1) * FW + fg) * kPerWarp + (j * 4 + e) * 32 + lane];
    }
  }
  // the split pass may launch now; it still waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  Acc* dst = gridDim.y == 1 ? out : ws + (size_t)blockIdx.y * m * r;
  if (kp == 0) {
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {   // C: rows are filters, columns rows of x
        const int i = j * 8 + 2 * t + (e & 1);
        const int f = e < 2 ? ra : rb;
        if (i < m && f < r) dst[(size_t)i * r + f] = acc[j][e];
      }
  }
}

template <class Op, int NT, int FW>
cudaError_t launch(const void* x, const void* packed, void* out, void* ws, int m, int r,
                   int words, int splits, int per, cudaStream_t stream) {
  auto kernel = mma_kernel<Op, NT, FW>;
  const int bytes = smem_bytes<NT, FW, Op::kWordBytes>(per);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted = false;   // allow kMaxSmem of dynamic shared memory, once
  if (!opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const dim3 grid((r + 16 * FW - 1) / (16 * FW), splits);
  const cudaError_t err = hopper::launch_dependent(
      kernel, grid, dim3(32 * kWarps<FW>), bytes, stream,
      static_cast<const typename Op::In*>(x), static_cast<const uint32_t*>(packed),
      static_cast<typename Op::Acc*>(out), static_cast<typename Op::Acc*>(ws), m, r, words,
      per);
  if (err != cudaSuccess || splits == 1) return err;
  return hopper::sum_splits(static_cast<const typename Op::Acc*>(ws),
                            static_cast<typename Op::Acc*>(out), (long long)m * r, splits,
                            stream);
}

template <class Op, int FW>
cudaError_t dispatch_nt(const void* x, const void* packed, void* out, void* ws, int m,
                        int r, int words, int splits, int per, cudaStream_t s) {
  switch ((m + 7) / 8) {
    case 1: return launch<Op, 1, FW>(x, packed, out, ws, m, r, words, splits, per, s);
    case 2: return launch<Op, 2, FW>(x, packed, out, ws, m, r, words, splits, per, s);
    case 3: return launch<Op, 3, FW>(x, packed, out, ws, m, r, words, splits, per, s);
    default: return launch<Op, 4, FW>(x, packed, out, ws, m, r, words, splits, per, s);
  }
}

// body 1 / 2 / 3 / 4: 16 / 32 / 64 / 128 filters a block. Checks the split: splits
// ranges of per words cover [0, words), none empty, and the workspace is
// there when K is split.
template <class Op>
cudaError_t run(int body, const void* x, const void* packed, void* out, void* ws, int m,
                int r, int words, int splits, int per, cudaStream_t s) {
  if (splits < 1 || splits > 65535 || per < 1 || (long long)splits * per < words ||
      (long long)(splits - 1) * per >= words || (splits > 1 && ws == nullptr))
    return cudaErrorInvalidValue;
  if (body == 1) return dispatch_nt<Op, 1>(x, packed, out, ws, m, r, words, splits, per, s);
  if (body == 2) return dispatch_nt<Op, 2>(x, packed, out, ws, m, r, words, splits, per, s);
  if (body == 3) return dispatch_nt<Op, 4>(x, packed, out, ws, m, r, words, splits, per, s);
  return dispatch_nt<Op, 8>(x, packed, out, ws, m, r, words, splits, per, s);
}

}  // namespace decode
