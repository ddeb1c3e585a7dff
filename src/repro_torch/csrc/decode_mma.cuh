// Shared tensor-core body of kernels B1 (tiled_matvec.cu, bf16 x), B3
// (tiled_xnor.cu, sign-packed x) and B4 (tiled_int8.cu, int8 q): a decode
// matvec, m <= 32 rows, whose weight is a bit-packed ±1 tile. Each source
// supplies an Op (element type, accumulator type, bytes of x a packed word
// covers, and the product: B1 and B4 take one word a step, the ±1 A
// fragment built in registers and one `mma.sync` per n-tile of 8 rows; B3
// takes eight words a step, the words themselves as a 1-bit A fragment,
// and adds an integer epilogue, see Op hooks below).
//
// The body computes out transposed, out[:, f0:f0+16]^T = T[f0:f0+16] . x^T:
//  * A block is max(4, FW) warps over 16 * FW filters (FW = 1, 2, 4, 8);
//    the warps of one 16-filter group split the block's words between them
//    and add their accumulators in a fixed order through shared memory at
//    the end.
//  * K is split over blocks (grid.y). A block copies all of its split at
//    once with cp.async: every row of x (8 * NT rows, zero past m; a row
//    pitch of 16 mod 128 bytes, so the eight rows a fragment load touches
//    fall on distinct banks) and every filter's words (an odd pitch, for
//    the same reason). It then waits once: one round trip to memory per
//    block, not one per word or chunk.
//  * One-word-step Ops (B1, B4) split K until a wave of blocks runs. Split
//    z writes its partial tile to slice z of a workspace, and a second
//    kernel adds the slices in the order z = 0, 1, ... with every SM: the
//    order never depends on which block finishes first, so repeated runs
//    are bit-identical; no float atomics. (Letting the last block of each
//    filter tile add its tile's slices, found through an int32 arrival
//    count, saves the second launch but was slower at every main-path
//    shape on an H100: one block reads every slice of its tile.)
//  * An Op with 8-word steps (B3) splits K at most kMaxCluster times, and
//    the splits of one filter tile form a thread-block cluster (grid.y =
//    cluster size): block z owns slice z of the tile; every block stores
//    each slice of its partial tile into the owner's shared memory
//    (distributed shared memory), and after one cluster barrier each owner
//    adds its slice's partials in the order 0, 1, ... and writes them to
//    out. One launch and no workspace.
//  * The kernels are dependent launches (hopper_gemm.cuh launch_dependent):
//    each is set up while the kernel before it on the stream runs, and
//    waits for it before touching memory; the body lets the next kernel
//    (the split pass) start once its products are done.
//
// Op hooks. Every Op has In, Acc, kWordBytes. One with no kStepWords takes
// one word a step: `word(acc, wa, wb, xw, xp, t)` with the words of filters
// g and g + 8. One with kStepWords = 8 (B3) takes `step(acc, cnt, wa, wb,
// xw, xp, t)` with pointers to the step's eight staged words of filters g
// and g + 8 and a per-warp `Counts<NT> cnt` of its own, has `finish(acc,
// cnt, t)` run by each warp on its accumulators after its last step, and
// gets `bias` added once to every output (by split 0). Its splits are
// whole steps, zero-filled up to a whole step when staged, and its filter
// words sit at a pitch of 4 mod 32 words (lane (g, t) reads word
// g * pitch + t: 32 distinct banks).
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper_gemm.cuh"   // cp.async helpers and the split-K pass

namespace decode {

// warps of a block over 16 * FW filters
template <int FW>
constexpr int kWarps = FW > 4 ? FW : 4;
constexpr int kMaxSmem = 96 * 1024;   // dynamic shared memory a block may take
constexpr int kMaxCluster = 8;        // blocks of a cluster (the portable limit)

// Words an Op takes a step: kStepWords where it has one, else 1.
template <class Op, class = void>
struct StepWords {
  static constexpr int value = 1;
};
template <class Op>
struct StepWords<Op, std::void_t<decltype(Op::kStepWords)>> {
  static constexpr int value = Op::kStepWords;
};
// An Op with 8-word steps adds its K splits in a cluster, the others by
// the split pass.
template <class Op>
constexpr bool kClusterSplits = StepWords<Op>::value > 1;

__host__ __device__ constexpr int round_up(int n, int step) {
  return (n + step - 1) / step * step;
}

// Bytes of one staged row of x for a split of n words (16-byte aligned and
// 16 mod 128), and words of one staged filter row (odd for 1-word steps, 4
// mod 32 for 8-word steps).
__host__ __device__ constexpr int x_pitch(int n, int word_bytes) {
  return (n * word_bytes + 127) / 128 * 128 + 16;
}
__host__ __device__ constexpr int w_pitch(int n, int step = 1) {
  return step == 1 ? (n | 1) : (n + 31) / 32 * 32 + 4;
}

// Bytes of the warps' partial sums that the warps of a group add, and of a
// block's partial tile when a cluster adds the splits.
template <int NT, int FW>
constexpr int kRedBytes = (kWarps<FW> / FW - 1) * FW * 32 * NT * 4 * 4;
template <int NT, int FW>
constexpr int kPart = FW * NT * 128;
template <int NT, int FW>
constexpr int kRecvBytes = (kPart<NT, FW> + 32 * kMaxCluster) * 4;

// entries of the slice of a partial tile each block of a cluster of
// `splits` owns (whole warps' worth)
__device__ __forceinline__ int slice_of(int part, int splits) {
  return ((part + splits - 1) / splits + 31) / 32 * 32;
}

// Dynamic shared memory of a block whose split has n words (S words a
// step): the staged x rows and filter words, or the warps' partial sums,
// whichever is larger, after (`cluster`: the splits form one) the slices
// that the cluster's blocks send to this one.
template <int NT, int FW, int WB, int S>
__host__ __device__ constexpr int smem_bytes(int n, bool cluster) {
  const int ns = round_up(n, S);
  const int stage = 8 * NT * x_pitch(ns, WB) + 16 * FW * w_pitch(ns, S) * 4;
  const int red = kRedBytes<NT, FW>;
  return (cluster ? kRecvBytes<NT, FW> : 0) + (stage > red ? stage : red);
}

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {   // release
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {     // acquire
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

using hopper::cp_async16;
using hopper::cp_async4;
using hopper::cp_async_wait_all;

// `rows` rows of `bytes` staged bytes each into shared memory (row pitch
// `pitch`) from global rows `src_pitch` bytes apart, in UNIT-byte copies;
// rows from `valid_rows` on and bytes from `valid` on are zero-filled.
template <int UNIT>
__device__ __forceinline__ void stage_rows(uint8_t* dst, int pitch, const uint8_t* src,
                                           size_t src_pitch, int rows, int valid_rows,
                                           int valid, int bytes, int threads) {
  const int units = bytes / UNIT;
  for (int u = threadIdx.x; u < rows * units; u += threads) {
    const int row = u / units, cu = u - row * units;
    const bool ok = row < valid_rows && cu * UNIT < valid;
    const uint8_t* s = ok ? src + row * src_pitch + cu * UNIT : src;
    if constexpr (UNIT == 16) cp_async16(dst + row * pitch + cu * 16, s, ok);
    else cp_async4(dst + row * pitch + cu * 4, s, ok);
  }
}

// Grid: filter tiles on x, K splits on y (split z covers words [z * per,
// (z + 1) * per); when there is more than one, it writes slice z of `ws`,
// splits * m * r, or with kClusterSplits<Op> the splits form a cluster).
template <class Op, int NT, int FW>
__global__ void __launch_bounds__(32 * kWarps<FW>)
mma_kernel(const typename Op::In* __restrict__ x, const uint32_t* __restrict__ packed,
           typename Op::Acc* __restrict__ out, typename Op::Acc* __restrict__ ws, int m,
           int r, int words, int per, int bias) {
  using Acc = typename Op::Acc;
  constexpr int KP = kWarps<FW> / FW;   // warps splitting a group's words
  constexpr int kThreads = 32 * kWarps<FW>;
  constexpr int WB = Op::kWordBytes;
  constexpr int S = StepWords<Op>::value;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int fg = warp % FW, kp = warp / FW;
  const int f0 = blockIdx.x * 16 * FW;
  const int ra = f0 + fg * 16 + g, rb = ra + 8;
  const int w0 = blockIdx.y * per, n = min(words, w0 + per) - w0;
  const int ns = round_up(n, S);   // staged words: whole steps
  const int xp = x_pitch(ns, WB), wp = w_pitch(ns, S);
  const bool clustered = kClusterSplits<Op> && gridDim.y > 1;
  // clustered: the slices peers send come first; then the staged split
  uint8_t* base = smem + (clustered ? kRecvBytes<NT, FW> : 0);
  uint8_t* xs = base;
  uint32_t* wsm = reinterpret_cast<uint32_t*>(base + 8 * NT * xp);
  if (clustered) cluster_arrive_relaxed();   // announce this block: peers
                                             // store into it later

  hopper::wait_prior_grid();   // a dependent launch (hopper_gemm.cuh)
  // the whole split, and the words [n, ns) of a last partial step: x rows
  // past m, filters past r and those words are zero-filled. 16-byte copies
  // where the rows allow them: x always for one-word steps (a word is 32
  // or 64 bytes of x), the filter words never then (an odd pitch).
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(x);
  const size_t row_bytes = (size_t)words * WB;
  const uint8_t* xsrc = xb + (size_t)w0 * WB;
  if (S == 1 || (row_bytes % 16 == 0 && reinterpret_cast<uintptr_t>(xb) % 16 == 0))
    stage_rows<16>(xs, xp, xsrc, row_bytes, 8 * NT, m, n * WB, ns * WB, kThreads);
  else
    stage_rows<4>(xs, xp, xsrc, row_bytes, 8 * NT, m, n * WB, ns * WB, kThreads);
  const uint8_t* wsrc = reinterpret_cast<const uint8_t*>(packed + (size_t)f0 * words + w0);
  uint8_t* wdst = reinterpret_cast<uint8_t*>(wsm);
  if (S > 1 && words % 4 == 0 && reinterpret_cast<uintptr_t>(packed) % 16 == 0)
    stage_rows<16>(wdst, wp * 4, wsrc, (size_t)words * 4, 16 * FW, r - f0, n * 4, ns * 4,
                   kThreads);
  else
    stage_rows<4>(wdst, wp * 4, wsrc, (size_t)words * 4, 16 * FW, r - f0, n * 4, ns * 4,
                  kThreads);
  cp_async_wait_all();
  __syncthreads();

  Acc acc[NT][4] = {};
  const uint32_t* wra = wsm + (fg * 16 + g) * wp;
  const uint32_t* wrb = wra + 8 * wp;
  const uint8_t* xg = xs + g * xp;
  if constexpr (S == 1) {
    const int part = (n + KP - 1) / KP, lo = kp * part, hi = min(n, lo + part);
#pragma unroll 2
    for (int lw = lo; lw < hi; ++lw)
      Op::template word<NT>(acc, wra[lw], wrb[lw], xg + lw * WB, xp, t);
  } else {
    const int steps = ns / S, part = (steps + KP - 1) / KP;
    const int lo = min(steps, kp * part), hi = min(steps, lo + part);
    typename Op::template Counts<NT> cnt;
#pragma unroll 2
    for (int s = lo; s < hi; ++s)
      Op::template step<NT>(acc, cnt, wra + s * S, wrb + s * S, xg + s * S * WB, xp, t);
    Op::template finish<NT>(acc, cnt, t);
  }

  if constexpr (KP > 1) {   // fixed-order sum of the warps of a group
    constexpr int kPerWarp = 32 * NT * 4;
    Acc* red = reinterpret_cast<Acc*>(base);
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
  if constexpr (S > 1) {   // the Op's constant, once per output
    if (blockIdx.y == 0) {
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += bias;
    }
  }
  // the next kernel may launch now; it still waits for this grid to finish
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  if constexpr (kClusterSplits<Op>) {
    if (clustered) {   // the splits of this filter tile are one cluster
      namespace cg = cooperative_groups;
      cg::cluster_group cluster = cg::this_cluster();
      constexpr int P = kPart<NT, FW>;   // entries of a partial tile
      Acc* recv = reinterpret_cast<Acc*>(smem);
      const int z = blockIdx.y, splits = gridDim.y, chunk = slice_of(P, splits);
      cluster_wait();   // every block of the cluster runs: its slots exist
      if (kp == 0) {    // entry idx goes to slot z of its owner's slice
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int idx = ((fg * NT + j) * 4 + e) * 32 + lane, owner = idx / chunk;
            cluster.map_shared_rank(recv, owner)[z * chunk + idx - owner * chunk] = acc[j][e];
          }
      }
      cluster_arrive();
      cluster_wait();   // every partial is in its owner's slots
      for (int k = threadIdx.x; k < chunk && z * chunk + k < P; k += kThreads) {
        Acc sum = 0;
        for (int q = 0; q < splits; ++q) sum += recv[q * chunk + k];
        const int idx = z * chunk + k;
        const int l = idx & 31, e = (idx >> 5) & 3, tile = idx >> 7;
        const int i = (tile % NT) * 8 + 2 * (l & 3) + (e & 1);
        const int f = f0 + tile / NT * 16 + (l >> 2) + (e < 2 ? 0 : 8);
        if (i < m && f < r) out[(size_t)i * r + f] = sum;
      }
      return;
    }
  }
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

// hopper::launch_dependent with the K splits of each filter tile as one
// cluster of `cluster_y` blocks along y.
template <class... KArgs, class... Args>
inline cudaError_t launch_dependent_cluster(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                                            size_t smem, cudaStream_t stream, int cluster_y,
                                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = 1;
  attr[1].val.clusterDim.y = cluster_y;
  attr[1].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

template <class Op, int NT, int FW>
cudaError_t launch(const void* x, const void* packed, void* out, void* ws, int m, int r,
                   int words, int splits, int per, int bias, cudaStream_t stream) {
  auto kernel = mma_kernel<Op, NT, FW>;
  constexpr int S = StepWords<Op>::value;
  const bool clustered = kClusterSplits<Op> && splits > 1;
  const int bytes = smem_bytes<NT, FW, Op::kWordBytes, S>(per, clustered);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  static bool opted = false;   // allow kMaxSmem of dynamic shared memory, once
  if (!opted) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const dim3 grid((r + 16 * FW - 1) / (16 * FW), splits);
  using In = typename Op::In;
  using Acc = typename Op::Acc;
  if (clustered)
    return launch_dependent_cluster(kernel, grid, dim3(32 * kWarps<FW>), bytes, stream,
                                    splits, static_cast<const In*>(x),
                                    static_cast<const uint32_t*>(packed),
                                    static_cast<Acc*>(out), static_cast<Acc*>(ws), m, r,
                                    words, per, bias);
  const cudaError_t err = hopper::launch_dependent(
      kernel, grid, dim3(32 * kWarps<FW>), bytes, stream, static_cast<const In*>(x),
      static_cast<const uint32_t*>(packed), static_cast<Acc*>(out), static_cast<Acc*>(ws),
      m, r, words, per, bias);
  if (err != cudaSuccess || splits == 1) return err;
  return hopper::sum_splits(static_cast<const Acc*>(ws), static_cast<Acc*>(out),
                            (long long)m * r, splits, stream);
}

template <class Op, int FW>
cudaError_t dispatch_nt(const void* x, const void* packed, void* out, void* ws, int m,
                        int r, int words, int splits, int per, int bias, cudaStream_t s) {
  switch ((m + 7) / 8) {
    case 1: return launch<Op, 1, FW>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    case 2: return launch<Op, 2, FW>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    case 3: return launch<Op, 3, FW>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    default: return launch<Op, 4, FW>(x, packed, out, ws, m, r, words, splits, per, bias, s);
  }
}

// body 1 / 2 / 3 / 4: 16 / 32 / 64 / 128 filters a block. Checks the split:
// splits ranges of per words cover [0, words), none empty, each a whole
// number of the Op's steps when split, the workspace there when the split
// pass adds them, and at most kMaxCluster splits in a cluster. `bias` only
// for an Op with 8-word steps.
template <class Op>
cudaError_t run(int body, const void* x, const void* packed, void* out, void* ws, int m,
                int r, int words, int splits, int per, cudaStream_t s, int bias = 0) {
  constexpr int S = StepWords<Op>::value;
  constexpr int kMost = kClusterSplits<Op> ? kMaxCluster : 65535;
  if (splits < 1 || splits > kMost || per < 1 || (long long)splits * per < words ||
      (long long)(splits - 1) * per >= words || (splits > 1 && per % S != 0) ||
      (splits > 1 && !kClusterSplits<Op> && ws == nullptr) || (S == 1 && bias != 0))
    return cudaErrorInvalidValue;
  switch (body) {
    case 1: return dispatch_nt<Op, 1>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    case 2: return dispatch_nt<Op, 2>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    case 3: return dispatch_nt<Op, 4>(x, packed, out, ws, m, r, words, splits, per, bias, s);
    default: return dispatch_nt<Op, 8>(x, packed, out, ws, m, r, words, splits, per, bias, s);
  }
}

}  // namespace decode
