// Kernel B3: decode-time XNOR-popcount matvec on packed words, m <= 32 rows.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_xnor.py:147
// `tiled_xnor_matvec_unique` (body `_xnor_kernel`, SWAR `popcount32`).
//
//   x       (m, words) int32: sign-packed activation rows, bit (c % 32) of
//           word c / 32 is x[i, c] > 0; pad bits 0
//   packed  (r, words) int32: row-packed tile, bit 1 -> +1, bit 0 -> -1;
//           pad bits 0
//   out     (m, r) int32: acc[i, j] = n_in - 2 * sum_w popc(x[i,w] ^ t[j,w])
//
// Pad bits are 0 on both operands, so their XOR is 0 and no mask is needed.
//
// What bounds it on an H100: memory and launch. A decode tick reads every
// tile word once against m = n_slots packed activation rows: one 4-byte
// word read per m XOR + popcount pairs. At the data-sheet rates (3.35 TB/s,
// 1,979 int8 TOPS with one xnor word counted as 2 operations) the word read
// is the larger time by far, and at the per-layer sizes of the main path
// (r = 128..6144 rows, 64 KB to 3 MB of words) the whole read is shorter
// than a launch: what a call costs is its fixed cost, and whether x is read
// again for every filter and the lanes' sums reduced once per row of x.
//
// Two bodies; the wrapper's planner (`plan_xnor`) picks one per call:
//
// "popc" (CUDA cores, the first port's layout): four warps share each output row
// j, splitting its words (warp p takes words p*32 + lane, stepping by 128),
// and a block holds two rows. Lane l reads one tile word, then for every
// row i < m the activation word x[i, w] (the m rows are a few KB and stay
// in L1), and adds popc(x ^ t) into an int32 register. A warp shuffle sums
// the lanes and the four partial sums of a row are added through shared
// memory. x is read again for every filter and each row costs 5 shuffles a
// warp, so its time grows with m; it needs no K split and wins at small m.
//
// "bmma16" / "bmma32" / "bmma64" / "bmma128" (tensor cores): out is
// computed transposed, out[:, f0:f0+16]^T = T[f0:f0+16] . x^T, with the
// 1-bit form `mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc`,
// which consumes the packed words as they are:
//  * A is 16 filters x 256 bits, eight words of each filter row: lane
//    (g, t) holds words t and 4 + t of rows g and g + 8. B is 256 bits of 8
//    rows of x: words t and 4 + t of row g. Bit c of a word is column c on
//    both, as the tile and quantize_sign pack them.
//  * It gives C = popc(t AND x); popc(x XOR t) = popc(x) + popc(t) - 2 C,
//    so acc = n_in - 2 (px + pt) + 4 C, where px and pt are the popcounts
//    of the row of x and of the filter over the same words. Each lane
//    counts the words it feeds the mma with __popc (XorOp::step), and each
//    warp folds the counts into its accumulators (XorOp::finish); split 0
//    adds n_in.
//    Pad bits, words past a split's end (zero-filled up to a whole step of
//    8 words) and rows past m are 0 and add 0 to C, px and pt. Integer sums
//    are exact, so any split gives the plain version's bits.
//  * The `.xor.popc` form would give popc(x XOR t) directly, but ptxas
//    lowers it on sm_90a to a sequence around the AND instruction, 6.6x
//    slower (PERF.md §6, `python -m repro_torch.kernels.bmma_probe`).
//  * The block, its K split and staging are decode_mma.cuh's (shared with
//    B1 and B4; x rows are 4 bytes a word). K is whole in a block or split
//    at most 8 times, and the K splits of a filter tile add their partial
//    tiles in a thread-block cluster through distributed shared memory:
//    one launch, no workspace. The planner picks the body and the split
//    per call, and takes "popc" where K is too long for 8 splits.
// Both bodies are dependent launches (hopper::launch_dependent): each is set
// up while the kernel before it on the stream runs.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_mma.cuh"

namespace {

constexpr int kSplit = 4;         // warps sharing one output row
constexpr int kRowsPerBlock = 2;
constexpr int kThreads = kSplit * kRowsPerBlock * 32;

template <int MT>
__global__ void __launch_bounds__(kThreads)
xnor_kernel(const uint32_t* __restrict__ x, const uint32_t* __restrict__ packed,
            int32_t* __restrict__ out, int m, int r, int words, int n_in) {
  __shared__ int32_t partial[kRowsPerBlock][kSplit][MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_local = warp / kSplit, part = warp % kSplit;
  const int j = blockIdx.x * kRowsPerBlock + row_local;
  int32_t acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0;

  hopper::wait_prior_grid();   // a dependent launch (hopper_gemm.cuh)
  if (j < r) {
    const uint32_t* prow = packed + (size_t)j * words;
    for (int w = part * 32 + lane; w < words; w += kSplit * 32) {
      const uint32_t t = __ldg(prow + w);
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m)  // warp-uniform
          acc[i] += __popc(__ldg(x + (size_t)i * words + w) ^ t);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    int32_t s = acc[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) partial[row_local][part][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < kRowsPerBlock * MT) {
    const int rl = threadIdx.x / MT, i = threadIdx.x % MT;
    const int jj = blockIdx.x * kRowsPerBlock + rl;
    if (jj < r && i < m) {
      int32_t pop = 0;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) pop += partial[rl][p][i];
      out[(size_t)i * r + jj] = n_in - 2 * pop;
    }
  }
}

template <int MT>
cudaError_t launch_popc(const void* x, const void* packed, void* out, int m, int r,
                        int words, int n_in, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  return hopper::launch_dependent(xnor_kernel<MT>, grid, dim3(kThreads), 0, stream,
                                 static_cast<const uint32_t*>(x),
                                 static_cast<const uint32_t*>(packed),
                                 static_cast<int32_t*>(out), m, r, words, n_in);
}

cudaError_t dispatch_popc(const void* x, const void* packed, void* out, int m, int r,
                          int words, int n_in, cudaStream_t s) {
  if (m <= 1) return launch_popc<1>(x, packed, out, m, r, words, n_in, s);
  if (m <= 2) return launch_popc<2>(x, packed, out, m, r, words, n_in, s);
  if (m <= 4) return launch_popc<4>(x, packed, out, m, r, words, n_in, s);
  if (m <= 8) return launch_popc<8>(x, packed, out, m, r, words, n_in, s);
  if (m <= 16) return launch_popc<16>(x, packed, out, m, r, words, n_in, s);
  return launch_popc<32>(x, packed, out, m, r, words, n_in, s);
}

// ------------------------------------------------------- tensor-core body
// decode_mma.cuh's Op for sign-packed x: a word covers 4 bytes of a row;
// one m16n8k256 step takes 8 words.
struct XnorOp {
  using In = uint32_t;
  using Acc = int;
  static constexpr int kWordBytes = 4;
  static constexpr int kStepWords = 8;

  // The popcounts of the words a lane feeds the mma: of filters g and
  // g + 8, and of x rows 8j + g.
  template <int NT>
  struct Counts {
    int a = 0, b = 0, x[NT] = {};
  };

  // acc[j] += popc(T[16 filters, 8 words] AND x[8j.., 8 words]): wa / wb
  // point at the step's words of filters g and g + 8, xw at this lane's x
  // row of the step in shared memory (row pitch xp bytes); the words'
  // popcounts go to cnt.
  template <int NT>
  __device__ __forceinline__ static void step(int (&acc)[NT][4], Counts<NT>& cnt,
                                              const uint32_t* wa, const uint32_t* wb,
                                              const uint8_t* xw, int xp, int t) {
    const uint32_t a0 = wa[t], a1 = wb[t], a2 = wa[4 + t], a3 = wb[4 + t];
    cnt.a += __popc(a0) + __popc(a2);
    cnt.b += __popc(a1) + __popc(a3);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint32_t* b = reinterpret_cast<const uint32_t*>(xw + j * 8 * xp);
      const uint32_t b0 = b[t], b1 = b[4 + t];
      cnt.x[j] += __popc(b0) + __popc(b1);
      asm(
          "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
          : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }

  // acc = 4 C - 2 (px + pt) over this warp's words: the four lanes of a
  // group add their counts, and C's columns 2t, 2t + 1 (x rows) take px
  // from the lanes of groups 2t and 2t + 1.
  template <int NT>
  __device__ __forceinline__ static void finish(int (&acc)[NT][4], Counts<NT>& cnt, int t) {
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      cnt.a += __shfl_xor_sync(0xffffffffu, cnt.a, off);
      cnt.b += __shfl_xor_sync(0xffffffffu, cnt.b, off);
#pragma unroll
      for (int j = 0; j < NT; ++j) cnt.x[j] += __shfl_xor_sync(0xffffffffu, cnt.x[j], off);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int p0 = __shfl_sync(0xffffffffu, cnt.x[j], 8 * t);
      const int p1 = __shfl_sync(0xffffffffu, cnt.x[j], 8 * t + 4);
      acc[j][0] = 4 * acc[j][0] - 2 * (cnt.a + p0);
      acc[j][1] = 4 * acc[j][1] - 2 * (cnt.a + p1);
      acc[j][2] = 4 * acc[j][2] - 2 * (cnt.b + p0);
      acc[j][3] = 4 * acc[j][3] - 2 * (cnt.b + p1);
    }
  }
};

}  // namespace

// body: 0 popc, 1 / 2 / 3 / 4 the tensor-core body over 16 / 32 / 64 / 128
// filters a block, its K in `splits` ranges of `words_per_split` words (at
// most 8, a multiple of 8 words when split), added in a cluster.
extern "C" int tbn_tiled_xnor(const void* x, const void* packed, void* out, int m, int r,
                              int words, int n_in, int body, int splits,
                              int words_per_split, void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1 || n_in < 1 || n_in > words * 32 ||
      body < 0 || body > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) return (int)dispatch_popc(x, packed, out, m, r, words, n_in, s);
  return (int)decode::run<XnorOp>(body, x, packed, out, nullptr, m, r, words, splits,
                                  words_per_split, s, n_in);
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
