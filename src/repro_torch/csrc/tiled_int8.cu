// Kernel B4: decode-time int8 x binary matvec on packed words, m <= 32 rows.
//
// Replaces the Pallas TPU kernel repro/kernels/tiled_xnor.py:235
// `tiled_int8_matvec_unique` (body `_int8_kernel`, `_unpack_bits01`).
//
//   q       (m, k) int8, row-major, k = words * 32, zero pad columns
//   packed  (r, words) int32: bit (c % 32) of word c / 32 of row j is
//           T[j, c], bit 1 -> +1, bit 0 -> -1
//   out     (m, r) int32: acc[i, j] = sum_c q[i, c] * T[j, c]
//
// Pad columns of q are zero, so pad bits of the tile never contribute. The
// reference folds its {0, 1} product as 2 * (q . bits) - rowsum(q); this
// kernel multiplies by the ±1 bytes directly, which is the same integer.
//
// What bounds it on an H100: memory and launch. A decode tick reads every
// tile word once against m = n_slots int8 rows (4 bytes of words per 32 * m
// int8 multiply-adds); at the data-sheet rates (3.35 TB/s, 1,979 int8 TOPS)
// the word read is the larger time by far. Each word must become 32 signed
// bytes before `dp4a` can use it, which costs about 40 integer instructions
// per word, shared by the m rows; at the per-layer sizes of the main path
// the whole read is shorter than the launch latency, so what matters first
// is that all 132 SMs have work (a layer has only r = 128..6144 rows).
//
// Two bodies; the wrapper's planner (`plan_int8`) picks one per call:
//
// "dp4a" (the PR 12 layout, CUDA cores): four warps share each output row
// j, splitting its words, and a block holds two rows. Lane l reads one tile
// word and expands each nibble to four ±1 bytes in one register
// (`pm1_bytes`: spreading the nibble's bits to the low bit of each byte is a
// multiply by 0x00204081 and a mask, and a byte b in {0, 1} becomes 0xFF ^
// (b * 0xFE), i.e. -1 or +1). Then, for every row i < m, it reads the 32
// int8 values q[i, 32w : 32w + 32] (the m rows stay in L1) and accumulates
// eight `__dp4a` into a register. A warp shuffle and a sum over the four
// warps finish a row. Eight dp4a per word per row: its cost grows with m,
// and q is read again for every filter, so it wins only at small m.
//
// "mma16" / "mma32" / "mma64" / "mma128" (tensor cores): out is computed
// transposed, out[:, f0:f0+16]^T = T[f0:f0+16] . q^T, with
// `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`:
//  * A is 16 filters x 32 k, exactly one packed word per filter row per
//    instruction. Lane (g, t) holds rows g and g + 8, columns 4t..4t+3 and
//    16+4t..16+4t+3: `pm1_bytes` of the word's nibbles t and 4 + t, four
//    registers from two words. The ±1 bytes exist only in registers.
//  * B is q^T with N = 8 * ceil(m / 8) (rows past m are zero): one
//    m16n8k32 per n-tile of 8 rows and word, so a word costs one A build
//    and N / 8 mma whatever m is, and q is staged once per block instead of
//    read once per filter.
//  * The block, its K split and the split's reduction are decode_mma.cuh's
//    (shared with B1): four warps over 16, 32 or 64 filters, or eight over
//    128 (the body's name); K split over blocks until a wave of blocks
//    runs; each block copies its whole split of q and of the words into
//    shared memory with one cp.async burst and waits once. The splits' exact int32 partial
//    tiles go to a workspace that a second kernel adds (any order would give
//    the same bits; the fixed one is B1's). Chosen over atomicAdd into a
//    zeroed output, which costs the same second graph node (the zero fill)
//    and adds splits * m * r atomics in L2.
// Why mma.sync and not the warpgroup form: `wgmma ... .s32.s8.s8` does take
// its A operand from registers (CUTLASS's SM90_64xNx32_S32S8S8_RS_TN
// atoms), but a warpgroup covers 64 filters, and at N <= 32 a call's time
// is the word read and its fixed cost, not the tensor-core rate: 64-filter
// tiles leave the small layers (k/v: 128 filters) with two tiles, and the
// m16n8k32 tile lets a block cover 16 filters.
// The TPU kernel's block sizes were for the MXU and do not carry over.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_mma.cuh"

namespace {

constexpr int kSplit = 4;         // warps sharing one output row
constexpr int kRowsPerBlock = 2;
constexpr int kThreads = kSplit * kRowsPerBlock * 32;

// Four ±1 int8 values (bit 1 -> +1, bit 0 -> -1) from the low nibble of n
__device__ __forceinline__ int pm1_bytes(uint32_t n) {
  const uint32_t b01 = ((n & 0xFu) * 0x00204081u) & 0x01010101u;
  return (int)(0xFFFFFFFFu ^ (b01 * 0xFEu));
}

template <int MT>
__global__ void __launch_bounds__(kThreads)
int8_kernel(const int8_t* __restrict__ q, const uint32_t* __restrict__ packed,
            int32_t* __restrict__ out, int m, int r, int words) {
  __shared__ int32_t partial[kRowsPerBlock][kSplit][MT];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row_local = warp / kSplit, part = warp % kSplit;
  const int j = blockIdx.x * kRowsPerBlock + row_local;
  const size_t k = (size_t)words * 32;
  int32_t acc[MT];
#pragma unroll
  for (int i = 0; i < MT; ++i) acc[i] = 0;

  hopper::wait_prior_grid();   // a dependent launch (hopper_gemm.cuh)
  if (j < r) {
    const uint32_t* prow = packed + (size_t)j * words;
    for (int w = part * 32 + lane; w < words; w += kSplit * 32) {
      const uint32_t t = __ldg(prow + w);
      int pm[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) pm[c] = pm1_bytes(t >> (4 * c));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        if (i < m) {  // warp-uniform
          const int4* qp = reinterpret_cast<const int4*>(q + i * k + (size_t)w * 32);
          const int4 a = __ldg(qp), b = __ldg(qp + 1);
          int s = acc[i];
          s = __dp4a(a.x, pm[0], s);
          s = __dp4a(a.y, pm[1], s);
          s = __dp4a(a.z, pm[2], s);
          s = __dp4a(a.w, pm[3], s);
          s = __dp4a(b.x, pm[4], s);
          s = __dp4a(b.y, pm[5], s);
          s = __dp4a(b.z, pm[6], s);
          s = __dp4a(b.w, pm[7], s);
          acc[i] = s;
        }
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
      int32_t s = 0;
#pragma unroll
      for (int p = 0; p < kSplit; ++p) s += partial[rl][p][i];
      out[(size_t)i * r + jj] = s;
    }
  }
}

template <int MT>
cudaError_t launch_dp4a(const void* q, const void* packed, void* out, int m, int r,
                        int words, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  return hopper::launch_dependent(int8_kernel<MT>, grid, dim3(kThreads), 0, stream,
                                 static_cast<const int8_t*>(q),
                                 static_cast<const uint32_t*>(packed),
                                 static_cast<int32_t*>(out), m, r, words);
}

cudaError_t dispatch_dp4a(const void* q, const void* packed, void* out, int m, int r,
                          int words, cudaStream_t s) {
  if (m <= 1) return launch_dp4a<1>(q, packed, out, m, r, words, s);
  if (m <= 2) return launch_dp4a<2>(q, packed, out, m, r, words, s);
  if (m <= 4) return launch_dp4a<4>(q, packed, out, m, r, words, s);
  if (m <= 8) return launch_dp4a<8>(q, packed, out, m, r, words, s);
  if (m <= 16) return launch_dp4a<16>(q, packed, out, m, r, words, s);
  return launch_dp4a<32>(q, packed, out, m, r, words, s);
}

// ------------------------------------------------------- tensor-core body
// decode_mma.cuh's Op for int8 q: a packed word covers 32 bytes of a row,
// one m16n8k32 step.
struct S8Op {
  using In = int8_t;
  using Acc = int;
  static constexpr int kWordBytes = 32;

  // acc[j] += T[16 filters, one word] . q[8j.., the word's 32 columns]^T:
  // lane (g, t) holds rows g, g + 8 and columns 4t.., 16 + 4t.. of A, the
  // nibbles t and 4 + t of the words wa / wb as ±1 bytes.
  template <int NT>
  __device__ __forceinline__ static void word(int (&acc)[NT][4], uint32_t wa, uint32_t wb,
                                              const uint8_t* qw, int xp, int t) {
    const uint32_t a[4] = {(uint32_t)pm1_bytes(wa >> (4 * t)),
                           (uint32_t)pm1_bytes(wb >> (4 * t)),
                           (uint32_t)pm1_bytes(wa >> (16 + 4 * t)),
                           (uint32_t)pm1_bytes(wb >> (16 + 4 * t))};
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const uint8_t* b = qw + j * 8 * xp + 4 * t;
      asm(
          "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
          "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
          : "+r"(acc[j][0]), "+r"(acc[j][1]), "+r"(acc[j][2]), "+r"(acc[j][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
            "r"(*reinterpret_cast<const uint32_t*>(b)),
            "r"(*reinterpret_cast<const uint32_t*>(b + 16)));
    }
  }
};

}  // namespace

// body: 0 dp4a, 1 / 2 / 3 / 4 the tensor-core body over 16 / 32 / 64 / 128
// filters a block. With splits > 1 the tensor-core body needs `ws` (splits * m * r
// int32) for the split pass.
extern "C" int tbn_tiled_int8(const void* q, const void* packed, void* out, void* ws,
                              int m, int r, int words, int body, int splits,
                              int words_per_split, void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1 || body < 0 || body > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0) return (int)dispatch_dp4a(q, packed, out, m, r, words, s);
  return (int)decode::run<S8Op>(body, q, packed, out, ws, m, r, words, splits,
                                words_per_split, s);
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
