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
// Design (kernel B1's layout, integer arithmetic): four warps share each
// output row j, splitting its words (warp p takes words p*32 + lane,
// stepping by 128: each warp reads 128 contiguous bytes of T[j] per step),
// and a block holds two rows. Lane l reads one tile word and expands each
// nibble to four ±1 bytes in one register: spreading the nibble's bits to
// the low bit of each byte is a multiply by 0x00204081 (the shifted copies
// do not overlap) and a mask, and a byte b in {0, 1} becomes 0xFF ^ (b *
// 0xFE), i.e. -1 or +1. Then, for every row i < m, it reads the 32 int8
// values q[i, 32w : 32w + 32] (two 16-byte loads; the m rows are a few KB
// to a few tens of KB and stay in L1) and accumulates eight `__dp4a`
// (int8 x int8 -> int32) into a register. A warp shuffle sums the lanes and
// the four partial sums of a row are added through shared memory; integer
// sums are exact, so the result is bit-identical to the plain version in
// any order. The TPU kernel's block sizes were for the MXU and do not carry
// over; `mma.sync` s8 (m16n8k32) is the tensor-core route for a later
// version. m is a template bucket (1, 2, 4, 8, 16, 32); rows past m are
// never read.
#include <cuda_runtime.h>
#include <stdint.h>

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
cudaError_t launch(const void* q, const void* packed, void* out, int m, int r,
                   int words, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  int8_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const uint32_t*>(packed),
      static_cast<int32_t*>(out), m, r, words);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tbn_tiled_int8(const void* q, const void* packed, void* out,
                              int m, int r, int words, void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m <= 1) err = launch<1>(q, packed, out, m, r, words, s);
  else if (m <= 2) err = launch<2>(q, packed, out, m, r, words, s);
  else if (m <= 4) err = launch<4>(q, packed, out, m, r, words, s);
  else if (m <= 8) err = launch<8>(q, packed, out, m, r, words, s);
  else if (m <= 16) err = launch<16>(q, packed, out, m, r, words, s);
  else err = launch<32>(q, packed, out, m, r, words, s);
  return (int)err;
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
