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
// is the larger time by far. The popcount unit is the nearer limit: 16
// `popc` per SM per clock, so the 126 M popcounts of a granite-8b tick at
// m = 4 need about 30 us on 132 SMs, close to the 37.6 us word read; one
// word per lane keeps the two in step. At the per-layer sizes of the main
// path the whole read is shorter than the launch latency, so what matters
// first is that all 132 SMs have work: a layer has only r = 128..6144 rows.
//
// Design (kernel B1's layout with integer arithmetic): four warps share each
// output row j, splitting its words (warp p takes words p*32 + lane,
// stepping by 128: each warp reads 128 contiguous bytes of T[j] per step),
// and a block holds two rows. Lane l reads one tile word, then for every
// row i < m the activation word x[i, w] (the m rows are a few KB and stay
// in L1; the reads are coalesced along w), and adds popc(x ^ t) into an
// int32 register. A warp shuffle sums the lanes and the four partial sums
// of a row are added through shared memory; integer sums are exact, so the
// result is bit-identical to the plain version in any order. The TPU
// kernel's (W, r) transpose and block sizes were for the VPU and do not
// carry over. m is a template bucket (1, 2, 4, 8, 16, 32); rows past m are
// never read.
#include <cuda_runtime.h>
#include <stdint.h>

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
cudaError_t launch(const void* x, const void* packed, void* out, int m, int r,
                   int words, int n_in, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  xnor_kernel<MT><<<grid, kThreads, 0, stream>>>(
      static_cast<const uint32_t*>(x), static_cast<const uint32_t*>(packed),
      static_cast<int32_t*>(out), m, r, words, n_in);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tbn_tiled_xnor(const void* x, const void* packed, void* out,
                              int m, int r, int words, int n_in, void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1 || n_in < 1 || n_in > words * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (m <= 1) err = launch<1>(x, packed, out, m, r, words, n_in, s);
  else if (m <= 2) err = launch<2>(x, packed, out, m, r, words, n_in, s);
  else if (m <= 4) err = launch<4>(x, packed, out, m, r, words, n_in, s);
  else if (m <= 8) err = launch<8>(x, packed, out, m, r, words, n_in, s);
  else if (m <= 16) err = launch<16>(x, packed, out, m, r, words, n_in, s);
  else err = launch<32>(x, packed, out, m, r, words, n_in, s);
  return (int)err;
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
