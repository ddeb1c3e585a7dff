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
// handful of activation rows against every tile word once: one 32-bit word
// read per 32 * m multiply-adds, so the packed words are the only large
// operand and, at the per-layer sizes of the main path (r = 128..6144
// filters, 0.06-3 MB of words), the whole read takes about a microsecond.
// What the card must not do is leave SMs idle, read x again for every
// filter, or spend more instructions per word as m grows.
//
// Two bodies; the wrapper's planner (`plan_matvec`) picks one per call:
//
// "simt" (the PR 11 layout, CUDA cores; bf16 and f32 x): four warps share
// each output row j, splitting its words, and a block holds two rows. Lane
// l reads one word of T[j], loads the 32 activations it covers for every
// row i < m (x is tiny and stays in L1), and adds each with its sign
// flipped by the word's bit (an XOR of the float's sign bit). A warp
// shuffle and a fixed-order sum over the four warps finish a row. Its cost
// grows with m (32 sign-flip adds per word per row) and x is read again for
// every filter, so it wins only at small m, where it needs no K split.
//
// "mma16" / "mma32" / "mma64" / "mma128" (bf16 x, tensor cores): out is
// computed transposed, out[:, f0:f0+16]^T = T[f0:f0+16] . x^T, with
// `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
//  * A is the ±1 tile, 16 filters x 16 k, built in registers from the
//    packed words exactly as hopper_gemm.cuh's build_a does (0xBF80 is
//    -1.0; a set bit clears the sign): every lane reads the words of its
//    two filter rows (g and g + 8) and makes four bf16x2 registers per
//    half word. The dense ±1 tile exists nowhere else.
//  * B is x^T with N = 8 * ceil(m / 8) (8, 16, 24 or 32; rows past m are
//    zero). One m16n8k16 per n-tile of 8 rows and half word, so a word
//    costs one A build and N / 8 mma whatever m is, and x is staged once per
//    block instead of read once per filter.
//  * The block, its K split and the split's reduction are decode_mma.cuh's
//    (shared with B4): four warps over 16, 32 or 64 filters, or eight over
//    128 (the body's name); K split over blocks until a wave of blocks
//    runs; each block copies its whole split of x and of the words into
//    shared memory with one cp.async burst and waits once; a second kernel
//    adds the splits' partial tiles in a fixed order (no float atomics:
//    repeated runs are bit-identical).
// Why mma.sync and not hopper_gemm.cuh's wgmma mainloop: wgmma needs 64
// filters per warpgroup and a TMA ring with a producer warpgroup; at N <=
// 32 the ring's fill and the 64-filter tiles leave most SMs idle on the
// small layers (k/v has 128 filters), and at these sizes the time is the
// word read and the fixed cost of a call, not the tensor-core rate. The
// m16n8k16 A fragment is the layout wgmma's register A uses per warp, so
// both build it with hopper::pm1_pair.
// What bounds the tensor-core body on the card now (PERF.md §6): about 3.5
// us of fixed cost a call (the kernel and the split pass are two launches,
// overlapped by dependent launch) and, at m >= 16, x staged again by every
// filter tile and the tensor-core work of 2 * N / 8 mma a word.
// f32 x keeps the simt body: a TF32 product would round x to 10 mantissa
// bits, outside the f32 tolerance. Ragged m, r and K are masked: rows past
// m are zero in shared memory and never stored, filters past r read no
// word and are never stored.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_mma.cuh"   // includes hopper_gemm.cuh (pm1_pair)

namespace {

// ------------------------------------------------------------ simt body
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

  hopper::wait_prior_grid();   // a dependent launch (hopper_gemm.cuh)
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
cudaError_t launch_simt(const void* x, const void* packed, void* out, int m, int r,
                        int words, cudaStream_t stream) {
  const dim3 grid((r + kRowsPerBlock - 1) / kRowsPerBlock);
  return hopper::launch_dependent(matvec_kernel<T, MT>, grid, dim3(kThreads), 0, stream,
                                 static_cast<const T*>(x),
                                 static_cast<const uint32_t*>(packed),
                                 static_cast<float*>(out), m, r, words);
}

template <typename T>
cudaError_t dispatch_simt(const void* x, const void* packed, void* out, int m, int r,
                          int words, cudaStream_t s) {
  if (m <= 1) return launch_simt<T, 1>(x, packed, out, m, r, words, s);
  if (m <= 2) return launch_simt<T, 2>(x, packed, out, m, r, words, s);
  if (m <= 4) return launch_simt<T, 4>(x, packed, out, m, r, words, s);
  if (m <= 8) return launch_simt<T, 8>(x, packed, out, m, r, words, s);
  if (m <= 16) return launch_simt<T, 16>(x, packed, out, m, r, words, s);
  return launch_simt<T, 32>(x, packed, out, m, r, words, s);
}

// ------------------------------------------------------- tensor-core body
// decode_mma.cuh's Op for bf16 x: a packed word covers 32 bf16 = 64 bytes
// of a row, two m16n8k16 steps of 16 columns.
struct Bf16Op {
  using In = __nv_bfloat16;
  using Acc = float;
  static constexpr int kWordBytes = 64;

  // acc[j] += T[16 filters, one word] . x[8j.., the word's 32 columns]^T:
  // wa / wb are the words of filters g and g + 8, xw this lane's x row of
  // the word in shared memory (row pitch xp bytes).
  template <int NT>
  __device__ __forceinline__ static void word(float (&acc)[NT][4], uint32_t wa, uint32_t wb,
                                              const uint8_t* xw, int xp, int t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // 16 columns each: bits 16h ..
      const int bit = 16 * h + 2 * t;
      const uint32_t a[4] = {hopper::pm1_pair(wa, bit), hopper::pm1_pair(wb, bit),
                             hopper::pm1_pair(wa, bit + 8), hopper::pm1_pair(wb, bit + 8)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* b = xw + j * 8 * xp + 32 * h + 4 * t;
        asm(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]),
              "r"(*reinterpret_cast<const uint32_t*>(b)),
              "r"(*reinterpret_cast<const uint32_t*>(b + 16)));
      }
    }
  }
};

}  // namespace

// body: 0 simt (bf16 or f32 x), 1 / 2 / 3 / 4 the tensor-core body over 16
// / 32 / 64 / 128 filters a block (bf16 only). With splits > 1 the tensor-core body
// needs `ws` (splits * m * r floats) for the split pass.
extern "C" int tbn_tiled_matvec(const void* x, const void* packed, void* out, void* ws,
                                int m, int r, int words, int x_is_bf16,
                                int body, int splits, int words_per_split,
                                void* stream) {
  if (m < 1 || m > 32 || r < 1 || words < 1 || body < 0 || body > 4)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (body == 0)
    return (int)(x_is_bf16 ? dispatch_simt<__nv_bfloat16>(x, packed, out, m, r, words, s)
                           : dispatch_simt<float>(x, packed, out, m, r, words, s));
  if (!x_is_bf16) return (int)cudaErrorInvalidValue;
  return (int)decode::run<Bf16Op>(body, x, packed, out, ws, m, r, words, splits,
                                  words_per_split, s);
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
