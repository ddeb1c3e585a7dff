// Probe of the 1-bit tensor-core form on the toolkit and card at hand; not a
// kernel of the port. `python -m repro_torch.kernels.bmma_probe` compiles it
// twice for sm_90a, once with the AND form of
//   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.{and,xor}.popc
// and once (-DPROBE_XOR) with the XOR form, reads which tensor-core
// instruction each library's SASS holds, checks the b1 fragment layout that
// kernel B3's tensor-core body assumes (csrc/tiled_xnor.cu) on one tile, and
// times a tight loop of the b1 instruction against the s8 m16n8k32 one.
#include <cuda_runtime.h>
#include <stdint.h>

#ifdef PROBE_XOR
#define PROBE_BITOP "xor"
#else
#define PROBE_BITOP "and"
#endif

namespace {

__device__ __forceinline__ void bmma(int (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32." PROBE_BITOP ".popc "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void imma(int (&c)[4], const uint32_t (&a)[4],
                                     const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One m16n8k256 on a 16 x 8-word A and an 8 x 8-word B, with the fragment
// layout of the PTX ISA's .b1 figures: lane (g, t) holds words t and 4 + t
// of A rows g and g + 8 (a0..a3) and of B row g (b0, b1).
__global__ void tile_kernel(const uint32_t* a_words, const uint32_t* b_words, int* c) {
  const int lane = threadIdx.x, g = lane >> 2, t = lane & 3;
  const uint32_t a[4] = {a_words[g * 8 + t], a_words[(g + 8) * 8 + t],
                         a_words[g * 8 + 4 + t], a_words[(g + 8) * 8 + 4 + t]};
  const uint32_t b[2] = {b_words[g * 8 + t], b_words[g * 8 + 4 + t]};
  int acc[4] = {0, 0, 0, 0};
  bmma(acc, a, b);
  c[g * 8 + 2 * t] = acc[0];
  c[g * 8 + 2 * t + 1] = acc[1];
  c[(g + 8) * 8 + 2 * t] = acc[2];
  c[(g + 8) * 8 + 2 * t + 1] = acc[3];
}

// `iters` rounds of CH independent accumulator chains per warp (CH = 1:
// the dependent latency; CH = 8: the issue rate).
template <bool B1, int CH>
__global__ void loop_kernel(int iters, uint32_t seed, int* out) {
  uint32_t a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = seed * (threadIdx.x + 7 * i + 1);
  b[0] = seed ^ threadIdx.x;
  b[1] = seed + blockIdx.x;
  int c[CH][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      if constexpr (B1) bmma(c[ch], a, b);
      else imma(c[ch], a, b);
    }
  }
  int s = 0;
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) s += c[ch][0] + c[ch][1] + c[ch][2] + c[ch][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

}  // namespace

extern "C" int probe_tile(const void* a, const void* b, void* c, void* stream) {
  tile_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), static_cast<int*>(c));
  return (int)cudaGetLastError();
}

// kind: 0 b1 issue rate, 1 b1 latency, 2 s8 issue rate, 3 s8 latency
extern "C" int probe_loop(int kind, int blocks, int threads, int iters, void* out,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (kind == 0) loop_kernel<true, 8><<<blocks, threads, 0, s>>>(iters, 0x9E3779B9u, o);
  else if (kind == 1) loop_kernel<true, 1><<<blocks, threads, 0, s>>>(iters, 0x9E3779B9u, o);
  else if (kind == 2) loop_kernel<false, 8><<<blocks, threads, 0, s>>>(iters, 0x9E3779B9u, o);
  else loop_kernel<false, 1><<<blocks, threads, 0, s>>>(iters, 0x9E3779B9u, o);
  return (int)cudaGetLastError();
}
