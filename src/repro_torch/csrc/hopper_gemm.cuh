// Shared Hopper mainloop of kernels B2 (tiled_matmul.cu) and B6
// (tiled_conv.cu): a bf16 GEMM whose one operand is a bit-packed ±1 tile.
//
// Both kernels compute a transposed output tile,
//   out[m0:m0+BN, f0:f0+BM]^T = T[f0:f0+BM, :] . X[m0:m0+BN, :]^T,
// with `wgmma.mma_async.m64nNk16.f32.bf16.bf16` in its register-A form:
//  * A is the ±1 tile (BM filters x 16 k per instruction). Each warp of a
//    consumer warpgroup owns 16 filter rows; its A fragment has the
//    `mma.sync` m16n8k16 A layout, so every lane builds its four bf16x2
//    registers straight from two packed words (0xBF80 is -1.0; a set bit
//    clears the sign). The ±1 tile exists only in registers.
//  * B is a tile of X in shared memory, K-major (rows of x, or im2col rows
//    of pixels), 64 bf16 = 128 bytes a row in the 128-byte swizzle: byte
//    (row, c) of a tile lives at row*128 + ((c/16) ^ (row % 8))*16 + c%16,
//    the layout TMA's SWIZZLE_128B writes and the descriptor below reads.
// The K loop runs over "stages" of 64 columns (two packed words per filter
// row). A ring of kStages stages sits in shared memory with a full and an
// empty mbarrier each; one producer warpgroup fills it (B2: TMA for the x
// tiles; B6: the im2col gather with cp.async; both: TMA for the words where
// their rows are 16-byte aligned, else cp.async) while two consumer
// warpgroups issue wgmma on the stages that have arrived. The epilogue
// stages the f32 tile through shared memory (reusing the ring) and writes
// whole rows of out (m, r) with 16-byte stores.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

constexpr int kStageK = 64;        // bf16 columns per stage
constexpr int kStageWords = 2;     // packed words per filter row per stage
constexpr int kRowBytes = 128;     // one swizzled row of an x tile
constexpr int kStages = 6;         // even: stages come in pairs (Ring)
constexpr int kConsumers = 2;      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);

// SLABS: 64-filter slabs per consumer warpgroup; BN: rows of x per tile.
template <int SLABS, int BN>
struct Tile {
  static constexpr int kBM = 64 * SLABS * kConsumers;  // filters per tile
  static constexpr int kXBytes = BN * kRowBytes;
  // words of a pair of stages: [filter][4] uint32 (16 bytes a filter)
  static constexpr int kPairWBytes = kBM * 2 * kStageWords * 4;
  static constexpr int kRingBytes = kStages * kXBytes + kStages / 2 * kPairWBytes;
  static constexpr int kOutPitch = kBM + 4;            // floats; conflict-free
  static constexpr int kEpiBytes = BN * kOutPitch * 4;
  static constexpr int kSmemBytes =
      (kRingBytes > kEpiBytes ? kRingBytes : kEpiBytes) + 1024;  // + alignment
};

// ------------------------------------------------------------- primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Expect `bytes` more transaction bytes in the current phase (no arrival).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// TMA tile loads into shared memory, completing `bytes` on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const void* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const void* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// `bytes` (4 or 16) from global to shared; valid == false zero-fills.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Wait for all of this thread's cp.async copies, committed or not.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The barrier's phase counts one arrival of this thread once all of its
// earlier cp.async copies have landed.
__device__ __forceinline__ void cp_async_arrive_noinc(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

// Make this thread's generic-proxy shared-memory writes visible to the
// async proxy (wgmma reads its B operand through it).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier 1 over the 256 consumer threads (the producer does not join).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(128 * kConsumers) : "memory");
}

__device__ __forceinline__ uint32_t pm1_pair(uint32_t word, int bit) {
  // bf16x2 of (T[bit], T[bit+1]): -1.0 is 0xBF80, a set bit clears the sign
  const uint32_t lo = (word >> bit) & 1u;
  const uint32_t hi = (word >> (bit + 1)) & 1u;
  return 0xBF80BF80u ^ ((lo << 15) | (hi << 31));
}

// wgmma descriptor of a K-major tile in the 128-byte swizzle: 1024-byte
// aligned base, 8-row groups 1024 bytes apart (stride byte offset), the
// leading byte offset unused (1), layout type 1 (SWIZZLE_128B). Adding
// 2 to it moves 32 bytes = 16 bf16 along K.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  const uint64_t addr = smem_u32(tile);
  return ((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D(64 x N, f32) += A(64 x 16, bf16 registers) . B(16 x N, bf16 shared).
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[64], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}


__device__ __forceinline__ void wgmma_rs(float (&d)[128], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// The producer warpgroup gives registers to the consumers where the
// accumulators need them (128 f32 a thread).
template <int SLABS, int BN>
__device__ __forceinline__ void producer_regs() {
  if constexpr (SLABS * BN >= 256) asm volatile("setmaxnreg.dec.sync.aligned.u32 56;\n");
}
template <int SLABS, int BN>
__device__ __forceinline__ void consumer_regs() {
  if constexpr (SLABS * BN >= 256) asm volatile("setmaxnreg.inc.sync.aligned.u32 224;\n");
}

// ------------------------------------------------------------------- ring
// Stages come in pairs (2p, 2p + 1) that share one word tile: four words a
// filter, the pair's two stages side by side, so the producer can fetch a
// filter's words of both with one 16-byte TMA row. The even stage's slot is
// released only with the odd one's (see consume), so the pair's word tile
// lives as long as either stage is in use.
struct Ring {
  uint8_t* x;        // kStages x tiles, each 1024-byte aligned
  uint32_t* w;       // kStages / 2 word tiles: [filter][4] uint32
  uint64_t* full;    // producer -> consumers
  uint64_t* empty;   // consumers -> producer
};

// Carve the ring out of dynamic shared memory and initialise its barriers
// (every thread of the block calls this once). `full_count` arrivals plus
// any expected transaction bytes complete a full phase; each consumer warp
// arrives once on empty.
template <class T>
__device__ __forceinline__ Ring ring_setup(uint8_t* smem, uint64_t* full,
                                           uint64_t* empty, uint32_t full_count) {
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem) + 1023) & ~static_cast<uintptr_t>(1023));
  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], full_count);
      mbar_init(&empty[s], 4 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return Ring{base, reinterpret_cast<uint32_t*>(base + kStages * T::kXBytes), full,
              empty};
}

// ------------------------------------------------------------- consumers
// Where stage `it` (local index) keeps its two words: its pair's word tile,
// at word (it % 2) * 2 of each filter's four.
template <class T>
__device__ __forceinline__ uint32_t* stage_words(const Ring& ring, int it) {
  return ring.w + (it % kStages) / 2 * (T::kBM * 2 * kStageWords) + (it & 1) * kStageWords;
}

// The A fragments of stage `it` for this thread: for each slab, rows
// (filters) g and g + 8 of its warp's 16, columns 2t, 2t+1, 2t+8, 2t+9 of
// each 16-column step (the m16n8k16 A layout), from the stage's words.
template <int SLABS, int BN>
__device__ __forceinline__ void build_a(uint32_t (&a)[SLABS][4][4], const Ring& ring,
                                        int it) {
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* ws = stage_words<Tile<SLABS, BN>>(ring, it);
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
    const int row = (wg * SLABS + sl) * 64 + warp * 16 + g;
    const uint2 lo = *reinterpret_cast<const uint2*>(ws + row * 2 * kStageWords);
    const uint2 hi = *reinterpret_cast<const uint2*>(ws + (row + 8) * 2 * kStageWords);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {   // 16 columns each: word kk/2, bits 16*(kk%2)
      const uint32_t wl = kk < 2 ? lo.x : lo.y;
      const uint32_t wh = kk < 2 ? hi.x : hi.y;
      const int bit = (kk & 1) * 16 + 2 * t;
      a[sl][kk][0] = pm1_pair(wl, bit);
      a[sl][kk][1] = pm1_pair(wh, bit);
      a[sl][kk][2] = pm1_pair(wl, bit + 8);
      a[sl][kk][3] = pm1_pair(wh, bit + 8);
    }
  }
}

// Run `n` stages of the ring through wgmma into acc (zeroed here). Each
// consumer warpgroup waits for its stage's group before it releases the
// slot; the two warpgroups take turns on the tensor cores, so one builds
// its next operand while the other's group runs. An even stage's slot is
// released together with the odd one's (they share the word tile).
// kGeneric: the x tiles were written through the generic proxy (cp.async)
// and wgmma reads them through the async proxy, so each stage's wait on its
// full barrier is followed by a proxy fence.
template <int SLABS, int BN, bool kGeneric>
__device__ __forceinline__ void consume(float (&acc)[SLABS][BN / 2], const Ring& ring,
                                        int n) {
  using T = Tile<SLABS, BN>;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl)
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[sl][i] = 0.f;
  for (int it = 0; it < n; ++it) {
    const int s = it % kStages;
    mbar_wait(&ring.full[s], (it / kStages) & 1);
    if constexpr (kGeneric) fence_proxy_async();
    uint32_t a[SLABS][4][4];
    build_a<SLABS, BN>(a, ring, it);
    const uint64_t desc = desc_sw128(ring.x + s * T::kXBytes);
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) fence_operands(acc[sl]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int sl = 0; sl < SLABS; ++sl) wgmma_rs(acc[sl], a[sl][kk], desc + 2 * kk);
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int sl = 0; sl < SLABS; ++sl) fence_operands(acc[sl]);
    if (lane == 0 && (it & 1)) mbar_arrive(&ring.empty[s - 1]);
    if (lane == 0 && ((it & 1) || it == n - 1)) mbar_arrive(&ring.empty[s]);
  }
}

// Write acc (filters f0.., rows m0..) to out (m, r) row-major f32: stage the
// tile transposed in shared memory (the ring is free once every consumer is
// past its last stage), then 16-byte stores of whole row segments.
template <int SLABS, int BN>
__device__ __forceinline__ void store_tile(const float (&acc)[SLABS][BN / 2],
                                           const Ring& ring, float* __restrict__ out,
                                           int m, int r, int m0, int f0) {
  using T = Tile<SLABS, BN>;
  constexpr int P = T::kOutPitch;
  float* epi = reinterpret_cast<float*>(ring.x);
  const int wg = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  consumer_sync();
#pragma unroll
  for (int sl = 0; sl < SLABS; ++sl) {
    const int f = (wg * SLABS + sl) * 64 + warp * 16 + g;
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      const int mm = 8 * j + 2 * t;
      epi[mm * P + f] = acc[sl][4 * j];
      epi[(mm + 1) * P + f] = acc[sl][4 * j + 1];
      epi[mm * P + f + 8] = acc[sl][4 * j + 2];
      epi[(mm + 1) * P + f + 8] = acc[sl][4 * j + 3];
    }
  }
  consumer_sync();
  constexpr int kChunks = T::kBM / 4;     // float4 per tile row
  const bool vec = (r & 3) == 0;
  for (int c = threadIdx.x; c < BN * kChunks; c += 128 * kConsumers) {
    const int row = c / kChunks, col = (c % kChunks) * 4;
    const int gm = m0 + row, gf = f0 + col;
    if (gm >= m || gf >= r) continue;
    const float4 v = *reinterpret_cast<const float4*>(&epi[row * P + col]);
    float* dst = out + (size_t)gm * r + gf;
    if (vec && gf + 4 <= r) {
      *reinterpret_cast<float4*>(dst) = v;
    } else {
      const float e[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        if (gf + i < r) dst[i] = e[i];
    }
  }
}

// Programmatic dependent launch: `kernel` may be launched while the kernel
// before it on the stream is still running (it is set up early and starts
// when that kernel triggers or ends); it must call wait_prior_grid() before
// it touches memory, which waits for the earlier kernel's completion and
// memory, so stream order holds for the data.
template <class... KArgs, class... Args>
inline cudaError_t launch_dependent(void (*kernel)(KArgs...), dim3 grid, dim3 block,
                                    size_t smem, cudaStream_t stream, Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<KArgs>(args)...);
}

__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// The split-K pass: out[i] = sum over z of ws[z * n + i], added in the
// order z = 0, 1, ... (deterministic, unlike atomics). Acc: float (B1, B2,
// B6) or int (B4). A dependent launch: it is set up while the kernel that
// wrote ws runs.
template <class Acc>
__global__ void sum_splits_kernel(const Acc* __restrict__ ws, Acc* __restrict__ out,
                                  long long n, int splits) {
  wait_prior_grid();
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    Acc a = 0;
    for (int z = 0; z < splits; ++z) a += ws[z * n + i];
    out[i] = a;
  }
}

template <class Acc>
inline cudaError_t sum_splits(const Acc* ws, Acc* out, long long n, int splits,
                              cudaStream_t stream) {
  const dim3 grid(n / 256 + 1 < 1024 ? (unsigned)(n / 256 + 1) : 1024u);
  return launch_dependent(sum_splits_kernel<Acc>, grid, dim3(256), 0, stream, ws, out, n,
                          splits);
}

// cuTensorMapEncodeTiled, fetched at run time through the CUDA runtime's
// cudaGetDriverEntryPoint (the library does not link libcuda).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory (once).
template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *done = true;
  return err;
}

}  // namespace hopper
