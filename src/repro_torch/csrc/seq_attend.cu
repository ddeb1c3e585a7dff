// Kernel B9: the f64 partial softmax of a "seq" attention layer over one
// rank's keys, or, for one part, the attention output rounded once.
//
// The port's own kernel: it has no TPU counterpart. The reference attends
// a "seq" layer through XLA, which sums the sequence-sharded softmax with
// its own collectives. The port's mesh merges each rank's partial softmax
// (distributed/sharding.py merge_partials), in f64 so that any split of
// the keys rounds to one value; one card attends as that merge's one part.
// This kernel is that one part: nn/attention.py `_partial_core` and the
// f64 branch of `_attend_quant`, in one pass over the rank's K/V.
//
//   q     (B, S, K, G, hd) bf16 or f32: the G query heads of each K/V head
//   k, v  (B, T, K, hd) bf16, f32 or int8 codes
//   ks,vs (B, T, K) f32 scales of int8 codes (null otherwise): the
//         reference's scale-factored order, s = ((q . codes) ks) scale and
//         o = sum (e vs) codes
//   mask  (B, S, T) uint8, 1 = attend (causal, window and k_valid over
//         the keys' absolute positions, built by the caller)
//   out   mode 0: o (B, S, K, G, hd) f64 = sum_t e_t v_t, unnormalised,
//                 m, l (B, S, K, G) f64: the row's largest valid score
//                 (NEG_INF = -1e30 with none) and sum_t e_t, e_t =
//                 exp(s_t - m) at valid keys and exactly 0 at masked ones
//         mode 1 / 2: o / l (o / 1 where l = 0) rounded once to f32 / bf16
//                 (through f32, as torch's f64 -> bf16 cast rounds), with m
//                 and l as in mode 0
//
// What bounds it on an H100: at decode, memory against f64 arithmetic.
// Each (row, key) pair costs 2 hd f64 FMAs (the score and the output);
// the G = 9 (starcoder2-7b) or 10 (recurrentgemma-2b) rows of a K/V head
// share a key, so a bf16 key costs 4 hd bytes for 2 G hd FMAs: 4.5-5 FMA
// a byte, 9-10 f64 ops, about the ~10 ops a byte at which the card's 34
// TFLOP/s of f64 (outside the tensor cores) meets its 3.35 TB/s; int8
// codes halve the bytes. A decode tick's views are short (the engine's
// max_len), so in practice a call is bound by latency: the blocks it can
// keep in flight and the dependent f64 chains in each (PERF.md has the
// times beside the bound).
//
// Design (simple first): one block of 256 threads per (slot, K/V head,
// tile of up to 16 query rows, split of the keys), a row being one
// (query, head) pair. The keys are split over blocks (flash decoding) so a
// short batch still fills the card; each block walks its keys in tiles of
// 64 with an online maximum. A tile whose mask lets no pair through is
// skipped before its K/V is read (a decode tick reads only the keys under
// each slot's length). The tile's K and V are loaded 16 bytes a thread
// where aligned, K staged in shared memory as f32 (a pitch of hd + 1, 2 or
// 4, so the lanes of a warp hit distinct banks) and V as stored; every row reads
// them there, so the G heads of a K/V head share each key's read. Phase 1:
// each thread scores one key against up to 4 rows (q staged as f64, two
// accumulators a row; with 8 rows or fewer, 2 or 4 lanes share a score's
// head dim and add by shuffles). Phase 2: a warp per row takes the tile's
// maximum, rescales the row's running l and o by exp(m_old - m_new) and writes e
// (times vs) in place of the score. Phase 3: each thread owns one output
// column d of up to 16 rows, four at a time up to its last, and
// accumulates sum_t p_t v_t[d] in f64 registers. With more than one
// split a second kernel merges the splits' partials per row in split order
// (deterministic). Scores, exponentials,
// both products and every sum are f64; the output rounds once, here (mode
// 1 / 2) or after the mesh's merge. No tensor cores, no TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;         // (query, head) rows a block
constexpr int kKeys = 64;         // keys a tile
constexpr int kRowsPerTask = 4;   // rows a thread scores against one key
constexpr int kMaxParts = 4;      // threads that share one score's head dim
constexpr int kMaxHd = 256;
constexpr int kMaxAcc = kRows * kMaxHd / kThreads;  // output rows a thread (hd = 256)
constexpr double kNegInf = -1e30;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f32(int8_t v) { return static_cast<float>(v); }

template <typename KT>
struct Smem {
  double* q;      // (kRows, hd)
  double* p;      // (kRows, kKeys): the scores, then e (times vs); -inf marks a masked pair
  double* m;      // (kRows,)
  double* l;      // (kRows,)
  double* alpha;  // (kRows,)
  float* k;       // (kKeys, hd + parts): lanes on consecutive keys hit distinct banks
  float* ks;      // (kKeys,)
  float* vs;      // (kKeys,)
  KT* v;          // (kKeys, hd)
};

template <typename KT>
__host__ __device__ inline size_t smem_bytes(int hd) {
  size_t b = sizeof(double) * ((size_t)kRows * hd + (size_t)kRows * kKeys + 3 * kRows);
  b += sizeof(float) * ((size_t)kKeys * (hd + kMaxParts) + 2 * kKeys);
  b = (b + 15) / 16 * 16;
  return b + sizeof(KT) * (size_t)kKeys * hd;
}

template <typename KT>
__device__ inline Smem<KT> carve(unsigned char* base, int hd) {
  Smem<KT> s;
  double* d = reinterpret_cast<double*>(base);
  s.q = d;
  d += (size_t)kRows * hd;
  s.p = d;
  d += (size_t)kRows * kKeys;
  s.m = d;
  s.l = d + kRows;
  s.alpha = d + 2 * kRows;
  float* f = reinterpret_cast<float*>(d + 3 * kRows);
  s.k = f;
  f += (size_t)kKeys * (hd + kMaxParts);
  s.ks = f;
  s.vs = f + kKeys;
  f += 2 * kKeys;
  size_t off = reinterpret_cast<unsigned char*>(f) - base;
  s.v = reinterpret_cast<KT*>(base + (off + 15) / 16 * 16);
  return s;
}

// The tile's K (as f32) and V (as stored) into shared memory: 16 bytes a
// thread where the rows are aligned, else one element a thread.
template <typename KT>
__device__ inline void load_tile(const Smem<KT>& sm, const KT* __restrict__ k,
                                 const KT* __restrict__ v, size_t base, int K, int hd, int nk,
                                 int pitch, bool vec) {
  const int tid = threadIdx.x;
  const size_t key_stride = (size_t)K * hd;
  if (vec) {
    constexpr int kVec = 16 / sizeof(KT);
    const int chunks = hd / kVec, total = nk * chunks;
    for (int c = tid; c < total; c += kThreads) {
      const int j = c / chunks, d0 = (c % chunks) * kVec;
      const size_t at = base + j * key_stride + d0;
      const uint4 rk = *reinterpret_cast<const uint4*>(k + at);
      const uint4 rv = *reinterpret_cast<const uint4*>(v + at);
      *reinterpret_cast<uint4*>(sm.v + j * hd + d0) = rv;
      const KT* ek = reinterpret_cast<const KT*>(&rk);
#pragma unroll
      for (int i = 0; i < kVec; ++i) sm.k[j * pitch + d0 + i] = to_f32(ek[i]);
    }
  } else {
    for (int e = tid; e < nk * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const size_t at = base + j * key_stride + d;
      sm.k[j * pitch + d] = to_f32(k[at]);
      sm.v[j * hd + d] = v[at];
    }
  }
}

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
seq_attend_kernel(const QT* __restrict__ q, const KT* __restrict__ k, const KT* __restrict__ v,
                  const float* __restrict__ ks, const float* __restrict__ vs,
                  const uint8_t* __restrict__ mask, double* __restrict__ o64,
                  void* __restrict__ o_round, double* __restrict__ m_out,
                  double* __restrict__ l_out, double* __restrict__ ws, int S, int T, int K,
                  int G, int hd, int per_split, double scale, int mode, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const Smem<KT> sm = carve<KT>(smem_raw, hd);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, kh = blockIdx.x % K;
  const int row0 = blockIdx.y * kRows;               // first (s, g) row of the block
  const int nrows = min(kRows, S * G - row0);
  const int split = blockIdx.z, t_begin = split * per_split;
  const int t_end = min(T, t_begin + per_split);

  // q rows as f64 (exact), and the running m, l
  for (int e = tid; e < nrows * hd; e += kThreads) {
    const int r = e / hd, d = e % hd;
    const int s = (row0 + r) / G, g = (row0 + r) % G;
    sm.q[e] = (double)to_f32(q[((((size_t)b * S + s) * K + kh) * G + g) * hd + d]);
  }
  for (int r = tid; r < kRows; r += kThreads) {
    sm.m[r] = kNegInf;
    sm.l[r] = 0.0;
  }

  // phase 3's columns: column d of rows r3, r3 + step, ... (hd divides kThreads)
  const int step = kThreads / hd, d3 = tid % hd, r3 = tid / hd;
  double acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.0;

  const int groups = (nrows + kRowsPerTask - 1) / kRowsPerTask;
  // phase 1 splits a score's head dim over `parts` neighbouring lanes where
  // few rows leave threads idle (then groups * kKeys * parts == kThreads:
  // one pass, every lane in it); K's pitch hd + parts keeps the lanes of a
  // warp (kKeys / parts keys x parts) on distinct banks
  const int parts = groups == 1 ? 4 : (groups == 2 ? 2 : 1);
  const int pitch = hd + parts;
  for (int t0 = t_begin; t0 < t_end; t0 += kKeys) {
    const int nk = min(kKeys, t_end - t0);
    // masked pairs first: a tile with none valid is not read at all
    int any = 0;
    for (int e = tid; e < nrows * kKeys; e += kThreads) {
      const int r = e / kKeys, j = e % kKeys;
      const int s = (row0 + r) / G;
      const bool ok = j < nk && mask[((size_t)b * S + s) * T + t0 + j] != 0;
      sm.p[r * kKeys + j] = ok ? 0.0 : -CUDART_INF;
      any |= ok;
    }
    if (!__syncthreads_or(any)) continue;
    load_tile(sm, k, v, (((size_t)b * T + t0) * K + kh) * hd, K, hd, nk, pitch, vec != 0);
    if (ks != nullptr) {
      for (int j = tid; j < nk; j += kThreads) {
        const size_t at = ((size_t)b * T + t0 + j) * K + kh;
        sm.ks[j] = ks[at];
        sm.vs[j] = vs[at];
      }
    }
    __syncthreads();

    // phase 1: s = (q . k) scale, or ((q . codes) ks) scale; a thread takes
    // elements part, part + parts, ... of the head dim (two chains), and
    // the parts of a score are added by shuffles
    for (int e = tid; e < groups * kKeys * parts; e += kThreads) {
      const int part = e % parts, j = (e / parts) % kKeys;
      const int r0 = (e / (parts * kKeys)) * kRowsPerTask;
      bool live[kRowsPerTask];
      bool some = false;
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) {
        live[i] = r0 + i < nrows && sm.p[(r0 + i) * kKeys + j] == 0.0;
        some |= live[i];
      }
      if (parts == 1 && !some) continue;   // with parts > 1 every lane shuffles
      double dot0[kRowsPerTask], dot1[kRowsPerTask];
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) dot0[i] = dot1[i] = 0.0;
      const float* kr = sm.k + j * pitch;
      for (int d = part; d < hd; d += 2 * parts) {
        const double k0 = (double)kr[d], k1 = (double)kr[d + parts];
#pragma unroll
        for (int i = 0; i < kRowsPerTask; ++i) {
          if (r0 + i < nrows) {
            const double* qr = sm.q + (r0 + i) * hd + d;
            dot0[i] = fma(qr[0], k0, dot0[i]);
            dot1[i] = fma(qr[parts], k1, dot1[i]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRowsPerTask; ++i) {
        double dot = dot0[i] + dot1[i];
        for (int off = 1; off < parts; off <<= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
        if (!live[i] || part != 0) continue;
        const double sc = ks != nullptr ? dot * (double)sm.ks[j] : dot;
        sm.p[(r0 + i) * kKeys + j] = sc * scale;
      }
    }
    __syncthreads();

    // phase 2: the tile's maximum, the rescale, e = exp(s - m) (times vs)
    for (int r = warp; r < nrows; r += kWarps) {
      double* pr = sm.p + r * kKeys;
      double top = kNegInf;
      for (int j = lane; j < kKeys; j += 32)
        if (pr[j] != -CUDART_INF) top = fmax(top, pr[j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) top = fmax(top, __shfl_xor_sync(0xffffffffu, top, off));
      const double m_old = sm.m[r], m_new = fmax(m_old, top);
      double sum = 0.0;
      for (int j = lane; j < kKeys; j += 32) {
        const double e = pr[j] == -CUDART_INF ? 0.0 : exp(pr[j] - m_new);
        sum += e;
        pr[j] = ks != nullptr ? e * (double)sm.vs[j] : e;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const double a = exp(m_old - m_new);
        sm.alpha[r] = a;
        sm.l[r] = sm.l[r] * a + sum;
        sm.m[r] = m_new;
      }
    }
    __syncthreads();

    // phase 3: o = o alpha + sum_j p_j v_j[d], the thread's rows four at a
    // time (it stops at its last row: a thread with one row does no more)
#pragma unroll
    for (int i0 = 0; i0 < kMaxAcc; i0 += 4) {
      if (r3 + i0 * step >= nrows) break;
#pragma unroll
      for (int i = i0; i < i0 + 4; ++i) {
        const int r = r3 + i * step;
        if (r < nrows) acc[i] *= sm.alpha[r];
      }
      for (int j = 0; j < nk; ++j) {
        const double vd = (double)to_f32(sm.v[j * hd + d3]);
#pragma unroll
        for (int i = i0; i < i0 + 4; ++i) {
          const int r = r3 + i * step;
          if (r < nrows) acc[i] = fma(sm.p[r * kKeys + j], vd, acc[i]);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: the final outputs (one split) or this split's partials
  const bool whole = gridDim.z == 1;
  const size_t rows_total = (size_t)gridDim.x / K * S * K * G;
  for (int r = tid; r < nrows; r += kThreads) {
    const int s = (row0 + r) / G, g = (row0 + r) % G;
    const size_t row = (((size_t)b * S + s) * K + kh) * G + g;
    if (whole) {
      m_out[row] = sm.m[r];
      l_out[row] = sm.l[r];
    } else {
      double* part = ws + ((size_t)split * rows_total + row) * (hd + 2);
      part[hd] = sm.m[r];
      part[hd + 1] = sm.l[r];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int r = r3 + i * step;
    if (r >= nrows) continue;
    const int s = (row0 + r) / G, g = (row0 + r) % G;
    const size_t row = (((size_t)b * S + s) * K + kh) * G + g;
    if (!whole) {
      ws[((size_t)split * rows_total + row) * (hd + 2) + d3] = acc[i];
    } else if (mode == 0) {
      o64[row * hd + d3] = acc[i];
    } else {
      const double den = sm.l[r] > 0.0 ? sm.l[r] : 1.0;
      const float val = __double2float_rn(acc[i] / den);
      if (mode == 1)
        static_cast<float*>(o_round)[row * hd + d3] = val;
      else
        static_cast<__nv_bfloat16*>(o_round)[row * hd + d3] = __float2bfloat16_rn(val);
    }
  }
}

// The splits' partials of each row merged in split order: M = max m_s,
// o = sum e^(m_s - M) o_s, l = sum e^(m_s - M) l_s, then the outputs as
// the one-split epilogue writes them. One thread per (row, d); the d = 0
// thread writes m and l.
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const double* __restrict__ ws, double* __restrict__ o64,
                    void* __restrict__ o_round, double* __restrict__ m_out,
                    double* __restrict__ l_out, long long rows, int hd, int splits, int mode) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= rows * hd) return;
  const long long row = e / hd;
  const int d = (int)(e % hd);
  const size_t stride = (size_t)rows * (hd + 2);
  const double* part = ws + (size_t)row * (hd + 2);
  double top = kNegInf;
  for (int s = 0; s < splits; ++s) top = fmax(top, part[s * stride + hd]);
  double o = 0.0, l = 0.0;
  for (int s = 0; s < splits; ++s) {
    const double w = exp(part[s * stride + hd] - top);
    o += w * part[s * stride + d];
    l += w * part[s * stride + hd + 1];
  }
  if (d == 0) {
    m_out[row] = top;
    l_out[row] = l;
  }
  const size_t at = (size_t)row * hd + d;
  if (mode == 0) {
    o64[at] = o;
  } else {
    const float val = __double2float_rn(o / (l > 0.0 ? l : 1.0));
    if (mode == 1)
      static_cast<float*>(o_round)[at] = val;
    else
      static_cast<__nv_bfloat16*>(o_round)[at] = __float2bfloat16_rn(val);
  }
}

template <typename QT, typename KT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* mask, void* o, void* m, void* l, void* ws, int B, int S, int T,
                   int K, int G, int hd, int per_split, double scale, int mode,
                   cudaStream_t stream) {
  auto kernel = seq_attend_kernel<QT, KT>;
  static bool opted = false;  // allow the largest head dim's shared memory, once
  if (!opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes<KT>(kMaxHd));
    if (err != cudaSuccess) return err;
    opted = true;
  }
  const int nsplit = (T + per_split - 1) / per_split;
  const bool vec = (reinterpret_cast<uintptr_t>(k) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(v) % 16 == 0) &&
                   ((size_t)hd * sizeof(KT)) % 16 == 0;
  const dim3 grid((unsigned)(B * K), (unsigned)((S * G + kRows - 1) / kRows), (unsigned)nsplit);
  kernel<<<grid, kThreads, smem_bytes<KT>(hd), stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k), static_cast<const KT*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const uint8_t*>(mask), mode == 0 ? static_cast<double*>(o) : nullptr,
      mode == 0 ? nullptr : o, static_cast<double*>(m), static_cast<double*>(l),
      static_cast<double*>(ws), S, T, K, G, hd, per_split, scale, mode, vec ? 1 : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  const long long rows = (long long)B * S * K * G;
  const long long n = rows * hd;
  merge_splits_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      static_cast<const double*>(ws), mode == 0 ? static_cast<double*>(o) : nullptr,
      mode == 0 ? nullptr : o, static_cast<double*>(m), static_cast<double*>(l), rows, hd,
      nsplit, mode);
  return cudaGetLastError();
}

template <typename QT>
cudaError_t launch_kv(int kv_kind, const void* q, const void* k, const void* v, const void* ks,
                      const void* vs, const void* mask, void* o, void* m, void* l, void* ws,
                      int B, int S, int T, int K, int G, int hd, int per_split, double scale,
                      int mode, cudaStream_t stream) {
  switch (kv_kind) {
    case 0:
      return launch<QT, __nv_bfloat16>(q, k, v, ks, vs, mask, o, m, l, ws, B, S, T, K, G, hd,
                                       per_split, scale, mode, stream);
    case 1:
      return launch<QT, float>(q, k, v, ks, vs, mask, o, m, l, ws, B, S, T, K, G, hd,
                               per_split, scale, mode, stream);
    case 2:
      return launch<QT, int8_t>(q, k, v, ks, vs, mask, o, m, l, ws, B, S, T, K, G, hd,
                                per_split, scale, mode, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// q_kind: 0 bf16, 1 f32; kv_kind: 0 bf16, 1 f32, 2 int8 (ks / vs given);
// mode: 0 f64 partials, 1 f32 output, 2 bf16 output; per_split: the keys
// a block takes, a multiple of 64 (one split: no workspace; else ws holds
// ceil(T / per_split) x B S K G x (hd + 2) f64).
extern "C" int tbn_seq_attend(const void* q, const void* k, const void* v, const void* ks,
                              const void* vs, const void* mask, void* o, void* m, void* l,
                              void* ws, int B, int S, int T, int K, int G, int hd,
                              int per_split, double scale, int q_kind, int kv_kind, int mode,
                              void* stream) {
  if (B < 1 || S < 1 || T < 1 || K < 1 || G < 1 || hd < 2 || hd % 2 || hd > kMaxHd ||
      kThreads % hd != 0 || mode < 0 || mode > 2 || per_split < kKeys ||
      per_split % kKeys != 0 || (per_split < T && ws == nullptr) ||
      (kv_kind == 2) != (ks != nullptr) || (ks == nullptr) != (vs == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_kind == 0)
    return (int)launch_kv<__nv_bfloat16>(kv_kind, q, k, v, ks, vs, mask, o, m, l, ws, B, S, T,
                                         K, G, hd, per_split, scale, mode, s);
  if (q_kind == 1)
    return (int)launch_kv<float>(kv_kind, q, k, v, ks, vs, mask, o, m, l, ws, B, S, T, K, G,
                                 hd, per_split, scale, mode, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tbn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
