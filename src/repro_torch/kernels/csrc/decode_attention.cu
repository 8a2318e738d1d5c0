// Single-token decode attention against a KV cache, for Hopper, sm_90a.
//
// Replaces the TPU kernel `decode_attention` / `_decode_kernel` in
// src/repro/kernels/decode_attention.py (the `pl.pallas_call` at :101). It
// computes the same function: one query row for each (b, q-head) against the
// cache, online softmax (m, l, acc in f32, denominator floored at 1e-30),
// keys valid where k_pos < lengths[b] (the query sits at lengths[b] - 1), and
// an optional window keeping lengths - 1 - k_pos < window. lengths is clamped
// to S here: an idle serving slot's position can run past the cache, and the
// kernel must neither read nor count rows that do not exist.
//
// What bounds it: HBM bytes. A decode step reads the live part of the cache
// once, 2 * sum_b len_b * Hkv * hd * bytes, against ~2 operations per byte
// per query head, so the bound is 3.35 TB/s (5.2 us at granite-3-2b's
// seeded lengths, B 8, S 2048, Hkv 8, hd 64).
//
// What the design does about it: it streams the live rows at 16 bytes a lane
// with as many loads in flight as the registers allow, and nothing else.
//   * The grid is fixed by S: (ceil(S / chunk), B * Hkv, head slices), one
//     block per chunk of `chunk` keys of one (b, kv-head). It never depends on
//     data on the device, so the launch shape is the same for every step.
//     A block works out its live rows from the clamped lengths[b] and the
//     window (live_range below); a chunk with no live key writes an empty
//     partial state (m = -inf, l = 0) and returns.
//   * One block serves all G query heads of its kv head (up to 8 per head
//     slice), so each cache row crosses HBM once, not G times.
//   * No shared-memory staging and no block barrier inside the key loop. Each
//     warp owns a stripe of rows; a row of K and the same row of V are read
//     with 16-byte vector loads straight into registers (8 bf16 or 4 f32 a
//     lane): at hd 64, 8 lanes a row and 4 rows per warp instruction; at hd
//     240/256, one row per instruction. A lane holds U = 4 rows of K and of
//     V (8 loads in flight); the next rows' K is requested as soon as these
//     are scored and their V as soon as these are accumulated, so the loads
//     overlap the arithmetic without a second set of registers (a second set
//     costs a third of the blocks an SM holds, which measured slower).
//   * q (pre-scaled by scale * log2 e) and acc[G][8] live in registers; each
//     row's dot products are reduced across its lanes with shuffles; the
//     online softmax runs per head and row slot, in log2 units.
//   * At the end of the chunk the row slots of a warp merge by shuffles and
//     the 4 warps through shared memory, once, in a fixed order.
//   * A second kernel merges the live chunks of each (b, kv-head) in chunk
//     order. Nothing is summed with atomics, so the result is deterministic
//     (the park/resume bit-identity check relies on that). A (b, kv-head)
//     with one live chunk is written by that chunk's block directly, and the
//     merge skips it.
//   * The chunk is 192 keys at hd <= 128 and 128 above, chosen from the
//     sizes `chip_smoke.py --sweep-decode-chunks` times on the path's shapes.
//     No size is fastest at every set of lengths: once a step's live chunks
//     outnumber the blocks the SMs hold at once (3 a SM), the rest run as a
//     second wave, so a longer chunk wins when the rows are long and loses
//     when they are short.
// Time on the card (one chip_smoke.py run; NVIDIA H100 80GB HBM3, 700 W):
// granite-3-2b 0.0194 ms, kernel and merge, against its 0.00518 ms byte bound
// (SDPA 0.0217 ms); gemma3-12b's local layer (hd 240, window 1024) 0.0289 ms
// against 0.00987 ms (SDPA 0.0660 ms). PERF.md keeps the earlier times too.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxGroup = 8;          // query heads one block serves
constexpr int kMaxHd = 256;

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// 16 bytes of T as floats
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&x)[4]) {
  x[0] = __uint_as_float(u.x);
  x[1] = __uint_as_float(u.y);
  x[2] = __uint_as_float(u.z);
  x[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// Loads rows base + u * step + slot (u < U) of one cache (K or V), 16 bytes a
// lane, into registers; rows at or past r_hi, and columns past hd, read as
// zeros.
template <typename T, int U, int NV>
__device__ __forceinline__ void load_rows(uint4 (&x)[U][NV], const T* rows, size_t rs,
                                          int base, int step, int slot, int r_hi,
                                          const int (&d0)[NV], const bool (&col_ok)[NV]) {
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int r = base + u * step + slot;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      x[u][j] = r < r_hi && col_ok[j] ? load16(rows + (size_t)r * rs + d0[j]) : zero;
  }
}

// 2^x in one MUFU instruction (exp2f adds range handling around it);
// denormal results flush to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Live key rows [lo, hi) of a batch row: the length clamped to [0, S], cut to
// the window.
__device__ __forceinline__ void live_range(int length, int S, int window, int& lo, int& hi) {
  hi = max(min(length, S), 0);
  lo = window > 0 ? max(0, hi - window) : 0;
}

// Merge state (m2, l2) into (m, l): returns the weights of the old and new.
__device__ __forceinline__ void merge_weights(float& m, float& l, float m2, float l2,
                                              float& w1, float& w2) {
  const float mn = fmaxf(m, m2);
  const float mu = mn == -INFINITY ? 0.f : mn;
  w1 = fast_exp2(m - mu);
  w2 = fast_exp2(m2 - mu);
  l = l * w1 + l2 * w2;
  m = mn;
}

// q: (B, Hq, hd); k, v: (B, S, Hkv, hd); lengths: (B,) int32; o: (B, Hq, hd).
// grid = (ceil(S / chunk), B * Hkv, ceil(G / GB)), block = kThreads.
// Partial states: part_acc (n_chunks, B*Hkv, G, hd), part_ml (.., G, 2).
// NV: 16-byte vectors a lane holds of one row (1, or 2 for f32 past hd 128).
// A lane holds U rows of K and of V. Up to GB * NV = 4, U = 4 and three
// blocks share an SM (168 registers a thread at most); above, U = 2, one.
template <typename T, int GB, int NV>
__global__ void __launch_bounds__(kThreads, GB * NV >= 8 ? 1 : 3)
decode_chunk_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ lengths,
                    T* __restrict__ o, float* __restrict__ part_acc,
                    float* __restrict__ part_ml, int S, int Hq, int Hkv, int hd,
                    int window, float scale_log2, int chunk) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int U = GB * NV >= 8 ? 2 : 4;     // rows a lane holds
  __shared__ float sm_acc[kWarps][GB][kMaxHd];
  __shared__ float sm_ml[kWarps][GB][2];

  const int G = Hq / Hkv;
  const int bh = blockIdx.y, b = bh / Hkv, kvh = bh % Hkv;
  const int g0 = blockIdx.z * GB;             // first query head of this slice
  const int ng = min(GB, G - g0);
  const int c = blockIdx.x;
  int lo, hi;
  live_range(lengths[b], S, window, lo, hi);
  const int r_lo = max(lo, c * chunk), r_hi = min(hi, c * chunk + chunk);
  const bool single = hi > lo && (hi - 1) / chunk == lo / chunk;
  const size_t prow = ((size_t)c * gridDim.y + bh) * G + g0;
  if (r_lo >= r_hi) {                         // no live key in this chunk
    if (threadIdx.x < ng) {
      part_ml[(prow + threadIdx.x) * 2] = -INFINITY;
      part_ml[(prow + threadIdx.x) * 2 + 1] = 0.f;
    }
    return;
  }

  // lanes per row (a power of two, so shuffles stay inside a row) and slots
  const int need = (hd + VEC * NV - 1) / (VEC * NV);
  int lpr = 1;
  while (lpr < need) lpr <<= 1;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int slot = lane / lpr, cl = lane % lpr;
  const int step = kWarps * (32 / lpr);       // rows per block step
  int d0[NV];
  bool col_ok[NV];
#pragma unroll
  for (int j = 0; j < NV; ++j) {
    d0[j] = (j * lpr + cl) * VEC;
    col_ok[j] = d0[j] < hd;
  }

  const size_t rs = (size_t)Hkv * hd;        // elements between two key rows
  const T* kb = k + ((size_t)b * S * Hkv + kvh) * hd;
  const T* vb = v + ((size_t)b * S * Hkv + kvh) * hd;
  // every lane runs every iteration of the warp-uniform loop (shuffles need
  // that); the first rows' loads go out before q's
  int base = r_lo + warp * (32 / lpr);
  uint4 kx[U][NV], vx[U][NV];
  load_rows<T, U, NV>(kx, kb, rs, base, step, slot, r_hi, d0, col_ok);
  load_rows<T, U, NV>(vx, vb, rs, base, step, slot, r_hi, d0, col_ok);

  float qr[GB][NV][VEC], acc[GB][NV][VEC], m[GB], l[GB];
#pragma unroll
  for (int g = 0; g < GB; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      float x[VEC];
      if (g < ng && col_ok[j]) {
        unpack(load16(q + ((size_t)b * Hq + kvh * G + g0 + g) * hd + d0[j]), x);
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) x[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        qr[g][j][e] = x[e] * scale_log2;
        acc[g][j][e] = 0.f;
      }
    }
  }

  // The next rows' K are requested as soon as this K is scored, and their V
  // as soon as this V is accumulated: the loads overlap the other half of
  // the arithmetic without a second set of registers.
  for (; base < r_hi; base += U * step) {
    float s[U][GB];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const bool ok = base + u * step + slot < r_hi;
      float kf[NV][VEC];
#pragma unroll
      for (int j = 0; j < NV; ++j) unpack(kx[u][j], kf[j]);
#pragma unroll
      for (int g = 0; g < GB; ++g) {
        float dot = 0.f;
#pragma unroll
        for (int j = 0; j < NV; ++j)
#pragma unroll
          for (int e = 0; e < VEC; ++e) dot = fmaf(qr[g][j][e], kf[j][e], dot);
        for (int off = 1; off < lpr; off <<= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        s[u][g] = ok ? dot : -INFINITY;
      }
    }
    load_rows<T, U, NV>(kx, kb, rs, base + U * step, step, slot, r_hi, d0, col_ok);
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float mx = s[0][g];
#pragma unroll
      for (int u = 1; u < U; ++u) mx = fmaxf(mx, s[u][g]);
      const float mn = fmaxf(m[g], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      const float al = fast_exp2(m[g] - mu);
      m[g] = mn;
      l[g] *= al;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[g][j][e] *= al;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const float p = fast_exp2(s[u][g] - mu);
        l[g] += p;
#pragma unroll
        for (int j = 0; j < NV; ++j) {
          float vf[VEC];
          unpack(vx[u][j], vf);
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[g][j][e] = fmaf(p, vf[e], acc[g][j][e]);
        }
      }
    }
    load_rows<T, U, NV>(vx, vb, rs, base + U * step, step, slot, r_hi, d0, col_ok);
  }

  // merge the row slots of the warp (lanes cl, cl + lpr, ...)
  for (int off = lpr; off < 32; off <<= 1) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
      float w1, w2;
      const float m2 = __shfl_xor_sync(0xffffffffu, m[g], off);
      const float l2 = __shfl_xor_sync(0xffffffffu, l[g], off);
      merge_weights(m[g], l[g], m2, l2, w1, w2);
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int e = 0; e < VEC; ++e)
          acc[g][j][e] = acc[g][j][e] * w1 +
                         __shfl_xor_sync(0xffffffffu, acc[g][j][e], off) * w2;
    }
  }

  // merge the warps through shared memory, in warp order
  if (slot == 0) {
#pragma unroll
    for (int g = 0; g < GB; ++g) {
#pragma unroll
      for (int j = 0; j < NV; ++j)
        if (col_ok[j])
#pragma unroll
          for (int e = 0; e < VEC; ++e) sm_acc[warp][g][d0[j] + e] = acc[g][j][e];
      if (cl == 0) {
        sm_ml[warp][g][0] = m[g];
        sm_ml[warp][g][1] = l[g];
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < ng * hd; i += kThreads) {
    const int g = i / hd, d = i % hd;
    float mm = -INFINITY, ll = 0.f, a = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      float w1, w2;
      merge_weights(mm, ll, sm_ml[w][g][0], sm_ml[w][g][1], w1, w2);
      a = a * w1 + sm_acc[w][g][d] * w2;
    }
    if (single) {
      o[((size_t)b * Hq + kvh * G + g0 + g) * hd + d] = from_f32<T>(a / fmaxf(ll, 1e-30f));
    } else {
      part_acc[(prow + g) * hd + d] = a;
      if (d == 0) {
        part_ml[(prow + g) * 2] = mm;
        part_ml[(prow + g) * 2 + 1] = ll;
      }
    }
  }
}

// Merge the live chunks of each (b, kv-head, query head of the group) in
// chunk order: grid = (B * Hkv, G). The max over the chunks comes first, so
// the loads of the second pass do not wait on one another.
template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, const int* __restrict__ lengths,
                    T* __restrict__ o, int S, int Hq, int Hkv, int hd, int window,
                    int chunk) {
  const int G = Hq / Hkv;
  const int bh = blockIdx.x, n_bh = gridDim.x, g = blockIdx.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  int lo, hi;
  live_range(lengths[b], S, window, lo, hi);
  if (hi > lo && (hi - 1) / chunk == lo / chunk) return;  // written by its chunk
  const int c0 = lo / chunk, c1 = hi > lo ? (hi - 1) / chunk : c0 - 1;
  const float* ml = part_ml + ((size_t)bh * G + g) * 2;      // chunk c: + c * n_bh * G * 2
  const float* pa = part_acc + ((size_t)bh * G + g) * hd;     // chunk c: + c * n_bh * G * hd
  const size_t ml_step = (size_t)n_bh * G * 2, pa_step = (size_t)n_bh * G * hd;
  float m = -INFINITY;
#pragma unroll 4
  for (int c = c0; c <= c1; ++c) m = fmaxf(m, ml[c * ml_step]);
  const float mu = m == -INFINITY ? 0.f : m;
  for (int d = threadIdx.x; d < hd; d += kThreads) {
    float l = 0.f, a = 0.f;
#pragma unroll 4
    for (int c = c0; c <= c1; ++c) {
      const float w = fast_exp2(ml[c * ml_step] - mu);
      l = fmaf(ml[c * ml_step + 1], w, l);
      a = fmaf(pa[c * pa_step + d], w, a);
    }
    o[((size_t)b * Hq + kvh * G + g) * hd + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int GB, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lengths,
                   void* o, float* part_acc, float* part_ml, int B, int S, int Hq,
                   int Hkv, int hd, int window, float scale, int chunk,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const dim3 grid((S + chunk - 1) / chunk, B * Hkv, (G + GB - 1) / GB);
  decode_chunk_kernel<T, GB, NV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), part_acc, part_ml, S, Hq, Hkv, hd, window,
      scale * 1.4426950408889634f, chunk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge_kernel<T><<<dim3(B * Hkv, G), kThreads, 0, stream>>>(
      part_acc, part_ml, lengths, static_cast<T*>(o), S, Hq, Hkv, hd, window, chunk);
  return cudaGetLastError();
}

template <typename T, int NV>
cudaError_t dispatch_group(const void* q, const void* k, const void* v, const int* lengths,
                           void* o, float* pa, float* pm, int B, int S, int Hq, int Hkv,
                           int hd, int window, float scale, int chunk, cudaStream_t s) {
  const int G = Hq / Hkv;
  if (G == 1) return launch<T, 1, NV>(q, k, v, lengths, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  if (G == 2) return launch<T, 2, NV>(q, k, v, lengths, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  if (G <= 4) return launch<T, 4, NV>(q, k, v, lengths, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  return launch<T, kMaxGroup, NV>(q, k, v, lengths, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. part_acc / part_ml are scratch of
// ceil(S / chunk) * B * Hkv * G * {hd, 2} floats. q, k, v must be 16-byte
// aligned with hd a multiple of 8 (bf16) or 4 (f32). Returns the launches'
// cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o,
                                      void* part_acc, void* part_ml, int B,
                                      int S, int Hq, int Hkv, int hd,
                                      int window, float scale, int chunk,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || hd > kMaxHd ||
      chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int vec = dtype == 1 ? 8 : 4;
  if (hd % vec != 0 || ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v)) & 15u))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 1)
    return (int)dispatch_group<__nv_bfloat16, 1>(q, k, v, len, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  if (dtype == 0 && hd <= 128)
    return (int)dispatch_group<float, 1>(q, k, v, len, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  if (dtype == 0)
    return (int)dispatch_group<float, 2>(q, k, v, len, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, chunk, s);
  return (int)cudaErrorInvalidValue;
}
