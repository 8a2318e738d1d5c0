// Single-token decode attention against a KV cache, for Hopper, sm_90a.
//
// Replaces the TPU kernel `decode_attention` / `_decode_kernel` in
// src/repro/kernels/decode_attention.py (the `pl.pallas_call` at :101). It
// computes the same function: one query row for each (b, q-head) against the
// cache, online softmax over key tiles (m, l, acc in f32, denominator floored
// at 1e-30), keys valid where k_pos < lengths[b] (the query sits at
// lengths[b] - 1), and an optional window keeping lengths - 1 - k_pos <
// window. lengths is clamped to S here: an idle serving slot's position can
// run past the cache, and the kernel must neither read nor count rows that
// do not exist.
//
// What bounds it on this card: HBM bytes. Each decode step reads the live
// part of the cache once, 2 * sum_b len_b * Hkv * hd * bytes, against a few
// FLOPs per byte, so the bound is 3.35 TB/s.
//
// What this design does about it: the TPU grid is per q-head and streams
// each cache block G = Hq / Hkv times; here one block owns one (b, kv-head)
// and all G query heads of its group, so each cache row crosses HBM once.
// The key loop starts at the window's first live row and stops at the clamped
// length, so a sliding-window layer streams O(window) rows, not O(S), with no
// sliced copy of the cache. Because B * Hkv blocks alone cannot fill 132 SMs
// at serving batch sizes, the live range is split over `nsplit` blocks
// (chosen by the wrapper from the card's SM count); each writes its partial
// (m, l, acc) and a second small kernel merges them. Tiles are staged in
// shared memory as f32 with one word of row padding; loads are element-wise
// and not yet vectorised or pipelined (cp.async / TMA is later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD> struct DecodeShape { static constexpr int BK = 64; };
template <> struct DecodeShape<256> { static constexpr int BK = 32; };

template <int HD>
size_t decode_smem_bytes(int G) {
  constexpr int BK = DecodeShape<HD>::BK;
  return sizeof(float) * ((size_t)G * (HD + 1) + 2 * (size_t)BK * (HD + 1) +
                          (size_t)G * (BK + 1) + (size_t)G * HD + 3 * (size_t)G);
}

// q: (B, Hq, hd); k, v: (B, S, Hkv, hd); lengths: (B,) int32; o: (B, Hq, hd).
// grid = (nsplit, B * Hkv), block = kThreads. With nsplit > 1 the block
// writes its partial state to part_acc (nsplit, B*Hkv, G, HD) and part_ml
// (nsplit, B*Hkv, G, 2) instead of o.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ lengths,
              T* __restrict__ o, float* __restrict__ part_acc,
              float* __restrict__ part_ml, int S, int Hq, int Hkv, int hd,
              int window, float scale, int nsplit) {
  constexpr int BK = DecodeShape<HD>::BK;
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  const int G = Hq / Hkv;

  extern __shared__ float smem[];
  float* qs = smem;               // G x LD
  float* ks = qs + G * LD;        // BK x LD
  float* vs = ks + BK * LD;       // BK x LD
  float* ps = vs + BK * LD;       // G x LDP: scores, then probabilities
  float* acc = ps + G * LDP;      // G x HD
  float* ms = acc + G * HD;       // G running max
  float* ls = ms + G;             // G running denominator
  float* al = ls + G;             // G rescale of this tile

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int bh = blockIdx.y;
  const int b = bh / Hkv, kvh = bh % Hkv;
  const int split = blockIdx.x;

  const int len = min(lengths[b], S);
  const int lo = window > 0 ? max(0, len - window) : 0;
  const int hi = max(len, 0);
  int chunk = (max(hi - lo, 0) + nsplit - 1) / nsplit;
  chunk = ((chunk + BK - 1) / BK) * BK;
  const int s_lo = lo + split * chunk;
  const int s_hi = min(hi, s_lo + chunk);

  for (int i = tid; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    qs[g * LD + d] = d < hd ? to_f32(q[((size_t)b * Hq + kvh * G + g) * hd + d]) : 0.f;
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    ms[g] = kNegInf;
    ls[g] = 0.f;
  }

  for (int k0 = s_lo; k0 < s_hi; k0 += BK) {
    __syncthreads();  // the previous tile's reads (and the setup stores) are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const int kp = k0 + t;
      float xk = 0.f, xv = 0.f;
      if (kp < s_hi && d < hd) {
        const size_t off = (((size_t)b * S + kp) * Hkv + kvh) * hd + d;
        xk = to_f32(k[off]);
        xv = to_f32(v[off]);
      }
      ks[t * LD + d] = xk;
      vs[t * LD + d] = xv;
    }
    __syncthreads();
    for (int i = tid; i < G * BK; i += kThreads) {
      const int g = i / BK, t = i % BK;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[g * LD + d], ks[t * LD + d], dot);
      ps[g * LDP + t] = (k0 + t < s_hi) ? dot * scale : kNegInf;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {
      float tmax = kNegInf;
      for (int t = lane; t < BK; t += 32) tmax = fmaxf(tmax, ps[g * LDP + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
      const float m_prev = ms[g];
      const float m_new = fmaxf(m_prev, tmax);
      float psum = 0.f;
      for (int t = lane; t < BK; t += 32) {
        const float p = (k0 + t < s_hi) ? expf(ps[g * LDP + t] - m_new) : 0.f;
        ps[g * LDP + t] = p;
        psum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        psum += __shfl_xor_sync(0xffffffffu, psum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        al[g] = alpha;
        ls[g] = ls[g] * alpha + psum;
        ms[g] = m_new;
      }
    }
    __syncthreads();
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      float a = acc[i] * al[g];
      for (int t = 0; t < BK; ++t) a = fmaf(ps[g * LDP + t], vs[t * LD + d], a);
      acc[i] = a;
    }
  }
  __syncthreads();

  if (nsplit == 1) {
    for (int i = tid; i < G * HD; i += kThreads) {
      const int g = i / HD, d = i % HD;
      if (d < hd)
        o[((size_t)b * Hq + kvh * G + g) * hd + d] = from_f32<T>(acc[i] / fmaxf(ls[g], 1e-30f));
    }
  } else {
    const size_t row = ((size_t)split * gridDim.y + bh) * G;
    for (int i = tid; i < G * HD; i += kThreads) part_acc[row * HD + i] = acc[i];
    for (int g = tid; g < G; g += kThreads) {
      part_ml[(row + g) * 2 + 0] = ms[g];
      part_ml[(row + g) * 2 + 1] = ls[g];
    }
  }
}

// Merge the nsplit partial states of each (b, kv-head): grid = B * Hkv.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml, T* __restrict__ o,
                    int n_bh, int Hq, int Hkv, int hd, int nsplit) {
  const int G = Hq / Hkv;
  const int bh = blockIdx.x;
  const int b = bh / Hkv, kvh = bh % Hkv;
  for (int i = threadIdx.x; i < G * HD; i += kThreads) {
    const int g = i / HD, d = i % HD;
    if (d >= hd) continue;
    float m = kNegInf;
    for (int s = 0; s < nsplit; ++s)
      m = fmaxf(m, part_ml[(((size_t)s * n_bh + bh) * G + g) * 2]);
    float l = 0.f, a = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t row = ((size_t)s * n_bh + bh) * G + g;
      const float w = expf(part_ml[row * 2] - m);
      l = fmaf(part_ml[row * 2 + 1], w, l);
      a = fmaf(part_acc[row * HD + d], w, a);
    }
    o[((size_t)b * Hq + kvh * G + g) * hd + d] = from_f32<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* o, float* part_acc,
                   float* part_ml, int B, int S, int Hq, int Hkv, int hd,
                   int window, float scale, int nsplit, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes<HD>(Hq / Hkv);
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  decode_kernel<T, HD><<<dim3(nsplit, B * Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      lengths, static_cast<T*>(o), part_acc, part_ml, S, Hq, Hkv, hd, window,
      scale, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess || nsplit == 1) return err;
  decode_merge_kernel<T, HD><<<B * Hkv, kThreads, 0, stream>>>(
      part_acc, part_ml, static_cast<T*>(o), B * Hkv, Hq, Hkv, hd, nsplit);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v,
                        const int* lengths, void* o, float* part_acc,
                        float* part_ml, int B, int S, int Hq, int Hkv, int hd,
                        int window, float scale, int nsplit, cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, lengths, o, part_acc, part_ml, B, S, Hq, Hkv, hd, window, scale, nsplit, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, lengths, o, part_acc, part_ml, B, S, Hq, Hkv, hd, window, scale, nsplit, stream);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, lengths, o, part_acc, part_ml, B, S, Hq, Hkv, hd, window, scale, nsplit, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory one block needs (0 for an unsupported hd):
// the wrapper refuses shapes above the card's per-block limit.
extern "C" long long repro_decode_attention_smem(int G, int hd) {
  if (G <= 0) return 0;
  if (hd <= 64) return (long long)decode_smem_bytes<64>(G);
  if (hd <= 128) return (long long)decode_smem_bytes<128>(G);
  if (hd <= 256) return (long long)decode_smem_bytes<256>(G);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. part_acc / part_ml are scratch of
// nsplit * B * Hkv * G * {bucketed hd, 2} floats (unused when nsplit == 1).
// Returns the launches' cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v,
                                      const void* lengths, void* o,
                                      void* part_acc, void* part_ml, int B,
                                      int S, int Hq, int Hkv, int hd,
                                      int window, float scale, int nsplit,
                                      int dtype, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || nsplit <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* len = static_cast<const int*>(lengths);
  float* pa = static_cast<float*>(part_acc);
  float* pm = static_cast<float*>(part_ml);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, len, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, nsplit, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, len, o, pa, pm, B, S, Hq, Hkv, hd, window, scale, nsplit, s);
  return (int)cudaErrorInvalidValue;
}
