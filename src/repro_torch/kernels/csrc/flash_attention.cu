// Blockwise fused attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (the `pl.pallas_call` at :127). It
// computes the same function: softmax(q k^T * scale + mask) v with an online
// softmax (running max m, denominator l and accumulator acc in f32; the
// denominator floored at 1e-30), GQA kv head = h / (Hq / Hkv), masks for key
// validity, causality (k_pos <= q_offset + i) and a sliding window
// (q_pos - k_pos < window), and key tiles that are wholly masked are never
// visited.
//
// What bounds it on this card: at the serving path's shapes (granite-3-2b
// prefill, Sq = Sk = 1024, Hq 32, hd 64) the work is 4 * Hq * hd * (causal
// pairs) operations against a few MB of q/k/v, far above the H100's
// 295 operations per byte, so the bound is the tensor cores' 989 TFLOP/s.
//
// What this design does about it, and what it does not yet: the TPU kernel
// carries (m, l, acc) across a sequential grid axis; Hopper's blocks run in
// no order, so one block owns a tile of BQ query rows of one (b, q-head) and
// sweeps the live key tiles in a loop. The key range is computed from
// q_offset, window, Sq and Sk, so dead tiles cost nothing. K and V tiles are
// staged in shared memory as f32 (rows padded by one word against bank
// conflicts); each query row is owned by TPR neighbouring lanes of one warp,
// which hold its scores and accumulator columns in registers and reduce the
// row max and sum with warp shuffles. The products run on the f32 CUDA cores,
// not the tensor cores: this is the simple, exact first version. wgmma, TMA
// and warp specialisation are later work.
//
// hd is bucketed to a template width HD in {64, 128, 256}; lanes beyond hd
// load zeros, so any hd <= 256 (48, 72, 80, 240 included) is computed
// exactly. Element types: float and __nv_bfloat16 (loads widen to f32 with
// the bf16 intrinsics; the output is rounded to nearest even).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 256;

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

template <int HD> struct FlashShape;
template <> struct FlashShape<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct FlashShape<128> { static constexpr int BQ = 64, BK = 64; };
template <> struct FlashShape<256> { static constexpr int BQ = 32, BK = 64; };

template <int HD>
constexpr size_t flash_smem_bytes() {
  return sizeof(float) * ((size_t)FlashShape<HD>::BQ * (HD + 1) +
                          (size_t)FlashShape<HD>::BK * (HD + 1) +
                          (size_t)FlashShape<HD>::BQ * (FlashShape<HD>::BK + 1));
}

// q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd); o: (B, Sq, Hq, hd); contiguous.
// grid = (ceil(Sq / BQ), B * Hq), block = kThreads.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
             int Hq, int Hkv, int hd, int causal, int window, int q_offset,
             float scale) {
  constexpr int BQ = FlashShape<HD>::BQ;
  constexpr int BK = FlashShape<HD>::BK;
  constexpr int TPR = kThreads / BQ;  // lanes that share one query row
  constexpr int NC = HD / TPR;        // accumulator columns per lane
  constexpr int NS = BK / TPR;        // scores per lane per key tile
  constexpr int LD = HD + 1;
  constexpr int LDP = BK + 1;
  static_assert(32 % TPR == 0 && NS <= 32, "row group must sit in one warp");

  extern __shared__ float smem[];
  float* qs = smem;             // BQ x LD
  float* kvs = qs + BQ * LD;    // BK x LD: K tile, then V tile
  float* ps = kvs + BK * LD;    // BQ x LDP: probabilities of the tile

  const int tid = threadIdx.x;
  const int b = blockIdx.y / Hq;
  const int h = blockIdx.y % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = blockIdx.x * BQ;
  const int nq = min(BQ, Sq - q0);
  const int r = tid / TPR;
  const int c = tid % TPR;
  const bool row_ok = r < nq;
  const int qp = q_offset + q0 + r;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int rr = i / HD, d = i % HD;
    float x = 0.f;
    if (rr < nq && d < hd) x = to_f32(q[(((size_t)b * Sq + q0 + rr) * Hq + h) * hd + d]);
    qs[rr * LD + d] = x;
  }

  // live key range of this query tile
  int k_first = 0;
  int k_last = Sk - 1;
  if (causal) k_last = min(k_last, q_offset + q0 + nq - 1);
  if (window > 0) k_first = max(0, q_offset + q0 - window + 1);

  float acc[NC];
#pragma unroll
  for (int i = 0; i < NC; ++i) acc[i] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int k0 = (k_first / BK) * BK; k0 <= k_last; k0 += BK) {
    __syncthreads();  // the previous tile's V reads (and the q stores) are done
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const int kp = k0 + t;
      float x = 0.f;
      if (kp < Sk && d < hd) x = to_f32(k[(((size_t)b * Sk + kp) * Hkv + kvh) * hd + d]);
      kvs[t * LD + d] = x;
    }
    __syncthreads();

    float s[NS];
    unsigned okm = 0u;
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const int t = c + j * TPR;
      const int kp = k0 + t;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < HD; ++d) dot = fmaf(qs[r * LD + d], kvs[t * LD + d], dot);
      bool ok = row_ok && kp < Sk;
      if (causal) ok = ok && kp <= qp;
      if (window > 0) ok = ok && (qp - kp) < window;
      s[j] = ok ? dot * scale : kNegInf;
      okm |= (ok ? 1u : 0u) << j;
      tmax = fmaxf(tmax, s[j]);
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      const float p = ((okm >> j) & 1u) ? expf(s[j] - m_new) : 0.f;
      ps[r * LDP + c + j * TPR] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[i] *= alpha;

    __syncthreads();  // every lane is done with the K tile
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int t = i / HD, d = i % HD;
      const int kp = k0 + t;
      float x = 0.f;
      if (kp < Sk && d < hd) x = to_f32(v[(((size_t)b * Sk + kp) * Hkv + kvh) * hd + d]);
      kvs[t * LD + d] = x;
    }
    __syncthreads();
    for (int t = 0; t < BK; ++t) {
      const float p = ps[r * LDP + t];
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[i] = fmaf(p, kvs[t * LD + c + i * TPR], acc[i]);
    }
  }

  if (row_ok) {
    const float denom = fmaxf(l, 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const int d = c + i * TPR;
      if (d < hd) o[(((size_t)b * Sq + q0 + r) * Hq + h) * hd + d] = from_f32<T>(acc[i] / denom);
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                   int window, int q_offset, float scale, cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + FlashShape<HD>::BQ - 1) / FlashShape<HD>::BQ, B * Hq);
  flash_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* q, const void* k, const void* v, void* o,
                        int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                        int causal, int window, int q_offset, float scale,
                        cudaStream_t stream) {
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, stream);
  if (hd <= 256)
    return launch<T, 256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// Bytes of dynamic shared memory one block uses at head dim hd (0 when hd
// is not supported).
extern "C" long long repro_flash_attention_smem(int hd) {
  if (hd <= 0) return 0;
  if (hd <= 64) return (long long)flash_smem_bytes<64>();
  if (hd <= 128) return (long long)flash_smem_bytes<128>();
  if (hd <= 256) return (long long)flash_smem_bytes<256>();
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. Returns the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Sk, int Hq,
                                     int Hkv, int hd, int causal, int window,
                                     int q_offset, float scale, int dtype,
                                     void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch_hd<float>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, s);
  if (dtype == 1)
    return (int)dispatch_hd<__nv_bfloat16>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, s);
  return (int)cudaErrorInvalidValue;
}
