// The chunked SSD of a Mamba2 prefill (Dao & Gu 2024, "Transformers are
// SSMs", section 6), for Hopper, sm_90a.
//
// Replaces no TPU kernel: the reference computes the SSD in plain jnp under
// lax.scan (src/repro/models/ssm.py), and the port's plain version is
// models/ssm.py's _ssd_scan. It was added because that plain version, run op
// by op on the card, held ~85 % of a Zamba2-7B prefill: it builds every
// chunk's (chunk, head, Q, Q) f32 decay matrix in device memory (176 MB a
// layer at 3,072 tokens), passes it through a subtraction, a where, an exp
// and two broadcast multiplies into W, multiplies W @ x as an f32 GEMM, and
// carries the state through a Python loop of two launches a chunk: ~1.8 GB
// of traffic and ~100 launches a layer, 81 layers a prefill.
//
// What bounds it: f32 FMAs. At 3,072 tokens, 112 heads of P = 64, N = 64 and
// two B/C groups, a layer needs ~8.5 GFLOP (each chunk's state increment and
// the carried state's term, 4 h P N S; the intra-chunk term over causal
// pairs, 2 (G N + h P) pairs), against ~138 MB of bytes (x, B, C in bf16, dt
// and the log-decay, y and the final state in f32): 127 us at the card's
// 67 TFLOP/s of f32 outside the tensor cores, 41 us at 3.35 TB/s. The
// products stay in f32, as the plain version's are: a single TF32 or bf16
// pass over the f32-valued operands (the decay- and dt-scaled x, W, the
// carried state) would be a lower precision.
//
// What the design does about it: nothing of size (chunk, head, Q, Q) leaves
// the SM. Three kernels, the paper's split:
//   (a) ssd_chunk_state, one block per (chunk, head, b): the within-chunk
//       cumulative log-decay l (a sequential f32 sum, as torch.cumsum
//       along a non-inner dimension runs on the card) and the chunk's
//       increment sum_s exp(l_last - l_s) dt_s x_s (x) B_s, P x N, from x
//       and B staged in shared memory as f32; it writes the increment and
//       l (Q floats) for the other two kernels. C . B^T depends on the
//       chunk and the B/C group only, so G further blocks a chunk form it
//       once for the group's heads (56 at Zamba2-7B), Q x Q f32 per chunk
//       and group (3 MB at 3,072 tokens, read back from L2).
//   (b) ssd_state_pass, one thread per four (b, head, p, n) elements: the
//       carry h <- exp(l_last) h + inc over the chunks in one loop, in
//       place (each chunk's increment is overwritten by its starting
//       state), with four chunks' 16-byte loads in flight; the final state
//       is the prefill's decode state.
//   (c) ssd_chunk_out, one block per (half chunk of 64 rows t, head, b):
//       y_t = sum_{s<=t} (C_t . B_s) exp(l_t - l_s) dt_s x_s
//             + exp(l_t) C_t . h_start + D x_t,
//       C . B^T scaled by the head's decay and dt and masked into W^T in
//       shared memory (the decay only for s <= t, so no exp of a positive
//       difference), then W^T x and C h_start in one pass; y written
//       straight in (B, S, h P) f32 order. Each head reads its own group's
//       B and C.
// Every product is a register tile per thread (4 x 4, or 8 x 4 for C B^T)
// fed by 16-byte shared loads. A ragged last chunk is masked on load (x, B,
// C, dt and the log-decay read 0 past S, which leaves the state unchanged),
// so nothing is padded in device memory. Each product sums in the plain
// version's order (one fma chain over the contraction, elementwise terms
// rounded as its separate ops round them). No atomics: every sum has one
// fixed order, so two runs give equal bits. Scratch in device memory: the
// chunk states (B, chunks, h, P, N), l (B, chunks, h, Q) and C B^T (B,
// chunks, groups, Q, Q), f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kQ = 128;              // chunk (models/ssm.py CHUNK)
constexpr int kTQ = 64;              // rows t of one ssd_chunk_out block
constexpr int kMax = 64;             // largest P and N
constexpr int kThreads = 256;
constexpr int kLd = kMax + 4;        // a padded shared row of 64 floats
constexpr int kLdB = kQ + 4;         // a padded shared row of 128 floats
constexpr int kDevices = 64;

// shared floats: (a) x and B, l, the weights, or C^T and B^T; (c) l, dt,
// C^T, h^T, W^T and x
constexpr int kStateFloats = 2 * kQ * kMax + 2 * kQ;
constexpr int kCbFloats = 2 * kMax * kLdB;
constexpr int kStateSmem =
    (kStateFloats > kCbFloats ? kStateFloats : kCbFloats) * 4;
constexpr int kOutSmem = (2 * kQ + 2 * kMax * kLd + 2 * kQ * kLd) * 4;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// four consecutive elements (16 bytes of f32, 8 of bf16) as floats
__device__ __forceinline__ float4 load4(const float* p) { return ld4(p); }
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ float at(float4 v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Stage a rows x w tile (w a multiple of 4, at most kMax) of rows ld apart
// into shared memory as f32, 0 past row `valid`: every load of the thread
// is in flight before the first store. Row-major (dst[r * dld + col]) or, with
// Trans, transposed (dst[col * dld + r]).
template <bool Trans, int Rows, typename T>
__device__ __forceinline__ void stage(float* dst, int dld, const T* __restrict__ src,
                                      int ld, int w, int valid) {
  constexpr int kIt = Rows * kMax / 4 / kThreads;
  const int wq = w / 4;
  float4 v[kIt];
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / wq, q = e - r * wq;
    v[i] = r < Rows && r < valid ? load4(src + (size_t)r * ld + 4 * q)
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kIt; ++i) {
    const int e = threadIdx.x + i * kThreads, r = e / wq, q = e - r * wq;
    if (r >= Rows) break;
    if (Trans) {
#pragma unroll
      for (int k = 0; k < 4; ++k) dst[(4 * q + k) * dld + r] = at(v[i], k);
    } else {
      *reinterpret_cast<float4*>(dst + r * dld + 4 * q) = v[i];
    }
  }
}

__device__ __forceinline__ void st4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// acc[i][k] += a[i] * b[k]
template <int I>
__device__ __forceinline__ void outer(float (&acc)[I][4], const float* a, float4 b) {
  const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < I; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[i][k] = fmaf(a[i], bv[k], acc[i][k]);
}

__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 a, float4 b) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  outer<4>(acc, av, b);
}

// C . B^T of one chunk and B/C group, stored transposed: cbT[s][t] = B_s . C_t;
// br: the chunk's first B of the group, its C at br + coff, rows ld apart
template <typename T>
__device__ __forceinline__ void chunk_cb(const T* __restrict__ br,
                                         float* __restrict__ cbT, float* sm,
                                         int S, int s0, int ld, int coff, int N) {
  float* sbt = sm;                               // [N][kLdB] B^T
  float* sct = sbt + kMax * kLdB;                // [N][kLdB] C^T
  const int tid = threadIdx.x;
  stage<true, kQ>(sbt, kLdB, br, ld, N, S - s0);
  stage<true, kQ>(sct, kLdB, br + coff, ld, N, S - s0);
  __syncthreads();
  const int sr = (tid / 16) * 8;                 // 8 rows s, 4 columns t
#pragma unroll 1
  for (int tc = (tid % 16) * 4; tc < kQ; tc += 64) {
    float acc[8][4] = {};
#pragma unroll 4
    for (int n = 0; n < N; ++n) {
      const float4 b0 = ld4(sbt + n * kLdB + sr), b1 = ld4(sbt + n * kLdB + sr + 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      outer<8>(acc, bv, ld4(sct + n * kLdB + tc));
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) st4(cbT + (sr + i) * kQ + tc, acc[i]);
  }
}

// (a) the chunk's state increment and its cumulative log-decay; the blocks
// past the heads form C . B^T of each B/C group the heads read
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_state(
    const T* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ loga, float* __restrict__ states,
    float* __restrict__ lcum, float* __restrict__ cbT, int S, int nc, int h,
    int P, int N, int ld, int gn, int h0, int per, int ng) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  const int c = blockIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, s0 = c * kQ;
  const T* row0 = xbc + ((size_t)b * S + s0) * ld;
  if (j >= h) {                                  // one B/C group's C . B^T
    const int gl = j - h, g = h0 / per + gl;
    chunk_cb(row0 + (size_t)h * P + (size_t)g * N,
             cbT + (((size_t)b * nc + c) * ng + gl) * kQ * kQ, sm, S, s0, ld,
             gn, N);
    return;
  }
  float* sx = sm;                                // [kQ][kMax] w_s x_s
  float* sb = sx + kQ * kMax;                    // [kQ][kMax] B_s
  float* sl = sb + kQ * kMax;                    // [kQ] l
  float* sw = sl + kQ;                           // [kQ] dt_s, then w_s
  const int g = (h0 + j) / per;
  const size_t bcj = ((size_t)b * nc + c) * h + j;
  if (tid < kQ) {
    const int s = s0 + tid;
    const size_t i = ((size_t)b * S + s) * h + j;
    sw[tid] = s < S ? dt[i] : 0.f;
    sl[tid] = s < S ? loga[i] : 0.f;
  }
  stage<false, kQ>(sx, kMax, row0 + (size_t)j * P, ld, P, S - s0);
  stage<false, kQ>(sb, kMax, row0 + (size_t)h * P + (size_t)g * N, ld, N, S - s0);
  __syncthreads();
  if (tid == 0) {                     // one chain of kQ adds, left to right
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kQ; t += 4) {
      float4 v = ld4(sl + t);
      v.x = acc = acc + v.x;
      v.y = acc = acc + v.y;
      v.z = acc = acc + v.z;
      v.w = acc = acc + v.w;
      *reinterpret_cast<float4*>(sl + t) = v;
    }
  }
  __syncthreads();
  if (tid < kQ) {
    lcum[bcj * kQ + tid] = sl[tid];
    sw[tid] = sw[tid] * expf(sl[kQ - 1] - sl[tid]);    // dt_s exp(l_last - l_s)
  }
  __syncthreads();
  for (int e = tid; e < kQ * P; e += kThreads) {      // w_s x_s
    const int s = e / P;
    sx[s * kMax + e - s * P] *= sw[s];
  }
  __syncthreads();
  const int tn = N / 4;
  if (tid >= (P / 4) * tn) return;
  const int p0 = (tid / tn) * 4, n0 = (tid % tn) * 4;
  float acc[4][4] = {};
#pragma unroll 4
  for (int s = 0; s < kQ; ++s)
    outer4(acc, ld4(sx + s * kMax + p0), ld4(sb + s * kMax + n0));
  float* out = states + bcj * P * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) st4(out + (p0 + i) * N + n0, acc[i]);
}

// (b) the carry over chunks: increments in, starting states out, in place;
// four elements a thread, four chunks' loads in flight
__global__ void __launch_bounds__(kThreads) ssd_state_pass(
    float* __restrict__ states, const float* __restrict__ lcum,
    float* __restrict__ final_state, int B, int nc, int h, int PN) {
  const size_t e = ((size_t)blockIdx.x * kThreads + threadIdx.x) * 4;
  if (e >= (size_t)B * h * PN) return;
  const int pn = (int)(e % PN);
  const size_t bj = e / PN;
  const int j = (int)(bj % h), b = (int)(bj / h);
  float hs[4] = {};
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 inc[4];
    float d[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      const size_t bcj = ((size_t)b * nc + c0 + k) * h + j;
      inc[k] = ld4(states + bcj * PN + pn);
      d[k] = expf(lcum[bcj * kQ + kQ - 1]);
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (c0 + k >= nc) break;
      st4(states + (((size_t)b * nc + c0 + k) * h + j) * PN + pn, hs);
      const float iv[4] = {inc[k].x, inc[k].y, inc[k].z, inc[k].w};
#pragma unroll
      for (int i = 0; i < 4; ++i)     // the plain version's order: exp(l_last) h, + inc
        hs[i] = __fadd_rn(__fmul_rn(d[k], hs[i]), iv[i]);
    }
  }
  st4(final_state + e, hs);
}

// (c) the output of 64 rows of one chunk and head
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_chunk_out(
    const T* __restrict__ xbc, const float* __restrict__ dt,
    const float* __restrict__ lcum, const float* __restrict__ states,
    const float* __restrict__ cbT, const float* __restrict__ Dv,
    float* __restrict__ y, int S, int nc, int h, int P, int N, int ld, int gn,
    int h0, int per, int ng) {
  extern __shared__ float4 smem4[];
  float* sl = reinterpret_cast<float*>(smem4);   // [kQ] l
  float* sdt = sl + kQ;                          // [kQ] dt
  float* sct = sdt + kQ;                         // [N][kLd] C^T, rows t0..
  float* sht = sct + kMax * kLd;                 // [N][kLd] h_start^T
  float* swt = sht + kMax * kLd;                 // [kQ][kLd] W^T
  float* sx = swt + kQ * kLd;                    // [kQ][kLd] x
  const int c = blockIdx.x >> 1, t0 = (blockIdx.x & 1) * kTQ, shi = t0 + kTQ;
  const int j = blockIdx.y, b = blockIdx.z, tid = threadIdx.x;
  const int s0 = c * kQ;
  if (s0 + t0 >= S) return;                      // rows past the sequence
  const int g = (h0 + j) / per;
  const size_t bcj = ((size_t)b * nc + c) * h + j;
  if (tid < kQ) {
    const int s = s0 + tid;
    sl[tid] = lcum[bcj * kQ + tid];
    sdt[tid] = s < S ? dt[((size_t)b * S + s) * h + j] : 0.f;
  }
  const T* row0 = xbc + ((size_t)b * S + s0) * ld;
  stage<true, kTQ>(sct, kLd, row0 + (size_t)(t0 * ld + h * P + gn + g * N), ld, N,
                   S - s0 - t0);
  stage<true, kMax>(sht, kLd, states + bcj * P * N, N, N, P);
  stage<false, kQ>(sx, kLd, row0 + (size_t)j * P, ld, P, min(shi, S - s0));
  __syncthreads();
  // W^T[s][t] = (C_t . B_s) exp(l_t - l_s) dt_s for s <= t, else 0: the
  // decay only where its exponent is not positive
  const float* cb = cbT + (((size_t)b * nc + c) * ng + g - h0 / per) * kQ * kQ;
  constexpr int kW = kQ * kTQ / 4 / kThreads;
  float4 cv[kW];
#pragma unroll
  for (int i = 0; i < kW; ++i) {      // rows s, four columns t from t0 + 4 tq
    const int e = tid + i * kThreads, s = e / (kTQ / 4), tq = e % (kTQ / 4);
    cv[i] = s < shi && s <= t0 + 4 * tq + 3 ? ld4(cb + s * kQ + t0 + 4 * tq)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int i = 0; i < kW; ++i) {
    const int e = tid + i * kThreads, s = e / (kTQ / 4), tq = e % (kTQ / 4);
    if (s >= shi) break;
    float w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int t = t0 + 4 * tq + k;
      w[k] = s <= t ? __fmul_rn(__fmul_rn(at(cv[i], k), expf(sl[t] - sl[s])), sdt[s])
                    : 0.f;
    }
    st4(swt + s * kLd + 4 * tq, w);
  }
  __syncthreads();
  const int tp = P / 4;
  if (tid >= (kTQ / 4) * tp) return;
  const int r0 = (tid / tp) * 4, q0 = (tid % tp) * 4;
  // the carried state seen from each row, exp(l_t) C_t . h_start, and the
  // intra-chunk term W x (W^T is zero past each row's own t)
  float inter[4][4] = {}, intra[4][4] = {};
#pragma unroll 4
  for (int n = 0; n < N; ++n)
    outer4(inter, ld4(sct + n * kLd + r0), ld4(sht + n * kLd + q0));
  const int send = t0 + r0 + 4;
#pragma unroll 4
  for (int s = 0; s < send; ++s)
    outer4(intra, ld4(swt + s * kLd + r0), ld4(sx + s * kLd + q0));
  const float d = Dv[j];
  const size_t hp = (size_t)h * P;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = t0 + r0 + i;
    if (s0 + t >= S) break;
    const float e = expf(sl[t]);
    const float4 xq = ld4(sx + t * kLd + q0);
    const float xv[4] = {xq.x, xq.y, xq.z, xq.w};
    float o[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)   // the plain version's order
      o[k] = __fadd_rn(__fadd_rn(intra[i][k], __fmul_rn(inter[i][k], e)),
                       __fmul_rn(d, xv[k]));
    st4(y + ((size_t)b * S + s0 + t) * hp + (size_t)j * P + q0, o);
  }
}

template <typename T>
cudaError_t launch(const void* xbc, const float* dt, const float* loga,
                   const float* D, float* y, float* final_state, float* states,
                   float* lcum, float* cbT, int B, int S, int h, int P, int N,
                   int G, int h0, int per, cudaStream_t stream) {
  static bool sized[kDevices] = {};  // the opt-in above 48 KB, once a device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= kDevices) return cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(ssd_chunk_state<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, kStateSmem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssd_chunk_out<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, kOutSmem);
    if (e != cudaSuccess) return e;
    sized[dev] = true;
  }
  const T* x = static_cast<const T*>(xbc);
  const int nc = (S + kQ - 1) / kQ, ld = h * P + 2 * G * N;
  const int ng = (h0 + h - 1) / per - h0 / per + 1;
  ssd_chunk_state<T><<<dim3(nc, h + ng, B), kThreads, kStateSmem, stream>>>(
      x, dt, loga, states, lcum, cbT, S, nc, h, P, N, ld, G * N, h0, per, ng);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const size_t n = (size_t)B * h * P * N / 4;
  ssd_state_pass<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
      states, lcum, final_state, B, nc, h, P * N);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  ssd_chunk_out<T><<<dim3(2 * nc, h, B), kThreads, kOutSmem, stream>>>(
      x, dt, lcum, states, cbT, D, y, S, nc, h, P, N, ld, G * N, h0, per, ng);
  return cudaGetLastError();
}

}  // namespace

// xbc: (B, S, h P + 2 G N) x | B | C in f32 (dtype 0) or bf16 (dtype 1);
// dt, loga: (B, S, h) f32; D: (h,) f32; y: (B, S, h P) f32; final_state:
// (B, h, P, N) f32; scratch, f32: states (B, chunks, h, P, N), lcum (B,
// chunks, h, 128) and cbT (B, chunks, groups of the heads, 128, 128). Heads
// are [h0, h0 + h) of the layer's, head k reading group k / per of B and C.
extern "C" int repro_ssd_scan(const void* xbc, const void* dt, const void* loga,
                              const void* D, void* y, void* final_state,
                              void* states, void* lcum, void* cbT, int B, int S,
                              int h, int P, int N, int G, int h0, int per,
                              int dtype, void* stream) {
  if (B <= 0 || S <= 0 || h <= 0 || G <= 0 || per <= 0 || h0 < 0 ||
      P <= 0 || P > kMax || P % 4 || N <= 0 || N > kMax || N % 4 ||
      (h0 + h - 1) / per >= G)
    return (int)cudaErrorInvalidValue;
  const float* f_dt = static_cast<const float*>(dt);
  const float* f_la = static_cast<const float*>(loga);
  const float* f_d = static_cast<const float*>(D);
  float* f_y = static_cast<float*>(y);
  float* f_h = static_cast<float*>(final_state);
  float* f_st = static_cast<float*>(states);
  float* f_l = static_cast<float*>(lcum);
  float* f_cb = static_cast<float*>(cbT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(xbc, f_dt, f_la, f_d, f_y, f_h, f_st, f_l, f_cb,
                                      B, S, h, P, N, G, h0, per, s);
  if (dtype == 0)
    return (int)launch<float>(xbc, f_dt, f_la, f_d, f_y, f_h, f_st, f_l, f_cb, B, S,
                              h, P, N, G, h0, per, s);
  return (int)cudaErrorInvalidValue;
}
