// Blockwise fused attention (prefill) for Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` / `_flash_kernel` in
// src/repro/kernels/flash_attention.py (the `pl.pallas_call` at :127). It
// computes the same function: softmax(q k^T * scale + mask) v with an online
// softmax (running max m, denominator l and accumulator acc in f32; the
// denominator floored at 1e-30), GQA kv head = h / (Hq / Hkv), masks for key
// validity, causality (k_pos <= q_offset + i) and a sliding window
// (q_pos - k_pos < window). Key tiles that are wholly masked are never
// visited: each block computes its live key range from q_offset, window, Sq
// and Sk.
//
// What bounds it: at the serving path's shapes (granite-3-2b prefill,
// Sq = Sk = 1024, Hq 32, hd 64; gemma3-12b local layers, hd 240, window
// 1024) the work is 4 * Hq * hd operations per visible (q, k) pair against a
// few MB of q/k/v, far above the H100's 295 operations per byte: the bound is
// the bf16 tensor cores' 989 TFLOP/s (4.35 us at granite's shape).
//
// The bf16 kernel (the serving path) puts both products on the tensor cores:
//   * a block owns NWG warpgroups x 64 query rows of one (b, q-head) (one
//     warpgroup at hd 64, two at hd 128/256), which share every K/V tile;
//   * thread 0 brings Q in, and the K and V tiles into a ring of STAGES
//     stages, with TMA; each tile has its own mbarrier (K and V apart, so
//     S = Q K^T starts before V lands). It refills a stage once every
//     warpgroup has released it through the stage's "empty" barrier. There
//     is no producer warp: ptxas budgets registers per SM sub-partition and
//     for the whole kernel (setmaxnreg notwithstanding), so a fifth warp in
//     a block costs the consumers registers or a block per SM;
//   * tiles are boxes of 64 columns with the 128-byte swizzle that the wgmma
//     shared-memory descriptors read; hd > 64 takes several boxes, and TMA
//     zero-fills what lies past Sk, Sq or hd (hd 48, 72, 80, 168, 240 need no
//     masked loads). Q/K/V are viewed as 4-D (hd, H, S, B) tensors with byte
//     strides; TMA wants 16-byte strides, so bf16 needs hd % 8 == 0. The
//     wrapper (flash_attention.py) computes these views, and the launch
//     refuses one whose box is not this kernel's tile;
//   * S = Q K^T is wgmma m64nBKk16 with both operands in shared memory; the
//     online softmax runs on the accumulator registers (row max and sum over
//     the four lanes of a row by shuffles, exp2 with the scale folded in);
//     masks are applied only on tiles that cross Sk, the diagonal or the
//     window's edge;
//   * O += P V is wgmma with P rounded to bf16 in registers (the RS form: the
//     S accumulator layout is the A-fragment layout, so no shuffle is needed)
//     and V read MN-major from shared memory (the transposed-B form);
//   * blockIdx.y runs over q-tiles from the last (most live key tiles under
//     causality) to the first, so the longest blocks start first.
// Time on the card (one chip_smoke.py run; NVIDIA H100 80GB HBM3, 700 W):
// granite-3-2b 0.0206 ms against its 0.00435 ms bound (SDPA 0.0239 ms);
// gemma3-12b's local layer (hd 240, window 1024) 0.0532 ms against 0.0163 ms
// (SDPA 0.213 ms). PERF.md keeps the earlier times too.
//
// The float32 kernel stays on the CUDA cores by choice, not as a fallback:
// tensor-core f32 is TF32, which would miss the 2e-5 f32 tolerance, and the
// serving path is bf16. One block owns BQ query rows of one (b, q-head);
// K/V tiles are staged in shared memory as f32 (rows padded by one word);
// TPR neighbouring lanes of a warp own one query row.

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ======================================================================
// float32: CUDA cores
// ======================================================================
constexpr int kThreads = 256;

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
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
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
    if (rr < nq && d < hd) x = q[(((size_t)b * Sq + q0 + rr) * Hq + h) * hd + d];
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
      if (kp < Sk && d < hd) x = k[(((size_t)b * Sk + kp) * Hkv + kvh) * hd + d];
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
      if (kp < Sk && d < hd) x = v[(((size_t)b * Sk + kp) * Hkv + kvh) * hd + d];
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
      if (d < hd) o[(((size_t)b * Sq + q0 + r) * Hq + h) * hd + d] = acc[i] / denom;
    }
  }
}

template <int HD>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       int B, int Sq, int Sk, int Hq, int Hkv, int hd,
                       int causal, int window, int q_offset, float scale,
                       cudaStream_t stream) {
  constexpr size_t smem = flash_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  const dim3 grid((Sq + FlashShape<HD>::BQ - 1) / FlashShape<HD>::BQ, B * Hq);
  flash_kernel<HD><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Sq, Sk, Hq, Hkv, hd,
      causal, window, q_offset, scale);
  return cudaGetLastError();
}

// ======================================================================
// bfloat16: wgmma tensor cores fed by TMA
// ======================================================================
constexpr int kWgRows = 64;                // query rows per consumer warpgroup
constexpr uint32_t kBoxBytes = 128;        // one swizzled row of a 64-column box

// HD: head-dim bucket. A block is NWG warpgroups of 64 query rows each that
// share every K/V tile of BK keys; STAGES tiles are in flight; MIN_BLOCKS
// blocks share an SM. hd 64: one warpgroup, 128-key tiles, two blocks an SM
// (chosen on the card over 64-key tiles and over two warpgroups a block);
// hd 128 and 256: two warpgroups and one block an SM, where the f32
// accumulator alone is 64 or 128 registers a thread.
template <int HD> struct TcShape;
template <int NWG_, int BK_, int STAGES_, int MIN_BLOCKS_>
struct TcTile {
  static constexpr int NWG = NWG_, BK = BK_, STAGES = STAGES_, MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int BQ = kWgRows * NWG, THREADS = 128 * NWG;
};
template <> struct TcShape<64> : TcTile<1, 128, 2, 2> {};
template <> struct TcShape<128> : TcTile<2, 64, 2, 1> {};
template <> struct TcShape<256> : TcTile<2, 64, 2, 1> {};

template <int HD>
constexpr size_t tc_smem_bytes() {
  // Q (HD/64 boxes of BQ rows) + STAGES x (K + V), each HD/64 boxes of BK
  // rows, plus 1 KB to align the base to the 1024-byte swizzle period.
  return (size_t)(HD / 64) * kBoxBytes *
             (TcShape<HD>::BQ + 2 * (size_t)TcShape<HD>::STAGES * TcShape<HD>::BK) + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that never
// ends (a lost arrival) traps, which fails the launch instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (uint32_t tries = 0;; ++tries) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (tries == (1u << 24)) __trap();
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Shared-memory matrix descriptor for the 128-byte swizzle (layout type 1):
// start address, leading and stride byte offsets, all in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_wait_all() { asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory"); }

// Keep the compiler from moving reads or writes of wgmma registers across
// the asynchronous products.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
// The same for A fragments in registers, which an in-flight wgmma still
// reads: fencing them after its wait keeps their registers from being reused
// before then.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// 2^x in one MUFU instruction (exp2f adds range handling around it);
// denormal results flush to 0, far below anything a softmax sum can see.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// The value x, hidden from the optimizer: descriptors built from it inside a
// loop are rebuilt there (a few adds) instead of being hoisted out and held
// in registers the accumulators need.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// S (64 x BK) = Q (64 x HD) K^T: HD / 16 k16 steps; both operands K-major
// in 128-byte-swizzled boxes of 64 columns (a k16 step is 32 bytes of a row).
template <int HD, int BK>
__device__ __forceinline__ void issue_qk(float (&sc)[BK / 2], uint32_t q_addr,
                                         uint32_t k_addr) {
  const uint64_t qd = desc_sw128(q_addr, 16, 1024);
  const uint64_t kd = desc_sw128(k_addr, 16, 1024);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t qoff = (kk / 4) * kWgRows * kBoxBytes + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * BK * kBoxBytes + (kk % 4) * 32;
    wgmma_ss(sc, qd + (qoff >> 4), kd + (koff >> 4), kk > 0 ? 1 : 0);
  }
}

// O (64 x HD) += P (64 x BK, bf16 registers) V: BK / 16 k16 steps; V is
// MN-major, 8 key rows 1024 bytes apart, 64-column boxes BK * 128 apart.
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2], const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_addr) {
  const uint64_t vd = desc_sw128(v_addr, BK * kBoxBytes, 1024);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs(acc, pa[kk], vd + ((kk * 16 * kBoxBytes) >> 4), 1);
}

// The running softmax state of a lane's two rows (r0 and r0 + 8 of its
// warpgroup's 64): max m and denominator l in log2 units, and the rescale al
// of the accumulator from the last tile.
template <int BK>
struct RowSoftmax {
  float m0, m1, l0, l1, al0, al1;
  int qp0, qp1, cq;  // the rows' query positions; the lane's first column

  // Softmax of the S tile at key k0 (raw scores in sc; scaled, masked and
  // turned into log2 units in place); writes P as bf16 A fragments to p.
  __device__ __forceinline__ void softmax(float (&sc)[BK / 2], int k0,
                                          uint32_t (&p)[BK / 16][4], int Sk, int causal,
                                          int window, int q_first, float scale_log2) {
    constexpr int NS = BK / 2;
    const bool masked = k0 + BK > Sk || (causal && k0 + BK - 1 > q_first) ||
                        (window > 0 && q_first + kWgRows - 1 - k0 >= window);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      float x = sc[i] * scale_log2;
      if (masked) {
        const int kp = k0 + 8 * (i / 4) + cq + (i & 1);
        const int qp = (i & 2) ? qp1 : qp0;
        bool ok = kp < Sk;
        if (causal) ok = ok && kp <= qp;
        if (window > 0) ok = ok && qp - kp < window;
        x = ok ? x : -INFINITY;
      }
      sc[i] = x;
      if (i & 2) mx1 = fmaxf(mx1, x); else mx0 = fmaxf(mx0, x);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float mu0 = mn0 == -INFINITY ? 0.f : mn0;  // a row with nothing live yet
    const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
    al0 = fast_exp2(m0 - mu0);
    al1 = fast_exp2(m1 - mu1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int i = 0; i < NS; i += 2) {
      const float mu = (i & 2) ? mu1 : mu0;
      const float p0 = fast_exp2(sc[i] - mu), p1 = fast_exp2(sc[i + 1] - mu);
      if (i & 2) ps1 += p0 + p1; else ps0 += p0 + p1;
      // 8-column block i/4 of the key tile feeds k-step (i/4)/2, A register
      // 2 * ((i/4) & 1) + (row r0 + 8 ? 1 : 0)
      p[i / 8][2 * ((i / 4) & 1) + ((i & 2) ? 1 : 0)] = pack_bf16(p0, p1);
    }
    l0 = l0 * al0 + ps0;  // per lane: the row sums are reduced at the end
    l1 = l1 * al1 + ps1;
  }
};

// tq: q as (hd, Hq, Sq, B), box (64, 1, 64, 1); tk / tv: k / v as
// (hd, Hkv, Sk, B), box (64, 1, BK, 1); all 128-byte swizzled.
// grid = (B * Hq, ceil(Sq / BQ)), block = THREADS.
template <int HD>
__global__ void __launch_bounds__(TcShape<HD>::THREADS, TcShape<HD>::MIN_BLOCKS)
flash_tc_kernel(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                __nv_bfloat16* __restrict__ o, int Sq, int Sk, int Hq, int Hkv,
                int hd, int causal, int window, int q_offset, float scale_log2) {
  constexpr int BK = TcShape<HD>::BK;
  constexpr int STAGES = TcShape<HD>::STAGES;
  constexpr int NWG = TcShape<HD>::NWG;
  constexpr int BQ = TcShape<HD>::BQ;
  constexpr int NB = HD / 64;                      // 64-column boxes per row
  constexpr uint32_t Q_BOX = kWgRows * kBoxBytes;  // one warpgroup's rows
  constexpr uint32_t KV_BOX = BK * kBoxBytes;
  constexpr uint32_t KV_TILE = NB * KV_BOX;
  constexpr int NS = BK / 2;                       // S accumulator registers
  constexpr int NO = HD / 2;                       // O accumulator registers

  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t bars[1 + 3 * STAGES];
  const uint32_t sq = (smem_u32(smem_raw) + 1023u) & ~1023u;  // [wg][box]
  const uint32_t skv = sq + NWG * NB * Q_BOX;  // stage s: K, then V
  const uint32_t qbar = smem_u32(&bars[0]);
  const uint32_t kfull0 = smem_u32(&bars[1]);
  const uint32_t vfull0 = smem_u32(&bars[1 + STAGES]);
  const uint32_t empty0 = smem_u32(&bars[1 + 2 * STAGES]);

  const int bh = blockIdx.x;
  const int b = bh / Hq, h = bh % Hq;
  const int kvh = h / (Hq / Hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int nq = min(BQ, Sq - q0);
  const int k_first = window > 0 ? max(0, q_offset + q0 - window + 1) : 0;
  const int k_last = causal ? min(Sk - 1, q_offset + q0 + nq - 1) : Sk - 1;
  const int t_first = k_first / BK;
  const int n_tiles = k_last >= k_first ? k_last / BK - t_first + 1 : 0;

  auto stage_of = [](int t) { return (uint32_t)(t % STAGES); };
  auto parity = [](int t) { return (uint32_t)((t / STAGES) & 1); };
  auto k_addr = [&](int t) { return skv + 2 * stage_of(t) * KV_TILE; };
  // Thread 0 brings tile t into its stage: K and V each on their own barrier.
  auto load_tile = [&](int t) {
    const int k0 = (t_first + t) * BK;
    const uint32_t kf = kfull0 + 8 * stage_of(t), vf = vfull0 + 8 * stage_of(t);
    mbar_expect_tx(kf, KV_TILE);
#pragma unroll
    for (int j = 0; j < NB; ++j) tma_load_4d(k_addr(t) + j * KV_BOX, &tk, kf, 64 * j, kvh, k0, b);
    mbar_expect_tx(vf, KV_TILE);
#pragma unroll
    for (int j = 0; j < NB; ++j)
      tma_load_4d(k_addr(t) + KV_TILE + j * KV_BOX, &tv, vf, 64 * j, kvh, k0, b);
  };

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(kfull0 + 8 * s, 1);
      mbar_init(vfull0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, TcShape<HD>::THREADS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qbar, NWG * NB * Q_BOX);
#pragma unroll
    for (int w = 0; w < NWG; ++w)
#pragma unroll
      for (int j = 0; j < NB; ++j)
        tma_load_4d(sq + (w * NB + j) * Q_BOX, &tq, qbar, 64 * j, h, q0 + w * kWgRows, b);
    for (int t = 0; t < min(STAGES, n_tiles); ++t) load_tile(t);
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int qw = q0 + wg * kWgRows;                // this warpgroup's first row
  const int nw = min(kWgRows, Sq - qw);
  const int r0 = warp * 16 + lane / 4;             // rows r0 and r0 + 8 of the tile
  const int qp0 = q_offset + qw + r0, qp1 = qp0 + 8;
  const int cq = 2 * (lane % 4);                   // this lane's columns in each 8-column block
  const uint32_t sqw = sq + wg * NB * Q_BOX;
  // this warpgroup's live tiles [u0, u1) of the block's [0, n_tiles)
  const int kf = window > 0 ? max(0, q_offset + qw - window + 1) : 0;
  const int kl = causal ? min(Sk - 1, q_offset + qw + nw - 1) : Sk - 1;
  const bool live = nw > 0 && kl >= kf;
  const int u0 = live ? max(0, kf / BK - t_first) : 0;
  const int u1 = live ? max(u0, min(n_tiles, kl / BK - t_first + 1)) : 0;

  float acc[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  RowSoftmax<BK> rs{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f, qp0, qp1, cq};
  float sc[NS];
  uint32_t pa[BK / 16][4];

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    // Thread 0 refills the stage that tile t-1 used, once both warpgroups
    // have released it, with the tile STAGES - 1 ahead of t.
    if (threadIdx.x == 0 && t >= 1 && t - 1 + STAGES < n_tiles) {
      mbar_wait(empty0 + 8 * stage_of(t - 1), parity(t - 1));
      load_tile(t - 1 + STAGES);
    }
    mbar_wait(kfull0 + 8 * stage_of(t), parity(t));
    __syncwarp();                                  // wgmma wants converged warps
    if (t < u0 || t >= u1) {                       // warpgroup-uniform
      // Outside this warpgroup's live keys: released unread, but only once
      // it has landed (an earlier arrival could complete the stage's next
      // phase while the other warpgroup still reads it).
      mbar_arrive(empty0 + 8 * stage_of(t));
      continue;
    }
    // S = Q K^T (columns past hd are zero-filled)
#pragma unroll
    for (int i = 0; i < NS; ++i) sc[i] = 0.f;
    fence_regs(sc);
    wg_fence();
    issue_qk<HD, BK>(sc, opaque(sqw), k_addr(t));
    wg_commit();
    wg_wait_all();
    fence_regs(sc);
    rs.softmax(sc, (t_first + t) * BK, pa, Sk, causal, window, q_offset + qw, scale_log2);
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= (i & 2) ? rs.al1 : rs.al0;
    // O += P V
    mbar_wait(vfull0 + 8 * stage_of(t), parity(t));
    fence_regs(acc);
    wg_fence();
    issue_pv<HD, BK>(acc, pa, k_addr(t) + KV_TILE);
    wg_commit();
    wg_wait_all();
    fence_regs(acc);
    fence_regs(pa);
    mbar_arrive(empty0 + 8 * stage_of(t));
  }

  float l0 = rs.l0, l1 = rs.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + (((size_t)b * Sq + qw + r0) * Hq + h) * hd;
  __nv_bfloat16* o1 = o0 + (size_t)8 * Hq * hd;
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int c = 8 * i + cq;
    if (c < hd) {
      if (r0 < nw)
        *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(acc[4 * i] * inv0, acc[4 * i + 1] * inv0);
      if (r0 + 8 < nw)
        *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(acc[4 * i + 2] * inv1, acc[4 * i + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------- host side
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda. Looked up once.
EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) p = nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The wrapper describes each tensor map as 11 numbers: dims (hd, H, S, B)
// innermost first, the byte strides of dims 1..3, and the box (64, 1, rows,
// 1). Accepted only if it is a (B, S, H, hd) tensor with 16-byte strides that
// do not overlap, read in boxes of `rows` rows: the box is the kernel's
// compiled tile, so a wrapper whose tile sizes drift from it is refused.
constexpr int kTmapArgs = 11;

bool tmap_fits(const unsigned long long* g, int B, int S, int H, int hd, int rows) {
  const unsigned long long *dims = g, *strides = g + 4, *box = g + 7;
  return dims[0] == (unsigned long long)hd && dims[1] == (unsigned long long)H &&
         dims[2] == (unsigned long long)S && dims[3] == (unsigned long long)B &&
         strides[0] % 16 == 0 && strides[1] % 16 == 0 && strides[2] % 16 == 0 &&
         strides[0] >= 2ull * hd && strides[1] >= strides[0] * H &&
         strides[2] >= strides[1] * S && box[0] == 64 && box[1] == 1 &&
         box[2] == (unsigned long long)rows && box[3] == 1;
}

cudaError_t make_tmap(CUtensorMap* map, const void* ptr, const unsigned long long* g) {
  const EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4];
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = g[i];
  for (int i = 0; i < 3; ++i) strides[i] = g[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)g[7 + i];
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B,
                      int Sq, int Sk, int Hq, int Hkv, int hd, int causal,
                      int window, int q_offset, float scale, const unsigned long long* tma,
                      cudaStream_t stream) {
  // tma: q's map (boxes of one warpgroup's rows), then k's and v's (BK rows)
  if (tma == nullptr || !tmap_fits(tma, B, Sq, Hq, hd, kWgRows) ||
      !tmap_fits(tma + kTmapArgs, B, Sk, Hkv, hd, TcShape<HD>::BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = tc_smem_bytes<HD>();
  static const cudaError_t attr = cudaFuncSetAttribute(
      flash_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (attr != cudaSuccess) return attr;
  CUtensorMap tq, tk, tv;
  cudaError_t err = make_tmap(&tq, q, tma);
  if (err == cudaSuccess) err = make_tmap(&tk, k, tma + kTmapArgs);
  if (err == cudaSuccess) err = make_tmap(&tv, v, tma + kTmapArgs);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * Hq, (Sq + TcShape<HD>::BQ - 1) / TcShape<HD>::BQ);
  flash_tc_kernel<HD><<<grid, TcShape<HD>::THREADS, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), Sq, Sk, Hq, Hkv, hd, causal, window,
      q_offset, scale * kLog2e);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory one block uses at head dim hd for dtype
// (0 = float32, 1 = bfloat16); 0 when the shape is not supported.
extern "C" long long repro_flash_attention_smem(int hd, int dtype) {
  if (hd <= 0 || hd > 256) return 0;
  if (dtype == 0)
    return (long long)(hd <= 64 ? flash_smem_bytes<64>()
                       : hd <= 128 ? flash_smem_bytes<128>() : flash_smem_bytes<256>());
  if (dtype == 1)
    return (long long)(hd <= 64 ? tc_smem_bytes<64>()
                       : hd <= 128 ? tc_smem_bytes<128>() : tc_smem_bytes<256>());
  return 0;
}

// dtype: 0 = float32 (CUDA cores), 1 = bfloat16 (wgmma + TMA; hd % 8 == 0
// and 16-byte aligned pointers). tma: for bfloat16, q's then k's and v's
// tensor map as 2 x 11 numbers (see tmap_fits); unused for float32. Returns
// the launch's cudaError_t.
extern "C" int repro_flash_attention(const void* q, const void* k, const void* v,
                                     void* o, int B, int Sq, int Sk, int Hq,
                                     int Hkv, int hd, int causal, int window,
                                     int q_offset, float scale, int dtype,
                                     const unsigned long long* tma, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || Hkv <= 0 || Hq % Hkv != 0 || hd <= 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hd <= 64)
      return (int)launch_f32<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, s);
    if (hd <= 128)
      return (int)launch_f32<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, s);
    return (int)launch_f32<256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, s);
  }
  if (dtype == 1) {
    if (hd % 8 != 0) return (int)cudaErrorInvalidValue;
    if (hd <= 64)
      return (int)launch_tc<64>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, tma, s);
    if (hd <= 128)
      return (int)launch_tc<128>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, tma, s);
    return (int)launch_tc<256>(q, k, v, o, B, Sq, Sk, Hq, Hkv, hd, causal, window, q_offset, scale, tma, s);
  }
  return (int)cudaErrorInvalidValue;
}
