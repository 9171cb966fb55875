// Flash attention for Hopper (sm_90a): the CUDA-core bodies of the
// forward, dQ and dK/dV kernels, and the dispatcher over all bodies.
//
// Port of the three Pallas TPU kernels in
// distributed_learning_tpu/ops/flash_attention.py:
//   flash_fwd_kernel   <- _flash_kernel     (launched by _fwd_call)
//   flash_dq_kernel    <- _flash_dq_kernel  (launched by _bwd_call)
//   flash_dkv_kernel   <- _flash_dkv_kernel (launched by _bwd_call)
// Each kernel also has a wgmma/TMA body (flash_attention_sm90.cu) for
// bfloat16 with head dim 32, 64, 128 or 256, and the forward one for
// bfloat16 at every multiple of 128 above 256; dispatch() picks it by
// (kernel, dtype, D) alone (uses_wgmma_body in flash_params.cuh).  The
// bodies here serve float32 inputs at head dims 32 to 256 and (the wide
// bodies) every multiple of 128 above 256: the forward in float32, dQ and
// dK/dV in either dtype.
//
// What they compute is what the TPU kernels compute: native-dtype inputs
// (float32 or bfloat16) with float32 accumulation; sm_scale applied to the
// float32 scores; masked scores set to the finite -1e30; the softmax
// denominator l summed from the unrounded float32 P, with only the P.V
// operand rounded to V's dtype; dS rounded to K's / Q's dtype before its
// product; causal and sliding-window masks as in _masked_scores; fully
// dead tiles skipped as loop bounds (_causal_live).
//
// What changed for this card:
//   * No 128-lane head-dim padding and no lane-replicated lse: lse and the
//     lse cotangent dadj are (B, H, T) float32, head dims are 32, 64, 128,
//     256 and, on the wide bodies, any multiple of 128 above 256.
//   * Q, K and V are read in place from the (B, T, H, D) layout through
//     their strides (the transformer hands over strided views of its fused
//     QKV projection), so no transpose or copy precedes a launch.  O, dO,
//     dQ, dK and dV are contiguous (B, T, H, D).
//   * A ragged T is masked instead of required to divide the tiles.
//   * The TPU's sequential grid axis is a loop inside the block.  The dQ
//     kernel keeps one block per Q tile and the dK/dV kernel one block per
//     K/V tile, so no block writes another's output: no atomics, and the
//     results are the same bits run to run.
//
// Bound on this card: at the slice's shapes (T = 4096, D = 128, causal)
// each kernel does ~1,000 flops per byte it must move (chip_smoke.py
// prints both counts), far above the ~295 where HBM (3.35 TB/s) stops
// being the limit, so the tensor cores (989 TFLOP/s bf16) bound it.  These
// bodies are the simple correct design: BQ x BK tiles (64 x 64; 32 x 32 at
// D 256, tile_rows) staged through shared memory as float32, each of 256
// threads accumulating a (BQ/16) x (BK/16) score micro-tile and a
// (BQ/16) x (D/16) output micro-tile with CUDA-core FMAs.  bf16
// products are exact in float32, so rounding P and dS to bf16 before the
// FMA reproduces what a bf16 tensor-core product with float32
// accumulation computes, and float32 inputs get full float32 products.
// They run far below the tensor-core bound (PERF.md).
//
// Built by ops/_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        -Xcompiler -fPIC
// and bound through ctypes: each entry point returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "flash_params.cuh"

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernels

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round a float32 value to T's precision and back (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ float reduce16_max(float x) {
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float reduce16_sum(float x) {
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool keep(const FlashParams& p, int row, int col) {
  bool ok = row < p.T && col < p.T;  // the ragged edge of both tiles
  if (p.causal) {
    ok = ok && col <= row;
    if (p.window > 0) ok = ok && col >= row - (p.window - 1);
  }
  return ok;
}

// Stage rows [r0, r0 + rows) of a (T, D) slice with row stride `st` into
// shared memory as float32 with row pitch `pitch`; rows past T are zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int pitch, const T* src, int64_t st,
                                          int r0, int rows, int t_max) {
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int t = r0 + r;
    dst[r * pitch + c] = t < t_max ? to_f(src[(int64_t)t * st + c]) : 0.f;
  }
}

// delta_r = sum_d dO[r, d] * O[r, d] for the BQ rows of one Q tile,
// kThreads / BQ threads per row; dO comes from shared memory, O from
// device memory.
template <typename T, int D, int BQ>
__device__ __forceinline__ void row_delta(float* delta, const float* dos, int pitch,
                                          const T* o, int64_t st, int q0, int t_max) {
  constexpr int kParts = kThreads / BQ;
  static_assert(kParts <= 32 && (kParts & (kParts - 1)) == 0, "a row's threads share a warp");
  const int r = threadIdx.x / kParts, part = threadIdx.x % kParts;
  const int t = q0 + r;
  float acc = 0.f;
  if (t < t_max) {
    for (int c = part; c < D; c += kParts) acc += dos[r * pitch + c] * to_f(o[(int64_t)t * st + c]);
  }
#pragma unroll
  for (int off = kParts / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (part == 0) delta[r] = acc;
}

// Key-tile range [lo, hi) (tiles of BK rows) that a Q tile of BQ rows
// starting at q0 must visit.
template <int BQ, int BK>
__device__ __forceinline__ void key_tiles(const FlashParams& p, int q0, int* lo, int* hi) {
  int k_lo = 0, k_hi = p.T;
  if (p.causal) {
    k_hi = min(p.T, q0 + BQ);
    if (p.window > 0) k_lo = max(0, q0 - (p.window - 1));
  }
  *lo = k_lo / BK;
  *hi = (k_hi + BK - 1) / BK;
}

// ---------------------------------------------------------------------------
// A. Forward: O = softmax(scale * Q K^T + mask) V, optionally lse.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x QP
  float* Ks = Qs + BQ * QP;    // BK x KP
  float* Vs = Ks + BK * KP;    // BK x D
  float* Ps = Vs + BK * D;     // BQ x PP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t o_st = (int64_t)p.H * D;
  T* o = static_cast<T*>(p.o) + (int64_t)b * p.T * o_st + (int64_t)h * D;

  load_tile<T, D>(Qs, QP, q, p.q_st, q0, BQ, p.T);

  float m[RI], l[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles<BQ, BK>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, KP, k, p.k_st, k0, BK, p.T);
    load_tile<T, D>(Vs, D, v, p.v_st, k0, BK, p.T);
    __syncthreads();

    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[RI], kv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < RJ; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float x = s[i][j] * p.scale;
        s[i][j] = keep(p, row, k0 + tx + 16 * j) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = reduce16_max(mx);
      const float m_next = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float pij = expf(s[i][j] - m_next);
        sum += pij;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(pij);
      }
      l[i] = l[i] * corr + reduce16_sum(sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RI], vv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
    const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[(int64_t)row * o_st + tx + 16 * c] = from_f<T>(acc[i][c] / ls);
    if (p.lse != nullptr && tx == 0) p.lse[(int64_t)bh * p.T + row] = m[i] + logf(ls);
  }
}

// ---------------------------------------------------------------------------
// B. dQ = scale * sum_k dS K, dS = P * (dO V^T - rowsum(dO * O) + dadj).
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashParams p) {
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x QP
  float* dOs = Qs + BQ * QP;    // BQ x QP
  float* Ks = dOs + BQ * QP;    // BK x KP
  float* Vs = Ks + BK * KP;     // BK x KP
  float* dSs = Vs + BK * KP;    // BQ x PP
  float* delta = dSs + BQ * PP;  // BQ
  float* lse_s = delta + BQ;     // BQ
  float* adj_s = lse_s + BQ;     // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t c_st = (int64_t)p.H * D;  // row stride of the contiguous tensors
  const int64_t c_off = (int64_t)b * p.T * c_st + (int64_t)h * D;
  const T* o = static_cast<const T*>(p.o) + c_off;
  const T* dout = static_cast<const T*>(p.dout) + c_off;
  T* dq = static_cast<T*>(p.dq) + c_off;

  load_tile<T, D>(Qs, QP, q, p.q_st, q0, BQ, p.T);
  load_tile<T, D>(dOs, QP, dout, c_st, q0, BQ, p.T);
  if (threadIdx.x < BQ) {
    const int t = q0 + threadIdx.x;
    const bool in = t < p.T;
    lse_s[threadIdx.x] = in ? p.lse[(int64_t)bh * p.T + t] : 0.f;
    adj_s[threadIdx.x] = (in && p.dadj != nullptr) ? p.dadj[(int64_t)bh * p.T + t] : 0.f;
  }
  __syncthreads();
  row_delta<T, D, BQ>(delta, dOs, QP, o, c_st, q0, p.T);
  __syncthreads();

  float rl[RI], rd[RI], acc[RI][DC];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    rl[i] = lse_s[ty + 16 * i];
    rd[i] = adj_s[ty + 16 * i] - delta[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles<BQ, BK>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(Ks, KP, k, p.k_st, k0, BK, p.T);
    load_tile<T, D>(Vs, KP, v, p.v_st, k0, BK, p.T);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RI], gv[RI], kv[RJ], vv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * QP + d];
        gv[i] = dOs[(ty + 16 * i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KP + d];
        vv[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float x = keep(p, row, k0 + tx + 16 * j) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl[i]);
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] + rd[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float sv[RI], kv[DC];
#pragma unroll
      for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * PP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * KP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c)
      dq[(int64_t)row * c_st + tx + 16 * c] = from_f<T>(p.scale * acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// C. dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, same recompute as B.
// ---------------------------------------------------------------------------
template <typename T, int D, int BQ, int BK>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashParams p) {
  // Scores: RI query rows by RJ key columns a thread; accumulators: RJ key rows.
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Ks = smem;             // BK x KP
  float* Vs = Ks + BK * KP;     // BK x KP
  float* Qs = Vs + BK * KP;     // BQ x QP
  float* dOs = Qs + BQ * QP;    // BQ x QP
  float* Ps = dOs + BQ * QP;    // BQ x PP
  float* dSs = Ps + BQ * PP;    // BQ x PP
  float* delta = dSs + BQ * PP;  // BQ
  float* lse_s = delta + BQ;     // BQ
  float* adj_s = lse_s + BQ;     // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = (int)blockIdx.x * BK;  // early keys see the most queries
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t c_st = (int64_t)p.H * D;
  const int64_t c_off = (int64_t)b * p.T * c_st + (int64_t)h * D;
  const T* o = static_cast<const T*>(p.o) + c_off;
  const T* dout = static_cast<const T*>(p.dout) + c_off;
  T* dk = static_cast<T*>(p.dk) + c_off;
  T* dv = static_cast<T*>(p.dv) + c_off;

  load_tile<T, D>(Ks, KP, k, p.k_st, k0, BK, p.T);
  load_tile<T, D>(Vs, KP, v, p.v_st, k0, BK, p.T);

  float dk_acc[RJ][DC], dv_acc[RJ][DC];
#pragma unroll
  for (int i = 0; i < RJ; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query rows that can see a key of this tile.
  int q_lo = 0, q_hi = p.T;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.T, k0 + BK - 1 + p.window);
  }
  const int qt_lo = q_lo / BQ, qt_hi = (q_hi + BQ - 1) / BQ;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D>(Qs, QP, q, p.q_st, q0, BQ, p.T);
    load_tile<T, D>(dOs, QP, dout, c_st, q0, BQ, p.T);
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      const bool in = t < p.T;
      lse_s[threadIdx.x] = in ? p.lse[(int64_t)bh * p.T + t] : 0.f;
      adj_s[threadIdx.x] = (in && p.dadj != nullptr) ? p.dadj[(int64_t)bh * p.T + t] : 0.f;
    }
    __syncthreads();
    row_delta<T, D, BQ>(delta, dOs, QP, o, c_st, q0, p.T);
    __syncthreads();

    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[RI], gv[RI], kv[RJ], vv[RJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        qv[i] = Qs[(ty + 16 * i) * QP + d];
        gv[i] = dOs[(ty + 16 * i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KP + d];
        vv[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < RI; ++i)
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const float rl = lse_s[r], rd = adj_s[r] - delta[r];
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int cidx = tx + 16 * j;
        const float x = keep(p, row, k0 + cidx) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl);
        Ps[r * PP + cidx] = round_to<T>(pij);
        dSs[r * PP + cidx] = round_to<T>(pij * (dp[i][j] + rd));
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < BQ; ++qq) {
      float pv[RJ], sv[RJ], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < RJ; ++i) {
        pv[i] = Ps[qq * PP + ty + 16 * i];
        sv[i] = dSs[qq * PP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gv[c] = dOs[qq * QP + tx + 16 * c];
        qv[c] = Qs[qq * QP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < RJ; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pv[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RJ; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[(int64_t)row * c_st + tx + 16 * c] = from_f<T>(p.scale * dk_acc[i][c]);
      dv[(int64_t)row * c_st + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// The wide bodies: head dims above 256, any multiple of 128 (kWideChunk).
//
// No D-sized row block lives in shared memory, so no D is too large for
// them: each product over the head dim (Q.K^T, dO.V^T) is built up 128
// columns at a time, and each product into the head dim (P.V, dS.K,
// dS^T.Q, P^T.dO) is written 128 columns at a time.  Between key (or
// query) tiles the running O, dQ or dK/dV rows of a block live in a
// float32 scratch in device memory (FlashParams::acc / acc2, (B, H, T, D),
// allocated by the wrapper): a block reads and rewrites only its own rows
// (each thread its own elements), so no atomics, and the last tile
// writes the output in its dtype instead.  The arithmetic, and its order
// per element, is that of the bodies above: the running sums pass through
// float32 memory unchanged.  The backward reads the pre-pass's row term.
// Bound on this card: the same flops as the bodies above plus the
// scratch traffic (8 bytes a row element per tile); a simple, correct
// design on CUDA cores (PERF.md has its times).  The forward is built for
// float32 only: bfloat16 runs flash_fwd_wide_kernel_sm90.
// ---------------------------------------------------------------------------
constexpr int kWideChunk = 128;  // head-dim columns staged at once
constexpr int kWideRows = 32;    // BQ = BK

// Stage rows [r0, r0 + rows) x columns [c0, c0 + kWideChunk) of a (T, D)
// slice with row stride `st` into shared memory as float32 (row pitch
// `pitch`); rows past T are zero.
template <typename T>
__device__ __forceinline__ void load_chunk(float* dst, int pitch, const T* src, int64_t st,
                                           int r0, int c0, int rows, int t_max) {
  for (int i = threadIdx.x; i < rows * kWideChunk; i += kThreads) {
    const int r = i / kWideChunk, c = i % kWideChunk;
    const int t = r0 + r;
    dst[r * pitch + c] = t < t_max ? to_f(src[(int64_t)t * st + c0 + c]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(FlashParams p) {
  constexpr int BQ = kWideRows, BK = kWideRows, C = kWideChunk;
  constexpr int QP = C + 4, KP = C + 1, CC = C / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;            // BQ x QP: a Q chunk
  float* KVs = Qs + BQ * QP;   // BK x KP: a K chunk, then a V chunk
  float* Ps = KVs + BK * KP;   // BQ x PP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t o_st = (int64_t)p.H * D;
  T* o = static_cast<T*>(p.o) + (int64_t)b * p.T * o_st + (int64_t)h * D;
  float* acc = p.acc + (int64_t)bh * p.T * D;

  float m[RI], l[RI], corr[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles<BQ, BK>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    float s[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();  // the previous chunk's readers are done
      load_chunk<T>(Qs, QP, q, p.q_st, q0, c0, BQ, p.T);
      load_chunk<T>(KVs, KP, k, p.k_st, k0, c0, BK, p.T);
      __syncthreads();
#pragma unroll 4
      for (int d = 0; d < C; ++d) {
        float qv[RI], kv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
        for (int j = 0; j < RJ; ++j) kv[j] = KVs[(tx + 16 * j) * KP + d];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float x = s[i][j] * p.scale;
        s[i][j] = keep(p, row, k0 + tx + 16 * j) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = reduce16_max(mx);
      const float m_next = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float pij = expf(s[i][j] - m_next);
        sum += pij;
        Ps[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(pij);
      }
      l[i] = l[i] * corr[i] + reduce16_sum(sum);
      m[i] = m_next;
    }

    const bool first = kt == kt_lo, last = kt == kt_hi - 1;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();  // P written; the K chunk's readers are done
      load_chunk<T>(KVs, KP, v, p.v_st, k0, c0, BK, p.T);
      __syncthreads();
      float a[RI][CC];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          a[i][c] = (first || row >= p.T) ? 0.f
                                          : acc[(int64_t)row * D + c0 + tx + 16 * c] * corr[i];
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float pv[RI], vv[CC];
#pragma unroll
        for (int i = 0; i < RI; ++i) pv[i] = Ps[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < CC; ++c) vv[c] = KVs[kk * KP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < CC; ++c) a[i][c] = fmaf(pv[i], vv[c], a[i][c]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= p.T) continue;
        const float ls = fmaxf(l[i], 1e-30f);
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int col = c0 + tx + 16 * c;
          if (last) {
            o[(int64_t)row * o_st + col] = from_f<T>(a[i][c] / ls);
          } else {
            acc[(int64_t)row * D + col] = a[i][c];
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.T) continue;
    if (p.lse != nullptr && tx == 0)
      p.lse[(int64_t)bh * p.T + row] = m[i] + logf(fmaxf(l[i], 1e-30f));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_wide_kernel(FlashParams p) {
  constexpr int BQ = kWideRows, BK = kWideRows, C = kWideChunk;
  constexpr int QP = C + 4, KP = C + 1, CC = C / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Qs = smem;             // BQ x QP
  float* dOs = Qs + BQ * QP;    // BQ x QP
  float* Ks = dOs + BQ * QP;    // BK x KP
  float* Vs = Ks + BK * KP;     // BK x KP
  float* dSs = Vs + BK * KP;    // BQ x PP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D;
  const int n_qt = (p.T + BQ - 1) / BQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * BQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t c_st = (int64_t)p.H * D;
  const int64_t c_off = (int64_t)b * p.T * c_st + (int64_t)h * D;
  const T* dout = static_cast<const T*>(p.dout) + c_off;
  T* dq = static_cast<T*>(p.dq) + c_off;
  float* acc = p.acc + (int64_t)bh * p.T * D;

  float rl[RI], rd[RI];
#pragma unroll
  for (int i = 0; i < RI; ++i) {
    const int row = q0 + ty + 16 * i;
    rl[i] = row < p.T ? p.lse[(int64_t)bh * p.T + row] : 0.f;
    rd[i] = row < p.T ? p.rowterm[(int64_t)bh * p.T + row] : 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles<BQ, BK>(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * BK;
    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();
      load_chunk<T>(Qs, QP, q, p.q_st, q0, c0, BQ, p.T);
      load_chunk<T>(dOs, QP, dout, c_st, q0, c0, BQ, p.T);
      load_chunk<T>(Ks, KP, k, p.k_st, k0, c0, BK, p.T);
      load_chunk<T>(Vs, KP, v, p.v_st, k0, c0, BK, p.T);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < C; ++d) {
        float qv[RI], gv[RI], kv[RJ], vv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = Qs[(ty + 16 * i) * QP + d];
          gv[i] = dOs[(ty + 16 * i) * QP + d];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          kv[j] = Ks[(tx + 16 * j) * KP + d];
          vv[j] = Vs[(tx + 16 * j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const float x = keep(p, row, k0 + tx + 16 * j) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl[i]);
        dSs[(ty + 16 * i) * PP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] + rd[i]));
      }
    }

    const bool first = kt == kt_lo, last = kt == kt_hi - 1;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();  // dS written; the previous chunk's readers are done
      load_chunk<T>(Ks, KP, k, p.k_st, k0, c0, BK, p.T);
      __syncthreads();
      float a[RI][CC];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CC; ++c)
          a[i][c] = (first || row >= p.T) ? 0.f : acc[(int64_t)row * D + c0 + tx + 16 * c];
      }
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        float sv[RI], kv[CC];
#pragma unroll
        for (int i = 0; i < RI; ++i) sv[i] = dSs[(ty + 16 * i) * PP + kk];
#pragma unroll
        for (int c = 0; c < CC; ++c) kv[c] = Ks[kk * KP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int c = 0; c < CC; ++c) a[i][c] = fmaf(sv[i], kv[c], a[i][c]);
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= p.T) continue;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int col = c0 + tx + 16 * c;
          if (last) {
            dq[(int64_t)row * c_st + col] = from_f<T>(p.scale * a[i][c]);
          } else {
            acc[(int64_t)row * D + col] = a[i][c];
          }
        }
      }
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_wide_kernel(FlashParams p) {
  constexpr int BQ = kWideRows, BK = kWideRows, C = kWideChunk;
  constexpr int QP = C + 4, KP = C + 1, CC = C / 16, RI = BQ / 16, RJ = BK / 16, PP = BK + 4;
  extern __shared__ float smem[];
  float* Ks = smem;              // BK x KP
  float* Vs = Ks + BK * KP;      // BK x KP
  float* Qs = Vs + BK * KP;      // BQ x QP
  float* dOs = Qs + BQ * QP;     // BQ x QP
  float* Ps = dOs + BQ * QP;     // BQ x PP
  float* dSs = Ps + BQ * PP;     // BQ x PP
  float* lse_s = dSs + BQ * PP;  // BQ
  float* rt_s = lse_s + BQ;      // BQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int D = p.D;
  const int k0 = (int)blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t c_st = (int64_t)p.H * D;
  const int64_t c_off = (int64_t)b * p.T * c_st + (int64_t)h * D;
  const T* dout = static_cast<const T*>(p.dout) + c_off;
  T* dk = static_cast<T*>(p.dk) + c_off;
  T* dv = static_cast<T*>(p.dv) + c_off;
  float* acc_k = p.acc + (int64_t)bh * p.T * D;
  float* acc_v = p.acc2 + (int64_t)bh * p.T * D;

  int q_lo = 0, q_hi = p.T;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.T, k0 + BK - 1 + p.window);
  }
  const int qt_lo = q_lo / BQ, qt_hi = (q_hi + BQ - 1) / BQ;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();  // the previous tile's row vectors are read
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      const bool in = t < p.T;
      lse_s[threadIdx.x] = in ? p.lse[(int64_t)bh * p.T + t] : 0.f;
      rt_s[threadIdx.x] = in ? p.rowterm[(int64_t)bh * p.T + t] : 0.f;
    }
    float s[RI][RJ], dp[RI][RJ];
#pragma unroll
    for (int i = 0; i < RI; ++i)
#pragma unroll
      for (int j = 0; j < RJ; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();
      load_chunk<T>(Ks, KP, k, p.k_st, k0, c0, BK, p.T);
      load_chunk<T>(Vs, KP, v, p.v_st, k0, c0, BK, p.T);
      load_chunk<T>(Qs, QP, q, p.q_st, q0, c0, BQ, p.T);
      load_chunk<T>(dOs, QP, dout, c_st, q0, c0, BQ, p.T);
      __syncthreads();
#pragma unroll 2
      for (int d = 0; d < C; ++d) {
        float qv[RI], gv[RI], kv[RJ], vv[RJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          qv[i] = Qs[(ty + 16 * i) * QP + d];
          gv[i] = dOs[(ty + 16 * i) * QP + d];
        }
#pragma unroll
        for (int j = 0; j < RJ; ++j) {
          kv[j] = Ks[(tx + 16 * j) * KP + d];
          vv[j] = Vs[(tx + 16 * j) * KP + d];
        }
#pragma unroll
        for (int i = 0; i < RI; ++i)
#pragma unroll
          for (int j = 0; j < RJ; ++j) {
            s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
            dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < RI; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const float rl = lse_s[r], rd = rt_s[r];
#pragma unroll
      for (int j = 0; j < RJ; ++j) {
        const int cidx = tx + 16 * j;
        const float x = keep(p, row, k0 + cidx) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl);
        Ps[r * PP + cidx] = round_to<T>(pij);
        dSs[r * PP + cidx] = round_to<T>(pij * (dp[i][j] + rd));
      }
    }

    const bool first = qt == qt_lo, last = qt == qt_hi - 1;
    for (int c0 = 0; c0 < D; c0 += C) {
      __syncthreads();  // P and dS written; the previous chunk's readers are done
      load_chunk<T>(Qs, QP, q, p.q_st, q0, c0, BQ, p.T);
      load_chunk<T>(dOs, QP, dout, c_st, q0, c0, BQ, p.T);
      __syncthreads();
      float ak[RJ][CC], av[RJ][CC];
#pragma unroll
      for (int i = 0; i < RJ; ++i) {
        const int row = k0 + ty + 16 * i;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int64_t e = (int64_t)row * D + c0 + tx + 16 * c;
          const bool zero = first || row >= p.T;
          ak[i][c] = zero ? 0.f : acc_k[e];
          av[i][c] = zero ? 0.f : acc_v[e];
        }
      }
#pragma unroll 2
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[RJ], sv[RJ], gv[CC], qv[CC];
#pragma unroll
        for (int i = 0; i < RJ; ++i) {
          pv[i] = Ps[qq * PP + ty + 16 * i];
          sv[i] = dSs[qq * PP + ty + 16 * i];
        }
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          gv[c] = dOs[qq * QP + tx + 16 * c];
          qv[c] = Qs[qq * QP + tx + 16 * c];
        }
#pragma unroll
        for (int i = 0; i < RJ; ++i)
#pragma unroll
          for (int c = 0; c < CC; ++c) {
            av[i][c] = fmaf(pv[i], gv[c], av[i][c]);
            ak[i][c] = fmaf(sv[i], qv[c], ak[i][c]);
          }
      }
#pragma unroll
      for (int i = 0; i < RJ; ++i) {
        const int row = k0 + ty + 16 * i;
        if (row >= p.T) continue;
#pragma unroll
        for (int c = 0; c < CC; ++c) {
          const int col = c0 + tx + 16 * c;
          if (last) {
            dk[(int64_t)row * c_st + col] = from_f<T>(p.scale * ak[i][c]);
            dv[(int64_t)row * c_st + col] = from_f<T>(av[i][c]);
          } else {
            const int64_t e = (int64_t)row * D + col;
            acc_k[e] = ak[i][c];
            acc_v[e] = av[i][c];
          }
        }
      }
    }
  }
}

constexpr size_t kWideFwdSmem =
    sizeof(float) * (kWideRows * (kWideChunk + 4) + kWideRows * (kWideChunk + 1) +
                     kWideRows * (kWideRows + 4));
constexpr size_t kWideDqSmem =
    sizeof(float) * (2 * kWideRows * (kWideChunk + 4) + 2 * kWideRows * (kWideChunk + 1) +
                     kWideRows * (kWideRows + 4));
constexpr size_t kWideDkvSmem =
    sizeof(float) * (2 * kWideRows * (kWideChunk + 1) + 2 * kWideRows * (kWideChunk + 4) +
                     2 * kWideRows * (kWideRows + 4) + 2 * kWideRows);

// Rows of the Q and K/V tiles for head dim D.  64-row tiles staged as
// float32 need 283-300 KB of shared memory for dQ and dK/dV at D 256, above
// the 227 KB a block may opt into, so D 256 runs 32-row tiles (103-142 KB).
template <int D> constexpr int tile_rows() { return D > 128 ? 32 : 64; }

template <int D, int BQ, int BK> constexpr size_t fwd_smem() {
  return sizeof(float) * (BQ * (D + 4) + BK * (D + 1) + BK * D + BQ * (BK + 4));
}
template <int D, int BQ, int BK> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * BQ * (D + 4) + 2 * BK * (D + 1) + BQ * (BK + 4) + 3 * BQ);
}
template <int D, int BQ, int BK> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * BK * (D + 1) + 2 * BQ * (D + 4) + 2 * BQ * (BK + 4) + 3 * BQ);
}
static_assert(dkv_smem<256, tile_rows<256>(), tile_rows<256>()>() <= 227 * 1024,
              "the D-256 tiles fit the opt-in shared memory");

template <typename Kernel>
cudaError_t launch(Kernel kernel, size_t smem, int n_tiles, const FlashParams& p,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  dim3 grid(n_tiles, p.B * p.H);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// Head dims above 256 run the wide bodies: any multiple of their chunk.
bool wide(int D) { return D > 256 && D % kWideChunk == 0; }

bool valid(const FlashParams* p) {
  return p != nullptr && p->B > 0 && p->H > 0 && p->T > 0 && p->B * p->H <= 65535 &&
         (p->D == 32 || p->D == 64 || p->D == 128 || p->D == 256 || wide(p->D)) &&
         (p->dtype == 0 || p->dtype == 1);
}

template <typename T>
cudaError_t run_wide(int which, const FlashParams& p, cudaStream_t stream) {
  // The scratch, and the backward's row term from the pre-pass.
  if (p.acc == nullptr || (which == 2 && p.acc2 == nullptr) ||
      (which != 0 && (p.rowterm == nullptr || p.lse == nullptr)))
    return cudaErrorInvalidValue;
  const int tiles = (p.T + kWideRows - 1) / kWideRows;
  switch (which) {
    case 0:
      // bf16 runs the wgmma forward above 256, so this one is not built for it.
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        return cudaErrorInvalidValue;
      } else {
        return launch(flash_fwd_wide_kernel<T>, kWideFwdSmem, tiles, p, stream);
      }
    case 1: return launch(flash_dq_wide_kernel<T>, kWideDqSmem, tiles, p, stream);
    default: return launch(flash_dkv_wide_kernel<T>, kWideDkvSmem, tiles, p, stream);
  }
}

template <typename T, int D>
cudaError_t run(int which, const FlashParams& p, cudaStream_t stream) {
  constexpr int BQ = tile_rows<D>(), BK = tile_rows<D>();
  const int q_tiles = (p.T + BQ - 1) / BQ, k_tiles = (p.T + BK - 1) / BK;
  // bf16 at these head dims runs the wgmma bodies, so these are not built
  // for it.
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    return cudaErrorInvalidValue;
  } else {
    if (which == 0)
      return launch(flash_fwd_kernel<T, D, BQ, BK>, fwd_smem<D, BQ, BK>(), q_tiles, p, stream);
    if (which == 1)
      return launch(flash_dq_kernel<T, D, BQ, BK>, dq_smem<D, BQ, BK>(), q_tiles, p, stream);
    return launch(flash_dkv_kernel<T, D, BQ, BK>, dkv_smem<D, BQ, BK>(), k_tiles, p, stream);
  }
}

template <typename T>
cudaError_t dispatch_d(int which, const FlashParams& p, cudaStream_t stream) {
  if (wide(p.D)) return run_wide<T>(which, p, stream);
  switch (p.D) {
    case 32: return run<T, 32>(which, p, stream);
    case 64: return run<T, 64>(which, p, stream);
    case 128: return run<T, 128>(which, p, stream);
    default: return run<T, 256>(which, p, stream);
  }
}

int dispatch(int which, const FlashParams* p, void* stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (uses_wgmma_body(which, p->dtype, p->D)) {
    err = which == 0   ? flash_fwd_sm90(*p, s)
          : which == 1 ? flash_dq_sm90(*p, s)
                       : flash_dkv_sm90(*p, s);
  } else {
    err = p->dtype == 0 ? dispatch_d<float>(which, *p, s) : dispatch_d<__nv_bfloat16>(which, *p, s);
  }
  return static_cast<int>(err);
}

}  // namespace

extern "C" {

// Each entry point launches one kernel on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
int dlt_flash_fwd(const FlashParams* p, void* stream) { return dispatch(0, p, stream); }
int dlt_flash_bwd_dq(const FlashParams* p, void* stream) { return dispatch(1, p, stream); }
int dlt_flash_bwd_dkv(const FlashParams* p, void* stream) { return dispatch(2, p, stream); }
int dlt_flash_bwd_rowterm(const FlashParams* p, void* stream) {
  if (!valid(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(flash_rowterm(*p, static_cast<cudaStream_t>(stream)));
}
// 1 if dispatch(which, ...) takes the wgmma/TMA body for this dtype and head dim.
int dlt_flash_uses_wgmma(int which, int dtype, int D) { return uses_wgmma_body(which, dtype, D); }
// Dynamic shared memory a wgmma body launches with (which 0, 1 or 2; D 32,
// 64, 128 or 256, and the forward above 256); -1 where there is no such body.
int dlt_flash_wgmma_smem_bytes(int which, int D) { return flash_sm90_smem_bytes(which, D); }
int dlt_flash_struct_size() { return static_cast<int>(sizeof(FlashParams)); }

}  // extern "C"
