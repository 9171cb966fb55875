// Flash attention for Hopper (sm_90a): the CUDA-core bodies of the
// forward, dQ and dK/dV kernels, and the dispatcher over all bodies.
//
// Port of the three Pallas TPU kernels in
// distributed_learning_tpu/ops/flash_attention.py:
//   flash_fwd_kernel   <- _flash_kernel     (launched by _fwd_call)
//   flash_dq_kernel    <- _flash_dq_kernel  (launched by _bwd_call)
//   flash_dkv_kernel   <- _flash_dkv_kernel (launched by _bwd_call)
// Each kernel also has a wgmma/TMA body (flash_attention_sm90.cu) for
// bfloat16 with head dim 64 or 128; dispatch() picks it by (dtype, D)
// alone (uses_wgmma_body in flash_params.cuh).  The bodies here serve
// float32 inputs and head dim 32.
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
//     lse cotangent dadj are (B, H, T) float32, head dims are 32, 64, 128.
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
// bodies are the simple correct design: 64 x 64 tiles staged through
// shared memory as float32, each of 256 threads accumulating a 4 x 4 score
// micro-tile and a 4 x (D/16) output micro-tile with CUDA-core FMAs.  bf16
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

constexpr int kBQ = 64;        // query rows per tile
constexpr int kBK = 64;        // key rows per tile
constexpr int kThreads = 256;  // 16 x 16 thread grid
constexpr int kPP = kBK + 4;   // padded row of the P / dS tiles
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

// delta_r = sum_d dO[r, d] * O[r, d] for the kBQ rows of one Q tile, four
// threads per row; dO comes from shared memory, O from device memory.
template <typename T, int D>
__device__ __forceinline__ void row_delta(float* delta, const float* dos, int pitch,
                                          const T* o, int64_t st, int q0, int t_max) {
  const int r = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int t = q0 + r;
  float acc = 0.f;
  if (t < t_max) {
    for (int c = part; c < D; c += 4) acc += dos[r * pitch + c] * to_f(o[(int64_t)t * st + c]);
  }
  acc += __shfl_xor_sync(0xffffffffu, acc, 1);
  acc += __shfl_xor_sync(0xffffffffu, acc, 2);
  if (part == 0) delta[r] = acc;
}

// Key-tile range [lo, hi) that a Q tile starting at q0 must visit.
__device__ __forceinline__ void key_tiles(const FlashParams& p, int q0, int* lo, int* hi) {
  int k_lo = 0, k_hi = p.T;
  if (p.causal) {
    k_hi = min(p.T, q0 + kBQ);
    if (p.window > 0) k_lo = max(0, q0 - (p.window - 1));
  }
  *lo = k_lo / kBK;
  *hi = (k_hi + kBK - 1) / kBK;
}

// ---------------------------------------------------------------------------
// A. Forward: O = softmax(scale * Q K^T + mask) V, optionally lse.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(FlashParams p) {
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;             // kBQ x QP
  float* Ks = Qs + kBQ * QP;    // kBK x KP
  float* Vs = Ks + kBK * KP;    // kBK x D
  float* Ps = Vs + kBK * D;     // kBQ x kPP

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t o_st = (int64_t)p.H * D;
  T* o = static_cast<T*>(p.o) + (int64_t)b * p.T * o_st + (int64_t)h * D;

  load_tile<T, D>(Qs, QP, q, p.q_st, q0, kBQ, p.T);

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, KP, k, p.k_st, k0, kBK, p.T);
    load_tile<T, D>(Vs, D, v, p.v_st, k0, kBK, p.T);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty + 16 * i) * QP + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * KP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = s[i][j] * p.scale;
        s[i][j] = keep(p, row, k0 + tx + 16 * j) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = reduce16_max(mx);
      const float m_next = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_next);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pij = expf(s[i][j] - m_next);
        sum += pij;
        Ps[(ty + 16 * i) * kPP + tx + 16 * j] = round_to<T>(pij);
      }
      l[i] = l[i] * corr + reduce16_sum(sum);
      m[i] = m_next;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(FlashParams p) {
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;               // kBQ x QP
  float* dOs = Qs + kBQ * QP;     // kBQ x QP
  float* Ks = dOs + kBQ * QP;     // kBK x KP
  float* Vs = Ks + kBK * KP;      // kBK x KP
  float* dSs = Vs + kBK * KP;     // kBQ x kPP
  float* delta = dSs + kBQ * kPP;  // kBQ
  float* lse_s = delta + kBQ;      // kBQ
  float* adj_s = lse_s + kBQ;      // kBQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int n_qt = (p.T + kBQ - 1) / kBQ;
  const int q0 = (n_qt - 1 - (int)blockIdx.x) * kBQ;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const int64_t c_st = (int64_t)p.H * D;  // row stride of the contiguous tensors
  const int64_t c_off = (int64_t)b * p.T * c_st + (int64_t)h * D;
  const T* o = static_cast<const T*>(p.o) + c_off;
  const T* dout = static_cast<const T*>(p.dout) + c_off;
  T* dq = static_cast<T*>(p.dq) + c_off;

  load_tile<T, D>(Qs, QP, q, p.q_st, q0, kBQ, p.T);
  load_tile<T, D>(dOs, QP, dout, c_st, q0, kBQ, p.T);
  if (threadIdx.x < kBQ) {
    const int t = q0 + threadIdx.x;
    const bool in = t < p.T;
    lse_s[threadIdx.x] = in ? p.lse[(int64_t)bh * p.T + t] : 0.f;
    adj_s[threadIdx.x] = (in && p.dadj != nullptr) ? p.dadj[(int64_t)bh * p.T + t] : 0.f;
  }
  __syncthreads();
  row_delta<T, D>(delta, dOs, QP, o, c_st, q0, p.T);
  __syncthreads();

  float rl[4], rd[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    rl[i] = lse_s[ty + 16 * i];
    rd[i] = adj_s[ty + 16 * i] - delta[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  int kt_lo, kt_hi;
  key_tiles(p, q0, &kt_lo, &kt_hi);
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();
    load_tile<T, D>(Ks, KP, k, p.k_st, k0, kBK, p.T);
    load_tile<T, D>(Vs, KP, v, p.v_st, k0, kBK, p.T);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * QP + d];
        gv[i] = dOs[(ty + 16 * i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KP + d];
        vv[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = keep(p, row, k0 + tx + 16 * j) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl[i]);
        dSs[(ty + 16 * i) * kPP + tx + 16 * j] = round_to<T>(pij * (dp[i][j] + rd[i]));
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[4], kv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = dSs[(ty + 16 * i) * kPP + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) kv[c] = Ks[kk * KP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(FlashParams p) {
  constexpr int QP = D + 4, KP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;               // kBK x KP
  float* Vs = Ks + kBK * KP;      // kBK x KP
  float* Qs = Vs + kBK * KP;      // kBQ x QP
  float* dOs = Qs + kBQ * QP;     // kBQ x QP
  float* Ps = dOs + kBQ * QP;     // kBQ x kPP
  float* dSs = Ps + kBQ * kPP;    // kBQ x kPP
  float* delta = dSs + kBQ * kPP;  // kBQ
  float* lse_s = delta + kBQ;      // kBQ
  float* adj_s = lse_s + kBQ;      // kBQ

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int k0 = (int)blockIdx.x * kBK;  // early keys see the most queries
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

  load_tile<T, D>(Ks, KP, k, p.k_st, k0, kBK, p.T);
  load_tile<T, D>(Vs, KP, v, p.v_st, k0, kBK, p.T);

  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // Query rows that can see a key of this tile.
  int q_lo = 0, q_hi = p.T;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.T, k0 + kBK - 1 + p.window);
  }
  const int qt_lo = q_lo / kBQ, qt_hi = (q_hi + kBQ - 1) / kBQ;
  for (int qt = qt_lo; qt < qt_hi; ++qt) {
    const int q0 = qt * kBQ;
    __syncthreads();
    load_tile<T, D>(Qs, QP, q, p.q_st, q0, kBQ, p.T);
    load_tile<T, D>(dOs, QP, dout, c_st, q0, kBQ, p.T);
    if (threadIdx.x < kBQ) {
      const int t = q0 + threadIdx.x;
      const bool in = t < p.T;
      lse_s[threadIdx.x] = in ? p.lse[(int64_t)bh * p.T + t] : 0.f;
      adj_s[threadIdx.x] = (in && p.dadj != nullptr) ? p.dadj[(int64_t)bh * p.T + t] : 0.f;
    }
    __syncthreads();
    row_delta<T, D>(delta, dOs, QP, o, c_st, q0, p.T);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty + 16 * i) * QP + d];
        gv[i] = dOs[(ty + 16 * i) * QP + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * KP + d];
        vv[j] = Vs[(tx + 16 * j) * KP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(gv[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, row = q0 + r;
      const float rl = lse_s[r], rd = adj_s[r] - delta[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cidx = tx + 16 * j;
        const float x = keep(p, row, k0 + cidx) ? s[i][j] * p.scale : kNegInf;
        const float pij = expf(x - rl);
        Ps[r * kPP + cidx] = round_to<T>(pij);
        dSs[r * kPP + cidx] = round_to<T>(pij * (dp[i][j] + rd));
      }
    }
    __syncthreads();

#pragma unroll 2
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[4], sv[4], gv[DC], qv[DC];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kPP + ty + 16 * i];
        sv[i] = dSs[qq * kPP + ty + 16 * i];
      }
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        gv[c] = dOs[qq * QP + tx + 16 * c];
        qv[c] = Qs[qq * QP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(pv[i], gv[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sv[i], qv[c], dk_acc[i][c]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.T) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[(int64_t)row * c_st + tx + 16 * c] = from_f<T>(p.scale * dk_acc[i][c]);
      dv[(int64_t)row * c_st + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

template <int D> constexpr size_t fwd_smem() {
  return sizeof(float) * (kBQ * (D + 4) + kBK * (D + 1) + kBK * D + kBQ * kPP);
}
template <int D> constexpr size_t dq_smem() {
  return sizeof(float) * (2 * kBQ * (D + 4) + 2 * kBK * (D + 1) + kBQ * kPP + 3 * kBQ);
}
template <int D> constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * kBK * (D + 1) + 2 * kBQ * (D + 4) + 2 * kBQ * kPP + 3 * kBQ);
}

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

bool valid(const FlashParams* p) {
  return p != nullptr && p->B > 0 && p->H > 0 && p->T > 0 && p->B * p->H <= 65535 &&
         (p->D == 32 || p->D == 64 || p->D == 128) && (p->dtype == 0 || p->dtype == 1);
}

template <typename T, int D>
cudaError_t run(int which, const FlashParams& p, cudaStream_t stream) {
  const int n_tiles = (p.T + kBQ - 1) / kBQ;  // kBQ == kBK
  // bf16 with D 64 or 128 runs the wgmma bodies, so these are not built for it.
  if constexpr (std::is_same<T, __nv_bfloat16>::value && D != 32) {
    return cudaErrorInvalidValue;
  } else {
    switch (which) {
      case 0: return launch(flash_fwd_kernel<T, D>, fwd_smem<D>(), n_tiles, p, stream);
      case 1: return launch(flash_dq_kernel<T, D>, dq_smem<D>(), n_tiles, p, stream);
      default: return launch(flash_dkv_kernel<T, D>, dkv_smem<D>(), n_tiles, p, stream);
    }
  }
}

template <typename T>
cudaError_t dispatch_d(int which, const FlashParams& p, cudaStream_t stream) {
  switch (p.D) {
    case 32: return run<T, 32>(which, p, stream);
    case 64: return run<T, 64>(which, p, stream);
    default: return run<T, 128>(which, p, stream);
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
// Dynamic shared memory a wgmma body launches with (which 0, 1 or 2; D 64 or 128).
int dlt_flash_wgmma_smem_bytes(int which, int D) { return flash_sm90_smem_bytes(which, D); }
int dlt_flash_struct_size() { return static_cast<int>(sizeof(FlashParams)); }

}  // extern "C"
