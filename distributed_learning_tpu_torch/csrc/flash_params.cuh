// Launch parameters shared by the two kernel sources, and the Hopper
// entry points that flash_attention.cu's dispatcher calls.
//
// FlashParams is mirrored field for field by FlashParams in ops/_build.py.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

struct FlashParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;            // forward: written; backward: read
  float* lse;         // (B, H, T); forward writes it when non-null
  const void* dout;   // dO, contiguous (B, T, H, D)
  const float* dadj;  // (B, H, T) lse cotangent, or null
  float* rowterm;     // (B, H, T) dadj - rowsum(dO * O): the pre-pass writes it, wgmma dQ and dK/dV read it
  void* dq;
  void* dk;
  void* dv;
  float* acc;   // the wide bodies' float32 (B, H, T, D) scratch: O (forward), dQ or dK
  float* acc2;  // ... and dV (dK/dV); null for every other body
  int64_t q_sb, q_st, q_sh;  // element strides of q over (B, T, H); D is unit
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int32_t B, H, T, D;
  float scale;
  int32_t causal;
  int32_t window;  // <= 0: no window
  int32_t dtype;   // 0: float32, 1: bfloat16
};

// The kernel that dispatch(which, ...) launches: which 0 forward, 1 dQ,
// 2 dK/dV.  The wgmma/TMA bodies take bfloat16 with head dim 32, 64, 128
// or 256, all three kernels; wgmma has no float32-exact product, so
// float32 inputs stay on the CUDA-core bodies.
// ops/flash_attention.py's wgmma_body() mirrors it.
inline bool uses_wgmma_body(int which, int dtype, int D) {
  return (which >= 0 && which <= 2) && dtype == 1 &&
         (D == 32 || D == 64 || D == 128 || D == 256);
}

// Defined in flash_attention_sm90.cu; each returns cudaGetLastError().
cudaError_t flash_fwd_sm90(const FlashParams& p, cudaStream_t stream);
cudaError_t flash_dq_sm90(const FlashParams& p, cudaStream_t stream);
cudaError_t flash_dkv_sm90(const FlashParams& p, cudaStream_t stream);
// The backward's pre-pass: rowterm = dadj - rowsum(dO * O), any dtype, head
// dims 32, 64, 128 and any multiple of 128.
cudaError_t flash_rowterm(const FlashParams& p, cudaStream_t stream);
// Dynamic shared memory of the wgmma forward (which 0), dQ (1) or dK/dV (2)
// body at head dim D (32, 64, 128 or 256); -1 where there is no such body.
int flash_sm90_smem_bytes(int which, int D);
