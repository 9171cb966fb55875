// Flash attention forward (A), dQ (B) and dK/dV (C) for Hopper (sm_90a)
// on the tensor cores, bfloat16 with head dim 32, 64, 128 or 256 (the
// forward also every multiple of 128 above 256), and the backward's
// pre-pass.
//
//   flash_fwd_kernel_sm90        <- _flash_kernel      (launched by _fwd_call)
//   flash_fwd_wide_kernel_sm90      head dims above 256, O's columns split
//   flash_dq_kernel_sm90         <- _flash_dq_kernel   (launched by _bwd_call)
//   flash_dkv_kernel_sm90        <- _flash_dkv_kernel  (launched by _bwd_call),
//   flash_dkv_split_kernel_sm90     head dim 64/128 and 256
//   flash_bwd_rowterm_kernel        pre-pass of both backward kernels:
//                                   rowterm = dadj - rowsum(dO * O), once per row
//   (all in distributed_learning_tpu/ops/flash_attention.py)
//
// They compute what the CUDA-core bodies in flash_attention.cu compute:
// float32 scores scaled after the product, masked scores at the finite
// -1e30, the softmax denominator summed from the unrounded float32 P, only
// the P.V operand and dS rounded to bfloat16, lse in natural log as
// (B, H, T) float32, and keep()'s causal, sliding-window and ragged-T
// masks, with dead tiles skipped as loop bounds.
//
// Bound: at the slice's shapes (T 4096, D 128, causal) all three do
// ~1,000 flops per byte they must move, so the tensor cores (989 TFLOP/s
// bf16) bound them.  The design follows that:
//   * every product is a wgmma (m64nNk16, bf16 in, float32 accumulate);
//     P and dS go from the float32 accumulator to the register A operand
//     of the next product and never touch shared memory;
//   * Q, K, V and dO tiles arrive by TMA (128-byte swizzle; 64-byte at
//     head dim 32) through a 2-stage ring of mbarriers, straight from the
//     (B, T, H, D) views, so the strided views of the fused QKV
//     projection need no copy;
//   * one producer warp issues the loads; two consumer warpgroups of 64
//     rows each run the products, with setmaxnreg moving registers from
//     the producer warpgroup (24) to the consumers (240);
//   * the forward overlaps each tile's softmax with the previous tile's
//     P.V in the same warpgroup, and ping-pongs the two warpgroups so the
//     softmax of one runs under the products of the other; the backward
//     kernels form P while dP's product runs (dQ) or dS^T while dV's
//     product runs (dK/dV), and a warpgroup skips the tiles that none of
//     its rows can see;
//   * both backward kernels read the row term from the pre-pass, so O is
//     read once per backward instead of once per (key tile, Q tile);
//   * masks are applied only on tiles that a mask can touch (the causal
//     diagonal, window edges, the ragged end); other tiles skip them.
// The dQ kernel keeps one block per 128-query tile and the dK/dV kernel
// one per 128-key tile; each block writes only its own rows: no atomics,
// the same bits run to run.
//
// Head dim 256: the D-128 frames do not fit there.  Their shared memory
// would be 320 KB (forward) or 256 KB (dQ), over the 227 KB a block may
// have, and C's consumer would hold 64 x 256 of both dK and dV, 256
// registers a thread.  So the forward and dQ keep their frames with
// 64-key and 32-key tiles (forward 193 KB: the Q tile and two stages of
// K and V; S shrinks to 32 registers beside the 128 of O, and P to 16;
// dQ 192 KB, S and dP 16 registers each beside the 128 of dQ), and dK/dV
// takes a 64-key block whose two consumers hold different outputs
// (flash_dkv_split_kernel_sm90): warpgroup 0 forms P^T and holds dV,
// warpgroup 1 forms dP^T and holds dK, and P^T passes from the first to
// the second through a 16 KB float32 buffer, so dS^T is formed from the
// unrounded P as everywhere else.  All three run O, dQ, dK and dV at
// N = 256.
//
// Head dim 32: a bf16 row is 64 bytes, so the frame's tiles have one
// 64-byte line a row with 64-byte swizzle (line<D>(), col_blocks<D>()).
// The forward keeps D 128's 128-key tiles, ring and ping-pong (Q 8 KB,
// each K and V stage 8 KB, 42,112 bytes in all) with O at N = 32; dQ and
// dK/dV keep their D-128 frames too (dQ with 128-key tiles, dq_bk, 50,240
// bytes; dK/dV with 128-key blocks and 64-query tiles, 34,880 bytes).
// Every MN-major B operand there (V, K, dO, Q) is one 64-byte atom wide
// at N = 32, so its LBO is never stepped over.  The exponentials, one ex2
// per live pair on the special-function unit (16 a clock per SM), take
// twice the products' time in the forward, 1.3 times in dQ and as long
// in dK/dV, so they bound all three.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_params.cuh"
#include "sm90.cuh"

namespace {

using namespace sm90;
using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and one producer warpgroup
constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kStages = 2;  // depth of the K/V (forward, dQ) and Q/dO (dK/dV) rings
constexpr float kNegInf = -1e30f;  // large-but-finite, as the TPU kernels
constexpr float kLog2e = 1.4426950408889634f;

// The shared-memory frame of head dim D (sm90.cuh's header): a tile is
// col_blocks<D>() column blocks of tile_cols<D>() bf16 columns, one
// swizzled line of line<D>() bytes a row; 128-byte lines and swizzle at
// D >= 64, one 64-byte line with 64-byte swizzle at D 32.
template <int D>
__host__ __device__ constexpr int line() { return D < 64 ? 64 : 128; }
template <int D>
__host__ __device__ constexpr int tile_cols() { return line<D>() / 2; }
template <int D>
__host__ __device__ constexpr int col_blocks() { return D < 64 ? 1 : D / 64; }

// A wgmma descriptor of a tile of head dim D: SBO is one 8-row atom.
template <int D>
__device__ __forceinline__ uint64_t desc_sw(uint32_t addr, uint32_t lbo) {
  if constexpr (line<D>() == 64) {
    return desc_sw64(addr, lbo, 512);
  } else {
    return desc_sw128(addr, lbo, 1024);
  }
}

// Where 16-byte chunk c of row r of a staging area sits in its line: the
// TMA swizzle's XOR pattern (128-byte lines: r % 8; 64-byte lines:
// (r / 2) % 4), so neighbouring rows fall on different banks.
template <int D>
__device__ __forceinline__ int swizzled_chunk(int c, int r) {
  if constexpr (line<D>() == 64) {
    return c ^ ((r >> 1) & 3);
  } else {
    return c ^ (r & 7);
  }
}

// Forward: 128 query rows per block (64 per consumer), 128-key tiles (64
// at head dim 256, so two stages of K and V fit shared memory beside the
// Q tile, and S (m64nBK) fits the consumers' registers beside O).
constexpr int kFwdBQ = 128;
template <int D>
__host__ __device__ constexpr int fwd_bk() { return D == 256 ? 64 : 128; }
// dQ: 128 query rows per block (64 per consumer), 64-key tiles (32 at
// head dim 256), so S, dP (m64nBK each) and the 64 x D dQ accumulator fit
// the consumers' registers and the tiles fit shared memory.  At head dim
// 32, where S and dP are chains of only two k16 steps, the tiles take 128
// keys, so each key tile's barrier round trip carries twice the work: S
// and dP are then 64 registers each beside dQ's 16 (about 4% faster than
// 64-key tiles on an H100, PERF.md).
constexpr int kDqBQ = 128;
template <int D>
__host__ __device__ constexpr int dq_bk() { return D == 256 ? 32 : D == 32 ? 128 : 64; }
// dK/dV: 128 keys per block (64 per consumer), 64-query tiles; at head
// dim 256 (the split kernel) 64 keys per block, both consumers on them.
constexpr int kDkvBK = 128, kDkvBQ = 64;
constexpr int kSplitBK = 64, kSplitBQ = 64;

__device__ __forceinline__ bool keep(const FlashParams& p, int row, int col) {
  bool ok = row < p.T && col < p.T;  // the ragged edge of both tiles
  if (p.causal) {
    ok = ok && col <= row;
    if (p.window > 0) ok = ok && col >= row - (p.window - 1);
  }
  return ok;
}

// Whether keep() can fail anywhere in rows [r0, r0 + nr) x cols [c0, c0 + nc).
__device__ __forceinline__ bool needs_mask(const FlashParams& p, int r0, int nr, int c0, int nc) {
  if (r0 + nr > p.T || c0 + nc > p.T) return true;
  if (!p.causal) return false;
  return c0 + nc - 1 > r0 || (p.window > 0 && c0 < r0 + nr - 1 - (p.window - 1));
}

// 2^x on the special-function unit (relative error ~2^-22); -inf and
// very negative arguments give +0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint8_t* aligned_smem(uint8_t* raw) {
  return raw + ((1024 - (smem_addr(raw) & 1023)) & 1023);
}

template <int D>
__device__ __forceinline__ void wgmma_rs_nd(float (&d)[D / 2], const uint32_t (&a)[4],
                                            uint64_t b) {
  if constexpr (D == 256) {
    wgmma_rs_n256(d, a, b, 1);
  } else if constexpr (D == 128) {
    wgmma_rs_n128(d, a, b, 1);
  } else if constexpr (D == 64) {
    wgmma_rs_n64(d, a, b, 1);
  } else {
    wgmma_rs_n32(d, a, b, 1);
  }
}

// The score products: N = 32, 64 or 128 keys (forward, dQ) or queries (dK/dV).
template <int N>
__device__ __forceinline__ void wgmma_ss_nk(float (&d)[N / 2], uint64_t a, uint64_t b,
                                            int scale_d) {
  if constexpr (N == 32) {
    wgmma_ss_n32(d, a, b, scale_d);
  } else if constexpr (N == 64) {
    wgmma_ss_n64(d, a, b, scale_d);
  } else {
    wgmma_ss_n128(d, a, b, scale_d);
  }
}

// Byte offset of a K-major k16 step `kk` in a tile of `rows` rows: 32
// bytes a step inside a line, then the next column block.
template <int D>
__device__ __forceinline__ uint32_t kmajor_step(int kk, int rows) {
  constexpr int kSteps = line<D>() / 32;  // k16 steps a line
  return (kk / kSteps) * rows * line<D>() + (kk % kSteps) * 32;
}

// The k16 A fragment for depth columns [16 kk, 16 kk + 16) of a float32
// accumulator tile, rounded to bf16 and packed in pairs.
template <int R>
__device__ __forceinline__ void to_frag(const float (&acc)[R], int kk, uint32_t (&a)[4]) {
  a[0] = pack_bf16(acc[8 * kk + 0], acc[8 * kk + 1]);
  a[1] = pack_bf16(acc[8 * kk + 2], acc[8 * kk + 3]);
  a[2] = pack_bf16(acc[8 * kk + 4], acc[8 * kk + 5]);
  a[3] = pack_bf16(acc[8 * kk + 6], acc[8 * kk + 7]);
}

// Write a warpgroup's 64 x D float32 accumulator (times `mul`) as bf16
// into a staging area laid out like a TMA tile of 64 rows (16-byte chunks
// at swizzled_chunk<D>, column blocks `block` bytes apart).
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* stage, int block, const float (&acc)[D / 2],
                                           float mul0, float mul1, int r_lo, int c_lo) {
  constexpr int kPerLine = line<D>() / 16;  // 16-byte chunks a line
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = r_lo + 8 * rr;
      const float mul = rr ? mul1 : mul0;
      const int off = (j / kPerLine) * block + r * line<D>() +
                      swizzled_chunk<D>(j % kPerLine, r) * 16 + 2 * c_lo;
      *reinterpret_cast<uint32_t*>(stage + off) =
          pack_bf16(acc[4 * j + 2 * rr] * mul, acc[4 * j + 2 * rr + 1] * mul);
    }
  }
}

// Copy the staged rows [0, 64) to rows [row0, row0 + 64) of a contiguous
// (B, T, H, D) bf16 tensor in 16-byte stores; rows past T are dropped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, const uint8_t* stage, int block,
                                           const FlashParams& p, int b, int h, int row0,
                                           int t) {
  constexpr int kChunks = D / 8, kPerLine = line<D>() / 16;
  for (int idx = t; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    if (row >= p.T) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(
        stage + (c / kPerLine) * block + r * line<D>() + swizzled_chunk<D>(c % kPerLine, r) * 16);
    *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * p.T + row) * p.H + h) * D +
                              c * 8) = val;
  }
}

// ---------------------------------------------------------------------------
// A. Forward: O = softmax(scale * Q K^T + mask) V, optionally lse.
// ---------------------------------------------------------------------------
// Online softmax of a warpgroup's 64 x BK score tile (keys k0 ...) in
// registers, a row's BK columns in the 4 threads of a quad: sc becomes P,
// m moves to the new row max; the factor that rescales the previous O and
// l is returned in corr, this thread's share of P's row sums in sum.
template <int BK>
__device__ __forceinline__ void online_softmax(const FlashParams& p, int wrow0, int row0,
                                               int c_lo, int k0, float (&sc)[BK / 2],
                                               float (&m)[2], float (&corr)[2],
                                               float (&sum)[2]) {
  float mx[2] = {m[0], m[1]};
  const bool masked = needs_mask(p, wrow0, 64, k0, BK);
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) sc[j] *= p.scale;
  if (masked) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (!keep(p, row0 + 8 * (e >> 1), k0 + 8 * j + c_lo + (e & 1))) sc[4 * j + e] = kNegInf;
    }
  }
#pragma unroll
  for (int j = 0; j < BK / 2; ++j) mx[(j >> 1) & 1] = fmaxf(mx[(j >> 1) & 1], sc[j]);
  float ml[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * kLog2e);
    m[r] = mx[r];
    // A row with no live key yet keeps m = -1e30: its masked entries
    // then give 0 here (not exp(0)), which the later corr = 0 would have
    // erased anyway.
    ml[r] = m[r] == kNegInf ? 0.f : m[r] * kLog2e;
    sum[r] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pv = ex2(fmaf(sc[4 * j + e], kLog2e, -ml[e >> 1]));
      sum[e >> 1] += pv;
      sc[4 * j + e] = pv;
    }
  }
}

template <int D>
struct FwdSmem {
  static constexpr int kQ = col_blocks<D>() * kFwdBQ * line<D>();       // the Q tile
  static constexpr int kKV = col_blocks<D>() * fwd_bk<D>() * line<D>();  // one K or V tile
  static constexpr int kK = kQ, kV = kK + kStages * kKV, kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 128 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v, const FlashParams p) {
  // The frame of head dim D: line bytes, columns and column blocks of a tile.
  constexpr int kLine = line<D>(), kCols = tile_cols<D>(), kBlocks = col_blocks<D>();
  using L = FwdSmem<D>;
  constexpr int BK = fwd_bk<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + L::kK;
  uint8_t* v_s = smem + L::kV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_q = bars;
  uint64_t* full_k = bars + 1;
  uint64_t* full_v = full_k + kStages;
  uint64_t* empty_k = full_v + kStages;  // K of a stage is released after S,
  uint64_t* empty_v = empty_k + kStages;  // V after P.V

  const int n_qt = (p.T + kFwdBQ - 1) / kFwdBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kFwdBQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  int k_lo = 0, k_hi = p.T;
  if (p.causal) {
    k_hi = min(p.T, q0 + kFwdBQ);
    if (p.window > 0) k_lo = max(0, q0 - (p.window - 1));
  }
  const int kt_lo = k_lo / BK, n_kt = (k_hi + BK - 1) / BK - kt_lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], kConsumers * 4);  // lane 0 of every consumer warp
      mbar_init(&empty_v[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the ring full.
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_expect_tx(full_q, L::kQ);
      for (int c = 0; c < kBlocks; ++c)
        tma_load_4d(q_s + c * kFwdBQ * kLine, &tm_q, full_q, c * kCols, h, q0, b);
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages, k0 = (kt_lo + i) * BK;
        const uint32_t ph = ((i / kStages) - 1) & 1;
        if (i >= kStages) mbar_wait(&empty_k[s], ph);
        mbar_expect_tx(&full_k[s], L::kKV);
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(k_s + s * L::kKV + c * BK * kLine, &tm_k, &full_k[s], c * kCols, h, k0, b);
        if (i >= kStages) mbar_wait(&empty_v[s], ph);
        mbar_expect_tx(&full_v[s], L::kKV);
        for (int c = 0; c < kBlocks; ++c)
          tma_load_4d(v_s + s * L::kKV + c * BK * kLine, &tm_v, &full_v[s], c * kCols, h, k0, b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64).
    // In the accumulator layout this thread holds rows r_lo and r_lo + 8
    // of them, columns 8 j + c_lo + {0, 1} of every 8-column chunk j.
    reg_alloc<kConsumerRegs>();
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4, c_lo = 2 * (lane % 4);
    const int wrow0 = q0 + 64 * wg, row0 = wrow0 + r_lo;
    const uint32_t q_base = smem_addr(q_s) + wg * 64 * kLine;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[BK / 2];         // S, then P, of the newest tile
    uint32_t pf[BK / 16][4];  // P of the previous tile as bf16, the A operand of P.V

    // S = Q K^T for tile i, 64 x BK per warpgroup (not waited for).
    auto issue_s = [&](int i) {
      const int s = i % kStages;
      const uint32_t k_base = smem_addr(k_s + s * L::kKV);
      mbar_wait(&full_k[s], (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_nk<BK>(sc, desc_sw<D>(q_base + kmajor_step<D>(kk, kFwdBQ), 16),
                        desc_sw<D>(k_base + kmajor_step<D>(kk, BK), 16), kk > 0);
      wgmma_commit();
    };
    // O += P V for tile i: V is the MN-major B operand (keys are the depth).
    auto issue_pv = [&](int i) {
      const int s = i % kStages;
      const uint32_t v_base = smem_addr(v_s + s * L::kKV);
      mbar_wait(&full_v[s], (i / kStages) & 1);
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_nd<D>(o, pf[kk], desc_sw<D>(v_base + kk * 16 * kLine, BK * kLine));
      wgmma_commit();
    };
    auto softmax = [&](int i, float (&corr)[2], float (&sum)[2]) {
      online_softmax<BK>(p, wrow0, row0, c_lo, (kt_lo + i) * BK, sc, m, corr, sum);
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };

    // Per tile i, S_i and P_{i-1} V_{i-1} are issued together; the softmax
    // of tile i runs while P_{i-1} V_{i-1} is on the tensor cores, and K_i's
    // stage is released as soon as S_i is done.  Ping-pong: the two
    // warpgroups take turns to issue their products (named barriers 3 and
    // 4), so one's softmax also runs while the other's products do.  Both
    // warpgroups walk the same tiles: at head dim 256 the last causal tile
    // (keys q0 + 64 ... q0 + 127) holds no key that warpgroup 0's rows see,
    // and it runs masked (P = 0 and corr = 1, its row max being finite by
    // then), so every turn_wait meets a turn_pass and every stage gets its
    // kConsumers * 4 arrivals.
    auto turn_wait = [&] { named_sync(3 + wg, 256); };
    auto turn_pass = [&] { named_arrive(3 + (wg ^ 1), 256); };
    if (wg == 1) named_arrive(3, 256);  // warpgroup 0 goes first
    float corr[2], sum[2];
    mbar_wait(full_q, 0);
    turn_wait();
    wgmma_fence();
    issue_s(0);
    turn_pass();
    wgmma_wait<0>();
    fence_regs(sc);
    release(&empty_k[0]);
    softmax(0, corr, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = sum[r];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_frag(sc, kk, pf[kk]);
    for (int i = 1; i < n_kt; ++i) {
      turn_wait();
      wgmma_fence();
      issue_s(i);
      issue_pv(i - 1);
      turn_pass();
      wgmma_wait<1>();
      fence_regs(sc);
      release(&empty_k[i % kStages]);
      softmax(i, corr, sum);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      release(&empty_v[(i - 1) % kStages]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // this thread's columns
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_frag(sc, kk, pf[kk]);
    }
    turn_wait();
    wgmma_fence();
    issue_pv(n_kt - 1);
    if (wg == 0) turn_pass();  // every turn_wait has met one turn_pass
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);

    // Epilogue: O / l as bf16, staged in this warpgroup's rows of the Q
    // tile (which only it reads), then 16-byte stores.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    uint8_t* stage = q_s + wg * 64 * kLine;
    fence_proxy_async();
    stage_rows<D>(stage, kFwdBQ * kLine, o, 1.f / l[0], 1.f / l[1], r_lo, c_lo);
    named_sync(1 + wg, 128);
    store_rows<D>(static_cast<bf16*>(p.o), stage, kFwdBQ * kLine, p, b, h, wrow0, t);
    if (p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < p.T) p.lse[static_cast<int64_t>(bh) * p.T + row] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// A above head dim 256 (any multiple of 128): O's columns split across
// blocks.
//
// A consumer's 64 x D float32 O would need D / 2 registers a thread (256
// at D 512), and a 128-row Q tile of D 1152 is 288 KB of shared memory.
// So a block takes 128 query rows (64 a consumer) and one slice of O's
// columns, NS = 256 wide (the last slice 128 wide where D / 128 is odd,
// in a second launch), and keeps the D-256 forward's register frame: O
// at m64nNS (128 registers), S and P of a 64-key tile (32 and 16).  Each
// block forms S = Q K^T over the whole head dim as a chain of 64-column
// blocks (4 k16 steps each), K arriving by TMA through a ring of 64-key x
// 64-column stages that a stage's wgmma group releases as soon as the
// next group is issued (wait_group 1), so no D is too large for the ring.
// Q stays resident in shared memory up to D 512 (kWideResidentMaxD: 128
// KB beside a 4-stage K ring and two V stages, 230,656 bytes); above it Q
// is streamed with K, a 64-column block of each a ring stage (6 stages).
// V arrives as the block's own column slice, two 64-key stages.
//
// Every slice of a query tile forms the same S, m and l bits (the same
// products in the same order), so their O columns are consistent and
// slice 0 alone writes lse.  At D 512 (two slices) recomputing S costs
// 1.5x the function's products, and it leaves no scratch and no atomics.
// Both consumers consume each ring stage; they do not take turns (a turn
// held over a chain of D / 64 stages would need the whole key tile in the
// ring), and each overlaps its softmax with its own P.V as the forward
// above does.  The arithmetic is flash_fwd_kernel_sm90's.
// ---------------------------------------------------------------------------
constexpr int kWideBQ = 128, kWideBK = 64;
constexpr int kWideResidentMaxD = 512;
constexpr int kWideQBlock = kWideBQ * 128;  // one 64-column block of the Q tile: 16 KB
constexpr int kWideKBlock = kWideBK * 128;  // of a K tile: 8 KB

template <bool kResident, int NS>
struct WideFwdSmem {
  // Resident: Q's D / 64 blocks, then a ring of K blocks.  Streamed: a
  // ring of (Q block, K block) stages.  Then two V stages and the barriers.
  static constexpr int kStages = kResident ? 4 : 6;
  static constexpr int kStage = kResident ? kWideKBlock : kWideQBlock + kWideKBlock;
  static constexpr int kKOff = kResident ? 0 : kWideQBlock;  // the K block in a stage
  static constexpr int kV = NS / 64 * kWideKBlock;           // one V stage
  __host__ __device__ static int ring(int D) { return kResident ? D / 64 * kWideQBlock : 0; }
  __host__ __device__ static int v(int D) { return ring(D) + kStages * kStage; }
  __host__ __device__ static int bar(int D) { return v(D) + 2 * kV; }
  __host__ __device__ static int bytes(int D) { return bar(D) + 256 + 1024; }  // alignment slack
};

// Copy the staged rows [0, 64) x NS to rows [row0, row0 + 64), columns
// [col0, col0 + NS) of a contiguous (B, T, H, D) bf16 tensor in 16-byte
// stores; rows past T are dropped.
template <int NS>
__device__ __forceinline__ void store_slice_rows(bf16* out, const uint8_t* stage, int block,
                                                 const FlashParams& p, int b, int h, int row0,
                                                 int col0, int t) {
  constexpr int kChunks = NS / 8;
  for (int idx = t; idx < 64 * kChunks; idx += 128) {
    const int r = idx / kChunks, c = idx % kChunks, row = row0 + r;
    if (row >= p.T) continue;
    const uint4 val = *reinterpret_cast<const uint4*>(stage + (c / 8) * block + r * 128 +
                                                      swizzled_chunk<NS>(c % 8, r) * 16);
    *reinterpret_cast<uint4*>(out + ((static_cast<int64_t>(b) * p.T + row) * p.H + h) * p.D +
                              col0 + c * 8) = val;
  }
}

template <bool kResident, int NS>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wide_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v, const FlashParams p,
                               int col_base, int n_slices) {
  using L = WideFwdSmem<kResident, NS>;
  constexpr int BK = kWideBK, kStages = L::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  const int nc = p.D / 64;  // 64-column blocks of the head dim: the chain of S
  uint8_t* q_s = smem;      // resident Q
  uint8_t* ring = smem + L::ring(p.D);
  uint8_t* v_s = smem + L::v(p.D);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::bar(p.D));
  uint64_t* full_q = bars;
  uint64_t* full = bars + 1;  // a ring stage
  uint64_t* empty = full + kStages;
  uint64_t* full_v = empty + kStages;
  uint64_t* empty_v = full_v + 2;

  // The slices of a query tile are neighbours in the grid, so they read
  // its Q and K rows from L2 at about the same time.
  const int slice = static_cast<int>(blockIdx.x) % n_slices;
  const int col0 = col_base + slice * NS;
  const int n_qt = (p.T + kWideBQ - 1) / kWideBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / n_slices) * kWideBQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  int k_lo = 0, k_hi = p.T;
  if (p.causal) {
    k_hi = min(p.T, q0 + kWideBQ);
    if (p.window > 0) k_lo = max(0, q0 - (p.window - 1));
  }
  const int kt_lo = k_lo / BK, n_kt = (k_hi + BK - 1) / BK - kt_lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_v[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread keeps the rings full, in the order the
    // consumers take them: key tile i's D / 64 ring stages, then its V.
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      if constexpr (kResident) {
        mbar_expect_tx(full_q, nc * kWideQBlock);
        for (int c = 0; c < nc; ++c)
          tma_load_4d(q_s + c * kWideQBlock, &tm_q, full_q, 64 * c, h, q0, b);
      }
      int g = 0;  // ring stages filled
      for (int i = 0; i < n_kt; ++i) {
        const int k0 = (kt_lo + i) * BK;
        for (int c = 0; c < nc; ++c, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(&empty[s], ((g / kStages) - 1) & 1);
          uint8_t* stage = ring + s * L::kStage;
          if constexpr (kResident) {
            mbar_expect_tx(&full[s], kWideKBlock);
          } else {
            mbar_expect_tx(&full[s], kWideQBlock + kWideKBlock);
            tma_load_4d(stage, &tm_q, &full[s], 64 * c, h, q0, b);
          }
          tma_load_4d(stage + L::kKOff, &tm_k, &full[s], 64 * c, h, k0, b);
        }
        const int vs = i % 2;
        if (i >= 2) mbar_wait(&empty_v[vs], ((i / 2) - 1) & 1);
        mbar_expect_tx(&full_v[vs], L::kV);
        for (int j = 0; j < NS / 64; ++j)
          tma_load_4d(v_s + vs * L::kV + j * BK * 128, &tm_v, &full_v[vs], col0 + 64 * j, h, k0,
                      b);
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
    // and their O columns [col0, col0 + NS).  This thread holds rows r_lo
    // and r_lo + 8, columns 8 j + c_lo + {0, 1} of every 8-column chunk j.
    reg_alloc<kConsumerRegs>();
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4, c_lo = 2 * (lane % 4);
    const int wrow0 = q0 + 64 * wg, row0 = wrow0 + r_lo;

    float o[NS / 2];
#pragma unroll
    for (int i = 0; i < NS / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float sc[BK / 2];         // S, then P, of the newest tile
    uint32_t pf[BK / 16][4];  // P of the previous tile as bf16, the A operand of P.V
    int g = 0;                // ring stages taken

    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // S = Q K^T for tile i, 64 x BK per warpgroup, as a chain of D / 64
    // groups; each stage is released once the next group is issued and
    // its own has completed.  The last group is left in flight.  The first
    // block is issued apart, so every wgmma in the loop accumulates
    // (scale-d 1): a scale-d read at run time made ptxas serialise the
    // chain (C7515; 1.09 against 0.82 ms at 2 x 512 on an H100).
    auto s_block = [&](int c, int scale0) {
      const int s = g % kStages;
      mbar_wait(&full[s], (g / kStages) & 1);
      uint8_t* stage = ring + s * L::kStage;
      const uint32_t q_base =
          smem_addr(kResident ? q_s + c * kWideQBlock : stage) + wg * 64 * 128;
      const uint32_t k_base = smem_addr(stage + L::kKOff);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n64(sc, desc_sw128(q_base + 32 * kk, 16, 1024),
                     desc_sw128(k_base + 32 * kk, 16, 1024), kk > 0 ? 1 : scale0);
      wgmma_commit();
      ++g;
    };
    auto issue_s = [&] {
      s_block(0, 0);
      for (int c = 1; c < nc; ++c) {
        s_block(c, 1);
        wgmma_wait<1>();
        release(&empty[(g - 2) % kStages]);
      }
    };
    // O += P V for tile i: V is the MN-major B operand (keys are the depth).
    auto issue_pv = [&](int i) {
      const int vs = i % 2;
      const uint32_t v_base = smem_addr(v_s + vs * L::kV);
      mbar_wait(&full_v[vs], (i / 2) & 1);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wgmma_rs_nd<NS>(o, pf[kk], desc_sw128(v_base + kk * 16 * 128, BK * 128, 1024));
      wgmma_commit();
    };
    auto softmax = [&](int i, float (&corr)[2], float (&sum)[2]) {
      online_softmax<BK>(p, wrow0, row0, c_lo, (kt_lo + i) * BK, sc, m, corr, sum);
    };

    // Per tile i: S_i's chain, then P_{i-1} V_{i-1}; the softmax of tile
    // i runs while P_{i-1} V_{i-1} is on the tensor cores.  Both
    // warpgroups walk the same tiles (a tile none of a warpgroup's rows
    // sees runs masked), so every stage gets its kConsumers * 4 arrivals.
    float corr[2], sum[2];
    if constexpr (kResident) mbar_wait(full_q, 0);
    issue_s();
    wgmma_wait<0>();
    fence_regs(sc);
    release(&empty[(g - 1) % kStages]);
    softmax(0, corr, sum);
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = sum[r];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) to_frag(sc, kk, pf[kk]);
    for (int i = 1; i < n_kt; ++i) {
      issue_s();
      issue_pv(i - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      release(&empty[(g - 1) % kStages]);
      softmax(i, corr, sum);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pf);
      release(&empty_v[(i - 1) % 2]);
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];  // this thread's columns
#pragma unroll
      for (int j = 0; j < NS / 8; ++j) {
        o[4 * j + 0] *= corr[0];
        o[4 * j + 1] *= corr[0];
        o[4 * j + 2] *= corr[1];
        o[4 * j + 3] *= corr[1];
      }
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) to_frag(sc, kk, pf[kk]);
    }
    issue_pv(n_kt - 1);
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(pf);

    // Epilogue: O / l as bf16, staged in this warpgroup's rows of the Q
    // blocks (resident) or of the first NS / 64 ring stages' Q blocks
    // (streamed), which only it reads and TMA no longer writes, then
    // 16-byte stores into the slice's columns.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    uint8_t* stage = (kResident ? q_s : ring) + wg * 64 * 128;
    const int block = kResident ? kWideQBlock : L::kStage;
    fence_proxy_async();
    stage_rows<NS>(stage, block, o, 1.f / l[0], 1.f / l[1], r_lo, c_lo);
    named_sync(1 + wg, 128);
    store_slice_rows<NS>(static_cast<bf16*>(p.o), stage, block, p, b, h, wrow0, col0, t);
    if (col0 == 0 && p.lse != nullptr && lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        if (row < p.T) p.lse[static_cast<int64_t>(bh) * p.T + row] = m[r] + logf(l[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// B. dQ = scale * sum_k dS K, dS = P * (dO V^T + rowterm), the row term
// dadj - rowsum(dO * O) read from the pre-pass.
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {
  static constexpr int kQ = col_blocks<D>() * kDqBQ * line<D>();        // the Q or the dO tile
  static constexpr int kKV = col_blocks<D>() * dq_bk<D>() * line<D>();  // one K or V tile
  static constexpr int kDO = kQ, kK = 2 * kQ, kV = kK + kStages * kKV, kBar = kV + kStages * kKV;
  static constexpr int kBytes = kBar + 64 + 1024;  // barriers, alignment slack
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dq_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do, const FlashParams p) {
  // The frame of head dim D: line bytes, columns and column blocks of a tile.
  constexpr int kLine = line<D>(), kCols = tile_cols<D>(), kBlocks = col_blocks<D>();
  using L = DqSmem<D>;
  constexpr int BK = dq_bk<D>();
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* q_s = smem;
  uint8_t* do_s = smem + L::kDO;
  uint8_t* k_s = smem + L::kK;
  uint8_t* v_s = smem + L::kV;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_q = bars;  // Q and dO
  uint64_t* full = bars + 1;  // K and V of a stage
  uint64_t* empty = bars + 1 + kStages;

  const int n_qt = (p.T + kDqBQ - 1) / kDqBQ;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x)) * kDqBQ;  // longest causal rows first
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  int k_lo = 0, k_hi = p.T;
  if (p.causal) {
    k_hi = min(p.T, q0 + kDqBQ);
    if (p.window > 0) k_lo = max(0, q0 - (p.window - 1));
  }
  const int kt_lo = k_lo / BK, n_kt = (k_hi + BK - 1) / BK - kt_lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers * 4);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer: one thread loads Q and dO once, then keeps the K/V ring full.
    reg_dealloc<kProducerRegs>();
    if (t == 0) {
      tma_prefetch_map(&tm_q);
      tma_prefetch_map(&tm_do);
      tma_prefetch_map(&tm_k);
      tma_prefetch_map(&tm_v);
      mbar_expect_tx(full_q, 2 * L::kQ);
      for (int c = 0; c < kBlocks; ++c) {
        tma_load_4d(q_s + c * kDqBQ * kLine, &tm_q, full_q, c * kCols, h, q0, b);
        tma_load_4d(do_s + c * kDqBQ * kLine, &tm_do, full_q, c * kCols, h, q0, b);
      }
      for (int i = 0; i < n_kt; ++i) {
        const int s = i % kStages, k0 = (kt_lo + i) * BK;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], 2 * L::kKV);
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_4d(k_s + s * L::kKV + c * BK * kLine, &tm_k, &full[s], c * kCols, h, k0, b);
          tma_load_4d(v_s + s * L::kKV + c * BK * kLine, &tm_v, &full[s], c * kCols, h, k0, b);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns query rows [q0 + 64 wg, q0 + 64 wg + 64)
    // and keeps their dQ in registers for the whole walk.  This thread
    // holds rows r_lo and r_lo + 8, key columns 8 j + c_lo + {0, 1}.
    reg_alloc<kConsumerRegs>();
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4, c_lo = 2 * (lane % 4);
    const int wrow0 = q0 + 64 * wg, row0 = wrow0 + r_lo;
    const uint32_t q_base = smem_addr(q_s) + wg * 64 * kLine;
    const uint32_t do_base = smem_addr(do_s) + wg * 64 * kLine;
    const float scale_log2 = p.scale * kLog2e;
    // lse (times log2(e)) and the row term of this thread's two rows; rows
    // past T take 0, and the ragged mask zeroes their P.
    float lse2[2], rt[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      const int64_t idx = static_cast<int64_t>(bh) * p.T + row;
      lse2[r] = row < p.T ? p.lse[idx] * kLog2e : 0.f;
      rt[r] = row < p.T ? p.rowterm[idx] : 0.f;
    }

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    mbar_wait(full_q, 0);
    for (int i = 0; i < n_kt; ++i) {
      const int s = i % kStages, k0 = (kt_lo + i) * BK;
      const uint32_t k_base = smem_addr(k_s + s * L::kKV), v_base = smem_addr(v_s + s * L::kKV);
      // A key tile that none of this warpgroup's rows sees.
      const bool dead = wrow0 >= p.T ||
                        (p.causal && (k0 > wrow0 + 63 ||
                                      (p.window > 0 && k0 + BK - 1 < wrow0 - (p.window - 1))));
      mbar_wait(&full[s], (i / kStages) & 1);
      if (!dead) {
        // S = Q K^T, then dP = dO V^T, 64 rows x BK keys each.
        float st[BK / 2], dp[BK / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_nk<BK>(st, desc_sw<D>(q_base + kmajor_step<D>(kk, kDqBQ), 16),
                          desc_sw<D>(k_base + kmajor_step<D>(kk, BK), 16), kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_nk<BK>(dp, desc_sw<D>(do_base + kmajor_step<D>(kk, kDqBQ), 16),
                          desc_sw<D>(v_base + kmajor_step<D>(kk, BK), 16), kk > 0);
        wgmma_commit();
        wgmma_wait<1>();
        fence_regs(st);

        // P = exp(scale S - lse), 0 where masked, while dP is on the tensor cores.
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            st[4 * j + e] = ex2(fmaf(st[4 * j + e], scale_log2, -lse2[e >> 1]));
        }
        if (needs_mask(p, wrow0, 64, k0, BK)) {
#pragma unroll
          for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!keep(p, row0 + 8 * (e >> 1), k0 + 8 * j + c_lo + (e & 1))) st[4 * j + e] = 0.f;
          }
        }
        wgmma_wait<0>();
        fence_regs(dp);

        // dS = P (dP + rowterm), rounded to bf16 as the A operand of dS K.
#pragma unroll
        for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] + rt[e >> 1]);
        }
        uint32_t sf[BK / 16][4];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) to_frag(dp, kk, sf[kk]);

        // dQ += dS K: K is the MN-major B operand (keys are the depth).
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          wgmma_rs_nd<D>(dq, sf[kk], desc_sw<D>(k_base + kk * 16 * kLine, BK * kLine));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(sf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: scale * dQ as bf16, staged in this warpgroup's rows of the
    // Q tile (which only it reads), then 16-byte stores.
    uint8_t* stage = q_s + wg * 64 * kLine;
    fence_proxy_async();
    stage_rows<D>(stage, kDqBQ * kLine, dq, p.scale, p.scale, r_lo, c_lo);
    named_sync(1 + wg, 128);
    store_rows<D>(static_cast<bf16*>(p.dq), stage, kDqBQ * kLine, p, b, h, wrow0, t);
  }
}

// ---------------------------------------------------------------------------
// C. dV = sum_q P^T dO, dK = scale * sum_q dS^T Q, in the transposed
// orientation: keys are the rows of every product.
// ---------------------------------------------------------------------------
template <int D>
struct DkvSmem {
  static constexpr int kKV = col_blocks<D>() * kDkvBK * line<D>();  // the K or V tile
  static constexpr int kQ = col_blocks<D>() * kDkvBQ * line<D>();   // one Q or dO tile
  static constexpr int kV = kKV, kQs = 2 * kKV, kDO = kQs + kStages * kQ;
  static constexpr int kVec = kDO + kStages * kQ;  // lse and rowterm, per stage
  static constexpr int kBar = kVec + 2 * kStages * kDkvBQ * 4;
  static constexpr int kBytes = kBar + 64 + 1024;
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          const __grid_constant__ CUtensorMap tm_do, const FlashParams p) {
  // The frame of head dim D: line bytes, columns and column blocks of a tile.
  constexpr int kLine = line<D>(), kCols = tile_cols<D>(), kBlocks = col_blocks<D>();
  using L = DkvSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kV;
  uint8_t* q_s = smem + L::kQs;
  uint8_t* do_s = smem + L::kDO;
  float* lse_s = reinterpret_cast<float*>(smem + L::kVec);  // [stage][64], times log2(e)
  float* rt_s = lse_s + kStages * kDkvBQ;                   // [stage][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int k0 = static_cast<int>(blockIdx.x) * kDkvBK;  // early keys see the most queries
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  // Query rows that can see a key of this tile.
  int q_lo = 0, q_hi = p.T;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.T, k0 + kDkvBK - 1 + p.window);
  }
  const int qt_lo = q_lo / kDkvBQ, n_qt = (q_hi + kDkvBQ - 1) / kDkvBQ - qt_lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, one with the TMA bytes
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warp: K and V once, then Q, dO, lse and rowterm per Q tile.
    reg_dealloc<kProducerRegs>();
    if (t < 32) {
      if (t == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_do);
        mbar_expect_tx(full_kv, 2 * L::kKV);
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_4d(k_s + c * kDkvBK * kLine, &tm_k, full_kv, c * kCols, h, k0, b);
          tma_load_4d(v_s + c * kDkvBK * kLine, &tm_v, full_kv, c * kCols, h, k0, b);
        }
      }
      const int64_t vec0 = static_cast<int64_t>(bh) * p.T;
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % kStages, q0 = (qt_lo + i) * kDkvBQ;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        for (int r = t; r < kDkvBQ; r += 32) {
          const int tq = q0 + r;
          lse_s[s * kDkvBQ + r] = tq < p.T ? p.lse[vec0 + tq] * kLog2e : 0.f;
          rt_s[s * kDkvBQ + r] = tq < p.T ? p.rowterm[vec0 + tq] : 0.f;
        }
        if (t == 0) {
          mbar_expect_tx(&full[s], 2 * L::kQ);
          for (int c = 0; c < kBlocks; ++c) {
            tma_load_4d(q_s + s * L::kQ + c * kDkvBQ * kLine, &tm_q, &full[s], c * kCols, h, q0, b);
            tma_load_4d(do_s + s * L::kQ + c * kDkvBQ * kLine, &tm_do, &full[s], c * kCols, h, q0,
                        b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg owns keys [k0 + 64 wg, k0 + 64 wg + 64) and
    // keeps their dK and dV in registers for the whole walk.  This thread
    // holds key rows r_lo and r_lo + 8, query columns 8 j + c_lo + {0, 1}.
    reg_alloc<kConsumerRegs>();
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4, c_lo = 2 * (lane % 4);
    const int wkey0 = k0 + 64 * wg, key0 = wkey0 + r_lo;
    const uint32_t k_base = smem_addr(k_s) + wg * 64 * kLine;
    const uint32_t v_base = smem_addr(v_s) + wg * 64 * kLine;

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(full_kv, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % kStages, q0 = (qt_lo + i) * kDkvBQ;
      const uint32_t ph = (i / kStages) & 1;
      const uint32_t q_base = smem_addr(q_s + s * L::kQ), do_base = smem_addr(do_s + s * L::kQ);
      const float* lse_v = lse_s + s * kDkvBQ;
      const float* rt_v = rt_s + s * kDkvBQ;

      // A tile of queries that sees none of this warpgroup's keys.
      const bool dead = p.causal && (q0 + kDkvBQ - 1 < wkey0 ||
                                     (p.window > 0 && q0 > wkey0 + 63 + p.window - 1));
      mbar_wait(&full[s], ph);
      if (!dead) {
        // S^T = K Q^T and dP^T = V dO^T, 64 keys x 64 queries each.
        float st[32], dp[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, desc_sw<D>(k_base + kmajor_step<D>(kk, kDkvBK), 16),
                       desc_sw<D>(q_base + kmajor_step<D>(kk, kDkvBQ), 16), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, desc_sw<D>(v_base + kmajor_step<D>(kk, kDkvBK), 16),
                       desc_sw<D>(do_base + kmajor_step<D>(kk, kDkvBQ), 16), kk > 0);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dp);

        // P^T = exp(scale S^T - lse[q]), 0 where masked.
        const bool masked = needs_mask(p, q0, kDkvBQ, wkey0, 64);
        const float scale_log2 = p.scale * kLog2e;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qc = 8 * j + c_lo + (e & 1);
            st[4 * j + e] = ex2(fmaf(st[4 * j + e], scale_log2, -lse_v[qc]));
          }
        }
        if (masked) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!keep(p, q0 + 8 * j + c_lo + (e & 1), key0 + 8 * (e >> 1))) st[4 * j + e] = 0.f;
          }
        }
        uint32_t pf[4][4], sf[4][4];  // P^T and dS^T as bf16 A operands
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_frag(st, kk, pf[kk]);

        // dV += P^T dO (dO is the MN-major B operand) runs while dS^T =
        // P^T (dP^T + rowterm[q]) is formed.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvBQ / 16; ++kk)
          wgmma_rs_nd<D>(dv, pf[kk], desc_sw<D>(do_base + kk * 16 * kLine, kDkvBQ * kLine));
        wgmma_commit();
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * j + e] = st[4 * j + e] * (dp[4 * j + e] + rt_v[8 * j + c_lo + (e & 1)]);
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) to_frag(dp, kk, sf[kk]);

        // dK += dS^T Q: Q is the MN-major B operand.
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kDkvBQ / 16; ++kk)
          wgmma_rs_nd<D>(dk, sf[kk], desc_sw<D>(q_base + kk * 16 * kLine, kDkvBQ * kLine));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pf);
        fence_regs(sf);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: scale dK; stage dK and dV in this warpgroup's rows of the
    // K and V tiles (which only it reads), then 16-byte stores.
    uint8_t* k_stage = k_s + wg * 64 * kLine;
    uint8_t* v_stage = v_s + wg * 64 * kLine;
    fence_proxy_async();
    stage_rows<D>(k_stage, kDkvBK * kLine, dk, p.scale, p.scale, r_lo, c_lo);
    stage_rows<D>(v_stage, kDkvBK * kLine, dv, 1.f, 1.f, r_lo, c_lo);
    named_sync(1 + wg, 128);
    store_rows<D>(static_cast<bf16*>(p.dk), k_stage, kDkvBK * kLine, p, b, h, wkey0, t);
    store_rows<D>(static_cast<bf16*>(p.dv), v_stage, kDkvBK * kLine, p, b, h, wkey0, t);
  }
}

// ---------------------------------------------------------------------------
// C at head dim 256: one 64-key block, both consumers on its keys, each
// holding one output (64 x 256 float32, 128 registers a thread):
//   warpgroup 0: S^T = K Q^T -> P^T; dV += P^T dO
//   warpgroup 1: dP^T = V dO^T; dS^T = P^T (dP^T + rowterm[q]); dK += dS^T Q
// P^T goes from warpgroup 0 to warpgroup 1 in float32 through shared
// memory under two named barriers (full, empty), so each warpgroup runs
// two products a Q tile and none is repeated.
// ---------------------------------------------------------------------------
template <int D>
struct DkvSplitSmem {
  static constexpr int kKV = col_blocks<D>() * kSplitBK * line<D>();  // the K or V tile
  static constexpr int kQ = col_blocks<D>() * kSplitBQ * line<D>();   // one Q or dO tile
  static constexpr int kV = kKV, kQs = 2 * kKV, kDO = kQs + kStages * kQ;
  static constexpr int kPt = kDO + kStages * kQ;            // P^T, float32
  static constexpr int kVec = kPt + kSplitBK * kSplitBQ * 4;  // lse and rowterm, per stage
  static constexpr int kBar = kVec + 2 * kStages * kSplitBQ * 4;
  static constexpr int kBytes = kBar + 64 + 1024;
};

// Named barriers of the split kernel (1 and 2 are the epilogues').
constexpr int kPtFull = 3, kPtEmpty = 4, kSplitDone = 5;

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_dkv_split_kernel_sm90(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v,
                                const __grid_constant__ CUtensorMap tm_do, const FlashParams p) {
  // The frame of head dim D: line bytes, columns and column blocks of a tile.
  constexpr int kLine = line<D>(), kCols = tile_cols<D>(), kBlocks = col_blocks<D>();
  using L = DkvSplitSmem<D>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* smem = aligned_smem(smem_raw);
  uint8_t* k_s = smem;
  uint8_t* v_s = smem + L::kV;
  uint8_t* q_s = smem + L::kQs;
  uint8_t* do_s = smem + L::kDO;
  float4* pt_s = reinterpret_cast<float4*>(smem + L::kPt);   // [8][128 threads] x 4
  float* lse_s = reinterpret_cast<float*>(smem + L::kVec);  // [stage][64], times log2(e)
  float* rt_s = lse_s + kStages * kSplitBQ;                 // [stage][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::kBar);
  uint64_t* full_kv = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int k0 = static_cast<int>(blockIdx.x) * kSplitBK;  // early keys see the most queries
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  // Query rows that can see a key of this tile.  Both consumers own all 64
  // keys, so every Q tile of the walk is live for both: the walk starts at
  // the tile of q = k0 (causal) and ends before the first tile past the
  // window of key k0 + 63.
  int q_lo = 0, q_hi = p.T;
  if (p.causal) {
    q_lo = k0;
    if (p.window > 0) q_hi = min(p.T, k0 + kSplitBK - 1 + p.window);
  }
  const int qt_lo = q_lo / kSplitBQ, n_qt = (q_hi + kSplitBQ - 1) / kSplitBQ - qt_lo;

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 32);  // the producer warp's lanes, one with the TMA bytes
      mbar_init(&empty[s], kConsumers * 4);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (wg == kConsumers) {
    // Producer warp: K and V once, then Q, dO, lse and rowterm per Q tile.
    reg_dealloc<kProducerRegs>();
    if (t < 32) {
      if (t == 0) {
        tma_prefetch_map(&tm_q);
        tma_prefetch_map(&tm_do);
        mbar_expect_tx(full_kv, 2 * L::kKV);
        for (int c = 0; c < kBlocks; ++c) {
          tma_load_4d(k_s + c * kSplitBK * kLine, &tm_k, full_kv, c * kCols, h, k0, b);
          tma_load_4d(v_s + c * kSplitBK * kLine, &tm_v, full_kv, c * kCols, h, k0, b);
        }
      }
      const int64_t vec0 = static_cast<int64_t>(bh) * p.T;
      for (int i = 0; i < n_qt; ++i) {
        const int s = i % kStages, q0 = (qt_lo + i) * kSplitBQ;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        for (int r = t; r < kSplitBQ; r += 32) {
          const int tq = q0 + r;
          lse_s[s * kSplitBQ + r] = tq < p.T ? p.lse[vec0 + tq] * kLog2e : 0.f;
          rt_s[s * kSplitBQ + r] = tq < p.T ? p.rowterm[vec0 + tq] : 0.f;
        }
        if (t == 0) {
          mbar_expect_tx(&full[s], 2 * L::kQ);
          for (int c = 0; c < kBlocks; ++c) {
            tma_load_4d(q_s + s * L::kQ + c * kSplitBQ * kLine, &tm_q, &full[s], c * kCols, h, q0,
                        b);
            tma_load_4d(do_s + s * L::kQ + c * kSplitBQ * kLine, &tm_do, &full[s], c * kCols, h,
                        q0, b);
          }
        } else {
          mbar_arrive(&full[s]);
        }
      }
    }
  } else {
    // Consumers: both own keys [k0, k0 + 64); warpgroup 0 keeps their dV
    // in registers for the whole walk, warpgroup 1 their dK.  This thread
    // holds key rows r_lo and r_lo + 8, query columns 8 j + c_lo + {0, 1}
    // of every 64 x 64 score tile, the same places in both warpgroups.
    reg_alloc<kConsumerRegs>();
    const int lane = t % 32;
    const int r_lo = 16 * (t / 32) + lane / 4, c_lo = 2 * (lane % 4);
    const int key0 = k0 + r_lo;
    // The A operand of this warpgroup's score product: K (S^T) or V (dP^T).
    const uint32_t a_base = smem_addr(wg == 0 ? k_s : v_s);
    const float scale_log2 = p.scale * kLog2e;

    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    mbar_wait(full_kv, 0);
    for (int i = 0; i < n_qt; ++i) {
      const int s = i % kStages, q0 = (qt_lo + i) * kSplitBQ;
      const uint32_t q_base = smem_addr(q_s + s * L::kQ), do_base = smem_addr(do_s + s * L::kQ);
      mbar_wait(&full[s], (i / kStages) & 1);

      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1), 64 keys x 64 queries.
      float sc[32];
      const uint32_t bq_base = wg == 0 ? q_base : do_base;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64(sc, desc_sw<D>(a_base + kmajor_step<D>(kk, kSplitBK), 16),
                     desc_sw<D>(bq_base + kmajor_step<D>(kk, kSplitBQ), 16), kk > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);

      if (wg == 0) {
        // P^T = exp(scale S^T - lse[q]), 0 where masked.
        const float* lse_v = lse_s + s * kSplitBQ;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = ex2(fmaf(sc[4 * j + e], scale_log2, -lse_v[8 * j + c_lo + (e & 1)]));
        }
        if (needs_mask(p, q0, kSplitBQ, k0, kSplitBK)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (!keep(p, q0 + 8 * j + c_lo + (e & 1), key0 + 8 * (e >> 1))) sc[4 * j + e] = 0.f;
          }
        }
        // Hand P^T over once warpgroup 1 has read the previous one.
        if (i > 0) named_sync(kPtEmpty, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          pt_s[j * 128 + t] = make_float4(sc[4 * j], sc[4 * j + 1], sc[4 * j + 2], sc[4 * j + 3]);
        __threadfence_block();
        named_arrive(kPtFull, 256);
      } else {
        // dS^T = P^T (dP^T + rowterm[q]), from warpgroup 0's unrounded P^T.
        const float* rt_v = rt_s + s * kSplitBQ;
        named_sync(kPtFull, 256);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 pv = pt_s[j * 128 + t];
          const float pe[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = pe[e] * (sc[4 * j + e] + rt_v[8 * j + c_lo + (e & 1)]);
        }
        if (i + 1 < n_qt) {
          __threadfence_block();
          named_arrive(kPtEmpty, 256);
        }
      }

      // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1): the A
      // operand rounded to bf16, the Q-tile operand MN-major (queries are
      // the depth), N = 256.
      uint32_t frag[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) to_frag(sc, kk, frag[kk]);
      const uint32_t b_base = wg == 0 ? do_base : q_base;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSplitBQ / 16; ++kk)
        wgmma_rs_nd<D>(acc, frag[kk], desc_sw<D>(b_base + kk * 16 * kLine, kSplitBQ * kLine));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(frag);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // Epilogue: once neither warpgroup reads K or V any more, dV is staged
    // in the V tile and scale * dK in the K tile, then 16-byte stores.
    named_sync(kSplitDone, 256);
    uint8_t* stage = wg == 0 ? v_s : k_s;
    const float mul = wg == 0 ? 1.f : p.scale;
    fence_proxy_async();
    stage_rows<D>(stage, kSplitBK * kLine, acc, mul, mul, r_lo, c_lo);
    named_sync(1 + wg, 128);
    store_rows<D>(static_cast<bf16*>(wg == 0 ? p.dv : p.dk), stage, kSplitBK * kLine, p, b, h, k0,
                  t);
  }
}

// ---------------------------------------------------------------------------
// Pre-pass of B and C: rowterm[b, h, t] = dadj[b, h, t] - sum_d dO[b, t, h, d] O[b, t, h, d]
// in float32, reading O and dO once (16 bytes a load, min(D / VEC, 32)
// threads a row, so a row's threads share a warp).  Bound by bytes.
// ---------------------------------------------------------------------------
__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

constexpr int kRowThreads = 256;

template <typename T, int D>
__global__ void __launch_bounds__(kRowThreads) flash_bwd_rowterm_kernel(const FlashParams p) {
  constexpr int kVec = 16 / sizeof(T), kPerRow = D / kVec < 32 ? D / kVec : 32;
  constexpr int kLoads = D / (kVec * kPerRow), kRows = kRowThreads / kPerRow;
  const int64_t n_rows = static_cast<int64_t>(p.B) * p.T * p.H;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / kPerRow;
  const int part = threadIdx.x % kPerRow;
  float acc = 0.f;
  if (r < n_rows) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int64_t off = r * D + (i * kPerRow + part) * kVec;
      const uint4 a = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4 g = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc += to_f(gv[e]) * to_f(av[e]);
    }
  }
#pragma unroll
  for (int off = kPerRow / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && part == 0) {
    // r = (b T + t) H + h; rowterm is (B, H, T).
    const int h = static_cast<int>(r % p.H);
    const int64_t bt = r / p.H;
    const int tt = static_cast<int>(bt % p.T), b = static_cast<int>(bt / p.T);
    const int64_t idx = (static_cast<int64_t>(b) * p.H + h) * p.T + tt;
    p.rowterm[idx] = (p.dadj != nullptr ? p.dadj[idx] : 0.f) - acc;
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                     &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    return found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(ptr) : nullptr;
  }();
  return fn;
}

// A 4-D map (D, H, T, B) of a bf16 (B, T, H, D) tensor with element
// strides (sb, st, sh, 1), in boxes of `cols` head-dim columns x `rows`
// rows with the given swizzle (tile_map<D> below: head dim D's frame);
// rows past T read as zeros.
bool tile_map(CUtensorMap* map, const void* base, const FlashParams& p, int64_t sb, int64_t st,
              int64_t sh, int rows, int cols, CUtensorMapSwizzle swizzle) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(p.D), static_cast<cuuint64_t>(p.H),
                              static_cast<cuuint64_t>(p.T), static_cast<cuuint64_t>(p.B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(st) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The map of a tile of head dim D: one column block of tile_cols<D>()
// columns a box, swizzled as its line (64 or 128 bytes).
template <int D>
bool tile_map(CUtensorMap* map, const void* base, const FlashParams& p, int64_t sb, int64_t st,
              int64_t sh, int rows) {
  return tile_map(map, base, p, sb, st, sh, rows, tile_cols<D>(),
                  line<D>() == 64 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <int D>
cudaError_t fwd(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tile_map<D>(&mq, p.q, p, p.q_sb, p.q_st, p.q_sh, kFwdBQ) ||
      !tile_map<D>(&mk, p.k, p, p.k_sb, p.k_st, p.k_sh, fwd_bk<D>()) ||
      !tile_map<D>(&mv, p.v, p, p.v_sb, p.v_st, p.v_sh, fwd_bk<D>()))
    return cudaErrorInvalidValue;
  constexpr int smem = FwdSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kFwdBQ - 1) / kFwdBQ, p.B * p.H);
  flash_fwd_kernel_sm90<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

// The wide forward: slices of NS columns [col_base, col_base + n_slices NS).
template <bool kResident, int NS>
cudaError_t fwd_wide_slices(const FlashParams& p, const CUtensorMap& mq, const CUtensorMap& mk,
                            const CUtensorMap& mv, int col_base, int n_slices,
                            cudaStream_t stream) {
  const int smem = WideFwdSmem<kResident, NS>::bytes(p.D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wide_kernel_sm90<kResident, NS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kWideBQ - 1) / kWideBQ * n_slices, p.B * p.H);
  flash_fwd_wide_kernel_sm90<kResident, NS>
      <<<grid, kThreads, smem, stream>>>(mq, mk, mv, p, col_base, n_slices);
  return cudaGetLastError();
}

// Head dims above 256: D / 256 slices of 256 columns, then one of 128
// where D / 128 is odd.
template <bool kResident>
cudaError_t fwd_wide(const FlashParams& p, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  if (!tile_map<256>(&mq, p.q, p, p.q_sb, p.q_st, p.q_sh, kWideBQ) ||
      !tile_map<256>(&mk, p.k, p, p.k_sb, p.k_st, p.k_sh, kWideBK) ||
      !tile_map<256>(&mv, p.v, p, p.v_sb, p.v_st, p.v_sh, kWideBK))
    return cudaErrorInvalidValue;
  const int n_full = p.D / 256;
  cudaError_t err = fwd_wide_slices<kResident, 256>(p, mq, mk, mv, 0, n_full, stream);
  if (err != cudaSuccess || p.D % 256 == 0) return err;
  return fwd_wide_slices<kResident, 128>(p, mq, mk, mv, 256 * n_full, 1, stream);
}

// Whether the wide forward takes head dim D, and its dynamic shared memory
// there (the larger of its two launches).
bool wide_fwd(int D) { return D > 256 && D % 128 == 0; }
int wide_fwd_smem_bytes(int D) {
  return D <= kWideResidentMaxD ? WideFwdSmem<true, 256>::bytes(D)
                                : WideFwdSmem<false, 256>::bytes(D);
}

template <int D>
cudaError_t bwd_dq(const FlashParams& p, cudaStream_t stream) {
  const int64_t c_st = static_cast<int64_t>(p.H) * D;  // dO is contiguous
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map<D>(&mq, p.q, p, p.q_sb, p.q_st, p.q_sh, kDqBQ) ||
      !tile_map<D>(&mk, p.k, p, p.k_sb, p.k_st, p.k_sh, dq_bk<D>()) ||
      !tile_map<D>(&mv, p.v, p, p.v_sb, p.v_st, p.v_sh, dq_bk<D>()) ||
      !tile_map<D>(&mdo, p.dout, p, c_st * p.T, c_st, D, kDqBQ))
    return cudaErrorInvalidValue;
  constexpr int smem = DqSmem<D>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_dq_kernel_sm90<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.T + kDqBQ - 1) / kDqBQ, p.B * p.H);
  flash_dq_kernel_sm90<D><<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, p);
  return cudaGetLastError();
}

// The dK/dV body of a head dim: 128-key blocks split between the
// consumers (64, 128), or 64-key blocks with the outputs split (256).
template <int D>
constexpr bool dkv_split() { return D == 256; }

template <int D>
int dkv_smem_bytes() {
  if constexpr (dkv_split<D>()) {
    return DkvSplitSmem<D>::kBytes;
  } else {
    return DkvSmem<D>::kBytes;
  }
}

template <int D>
cudaError_t dkv(const FlashParams& p, cudaStream_t stream) {
  constexpr int BK = dkv_split<D>() ? kSplitBK : kDkvBK;
  constexpr int BQ = dkv_split<D>() ? kSplitBQ : kDkvBQ;
  const int64_t c_st = static_cast<int64_t>(p.H) * D;  // dO is contiguous
  CUtensorMap mq, mk, mv, mdo;
  if (!tile_map<D>(&mq, p.q, p, p.q_sb, p.q_st, p.q_sh, BQ) ||
      !tile_map<D>(&mk, p.k, p, p.k_sb, p.k_st, p.k_sh, BK) ||
      !tile_map<D>(&mv, p.v, p, p.v_sb, p.v_st, p.v_sh, BK) ||
      !tile_map<D>(&mdo, p.dout, p, c_st * p.T, c_st, D, BQ))
    return cudaErrorInvalidValue;
  const int smem = dkv_smem_bytes<D>();
  const dim3 grid((p.T + BK - 1) / BK, p.B * p.H);
  auto launch = [&](auto kernel) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(mq, mk, mv, mdo, p);
    return cudaGetLastError();
  };
  if constexpr (dkv_split<D>()) {
    return launch(flash_dkv_split_kernel_sm90<D>);
  } else {
    return launch(flash_dkv_kernel_sm90<D>);
  }
}

template <typename T, int D>
cudaError_t rowterm(const FlashParams& p, cudaStream_t stream) {
  constexpr int per_row = D / (16 / sizeof(T)) < 32 ? D / (16 / sizeof(T)) : 32;
  constexpr int rows_per_block = kRowThreads / per_row;
  const int64_t n_rows = static_cast<int64_t>(p.B) * p.T * p.H;
  const dim3 grid(static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block));
  flash_bwd_rowterm_kernel<T, D><<<grid, kRowThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// Head dims above 256 (multiples of 128): one row per warp, the head dim
// walked at run time, 16 bytes a load.
template <typename T>
__global__ void __launch_bounds__(kRowThreads) flash_bwd_rowterm_wide_kernel(const FlashParams p) {
  constexpr int kVec = 16 / sizeof(T), kRows = kRowThreads / 32;
  const int64_t n_rows = static_cast<int64_t>(p.B) * p.T * p.H;
  const int64_t r = static_cast<int64_t>(blockIdx.x) * kRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float acc = 0.f;
  if (r < n_rows) {
    for (int c = lane * kVec; c < p.D; c += 32 * kVec) {
      const int64_t off = r * p.D + c;
      const uint4 a = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.o) + off);
      const uint4 g = *reinterpret_cast<const uint4*>(static_cast<const T*>(p.dout) + off);
      const T* av = reinterpret_cast<const T*>(&a);
      const T* gv = reinterpret_cast<const T*>(&g);
#pragma unroll
      for (int e = 0; e < kVec; ++e) acc += to_f(gv[e]) * to_f(av[e]);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (r < n_rows && lane == 0) {
    const int h = static_cast<int>(r % p.H);
    const int64_t bt = r / p.H;
    const int tt = static_cast<int>(bt % p.T), b = static_cast<int>(bt / p.T);
    const int64_t idx = (static_cast<int64_t>(b) * p.H + h) * p.T + tt;
    p.rowterm[idx] = (p.dadj != nullptr ? p.dadj[idx] : 0.f) - acc;
  }
}

template <typename T>
cudaError_t rowterm_d(const FlashParams& p, cudaStream_t stream) {
  if (p.D > 256) {
    constexpr int rows_per_block = kRowThreads / 32;
    const int64_t n_rows = static_cast<int64_t>(p.B) * p.T * p.H;
    const dim3 grid(static_cast<unsigned>((n_rows + rows_per_block - 1) / rows_per_block));
    flash_bwd_rowterm_wide_kernel<T><<<grid, kRowThreads, 0, stream>>>(p);
    return cudaGetLastError();
  }
  switch (p.D) {
    case 32: return rowterm<T, 32>(p, stream);
    case 64: return rowterm<T, 64>(p, stream);
    case 128: return rowterm<T, 128>(p, stream);
    default: return rowterm<T, 256>(p, stream);
  }
}

// The base pointer and every stride of a view in bytes: TMA wants 16-byte multiples.
bool tma_ok(const void* ptr, int64_t sb, int64_t st, int64_t sh) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0 && (sb * 2) % 16 == 0 && (st * 2) % 16 == 0 &&
         (sh * 2) % 16 == 0;
}

// Dynamic shared memory of the forward (which 0), dQ (1) or dK/dV (2) at D.
template <int D>
int smem_bytes(int which) {
  return which == 0 ? FwdSmem<D>::kBytes : which == 1 ? DqSmem<D>::kBytes : dkv_smem_bytes<D>();
}

}  // namespace

cudaError_t flash_fwd_sm90(const FlashParams& p, cudaStream_t stream) {
  if (!tma_ok(p.q, p.q_sb, p.q_st, p.q_sh) || !tma_ok(p.k, p.k_sb, p.k_st, p.k_sh) ||
      !tma_ok(p.v, p.v_sb, p.v_st, p.v_sh) || reinterpret_cast<uintptr_t>(p.o) % 16 != 0)
    return cudaErrorInvalidValue;
  switch (p.D) {
    case 32: return fwd<32>(p, stream);
    case 64: return fwd<64>(p, stream);
    case 128: return fwd<128>(p, stream);
    case 256: return fwd<256>(p, stream);
    default:
      if (!wide_fwd(p.D)) return cudaErrorInvalidValue;  // no body at this head dim
      return p.D <= kWideResidentMaxD ? fwd_wide<true>(p, stream) : fwd_wide<false>(p, stream);
  }
}

cudaError_t flash_dq_sm90(const FlashParams& p, cudaStream_t stream) {
  if (!tma_ok(p.q, p.q_sb, p.q_st, p.q_sh) || !tma_ok(p.k, p.k_sb, p.k_st, p.k_sh) ||
      !tma_ok(p.v, p.v_sb, p.v_st, p.v_sh) || reinterpret_cast<uintptr_t>(p.dout) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.dq) % 16 != 0 || p.rowterm == nullptr || p.lse == nullptr)
    return cudaErrorInvalidValue;
  switch (p.D) {
    case 32: return bwd_dq<32>(p, stream);
    case 64: return bwd_dq<64>(p, stream);
    case 128: return bwd_dq<128>(p, stream);
    case 256: return bwd_dq<256>(p, stream);
    default: return cudaErrorInvalidValue;  // no body at this head dim
  }
}

cudaError_t flash_dkv_sm90(const FlashParams& p, cudaStream_t stream) {
  if (!tma_ok(p.q, p.q_sb, p.q_st, p.q_sh) || !tma_ok(p.k, p.k_sb, p.k_st, p.k_sh) ||
      !tma_ok(p.v, p.v_sb, p.v_st, p.v_sh) || reinterpret_cast<uintptr_t>(p.dout) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.dk) % 16 != 0 || reinterpret_cast<uintptr_t>(p.dv) % 16 != 0 ||
      p.rowterm == nullptr || p.lse == nullptr)
    return cudaErrorInvalidValue;
  switch (p.D) {
    case 32: return dkv<32>(p, stream);
    case 64: return dkv<64>(p, stream);
    case 128: return dkv<128>(p, stream);
    case 256: return dkv<256>(p, stream);
    default: return cudaErrorInvalidValue;  // no body at this head dim
  }
}

int flash_sm90_smem_bytes(int which, int D) {
  if (which < 0 || which > 2) return -1;
  switch (D) {
    case 32: return smem_bytes<32>(which);
    case 64: return smem_bytes<64>(which);
    case 128: return smem_bytes<128>(which);
    case 256: return smem_bytes<256>(which);
    default: return which == 0 && wide_fwd(D) ? wide_fwd_smem_bytes(D) : -1;  // no wgmma body
  }
}

cudaError_t flash_rowterm(const FlashParams& p, cudaStream_t stream) {
  if (p.rowterm == nullptr || reinterpret_cast<uintptr_t>(p.o) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(p.dout) % 16 != 0)
    return cudaErrorInvalidValue;
  return p.dtype == 0 ? rowterm_d<float>(p, stream) : rowterm_d<bf16>(p, stream);
}
