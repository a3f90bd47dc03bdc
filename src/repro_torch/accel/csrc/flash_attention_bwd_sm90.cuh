// B7's and B8's Hopper bodies: the GQA flash-attention backward for bf16
// inputs with head_dim 64, 80 or 128, on wgmma tensor-core products over
// TMA-fed tiles. Included by flash_attention_bwd.cu, whose C entry points
// flash_bwd_dq and flash_bwd_dkv take these bodies for exactly those
// inputs and the SIMT bodies for the others.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:169
// `_dkv_kernel` (B7, pallas_call :322) and :235 `_dq_kernel` (B8,
// pallas_call :361) for those inputs.
//
// What bounds them on an H100: at the training path's layer (Qwen1.5-
// 0.5B: b 1, sq = sk = 2048, 16 heads over 16, head_dim 64, causal) B7's
// four products are 17.2 GFLOP over the causal pairs and B8's three 12.9
// GFLOP, against about 24 and 20 MB of traffic: the bf16 tensor-core rate
// (989 TFLOP/s), not the memory (3.35 TB/s), bounds them (0.0174 and
// 0.0130 ms). The SIMT bodies' f32 FMAs are held to the card's 67 TFLOP/s
// outside the tensor cores.
//
// Design (after FlashAttention-3's backward, arXiv:2407.08608). One block
// of three warpgroups: warpgroups 0 and 1 are consumers of 64 rows each
// (wgmma's M), warpgroup 2 the producer; setmaxnreg moves registers from
// the producer (24 a thread; B7's 40) to the consumers (240; B7's 232).
// A consumer's pairs of (query tile, KV tile) are 64 x 64 and skip with
// the reference's static conditions (:184-189) at those tiles, the same
// pairs the plain versions walk. Every product is one of two operand
// shapes (over the rows' layout of flash_rows_sm90.cuh):
// both operands K-major in shared memory (SS), or A from registers and B
// MN-major in shared memory (RS, the transpose bit, no transposed copy).
// The accumulator's register layout is the A fragment's, so p and dS go
// from one product to the next without shared memory.
//
// Head_dim 80 (hubert-xlarge: 16 heads of 80) lies as five 16-column
// tiles with the 32-byte swizzle, 64 and 128 as 64-column blocks with the
// 128-byte swizzle: the layout and the products over it are B6's too
// (flash_rows_sm90.cuh, whose note says why).
//
// - B8 (dQ): one block per (128 query rows, query head, sequence). The
//   producer thread loads the block's Q and dO once and streams the KV
//   tiles of 64 keys through a 2-stage mbarrier ring. Per tile a consumer
//   runs S = Q.K^T and dP = dO.V^T (SS), p = exp(s scale - lse) in
//   registers (0 where masked, by a select, as :212-214 and :275-277; keys
//   past sk 0), dS = p (dP - delta) scale in f32, rounded to bf16 in the
//   A-fragment layout, and dQ += dS.K (RS, K MN-major). A thread's lse and
//   delta (its two rows) are read once into registers. dQ is written once
//   in q's type.
// - B7 (dK, dV): one block per (128 keys, query head, sequence). K and V
//   of the block's keys are loaded once; the producer streams the query
//   tiles of the band (one range [lo, hi)) through a 2-stage ring: Q and
//   dO by TMA from one thread, that tile's lse and delta by a second
//   producer warp into shared memory. The scores are computed transposed,
//   so p and dS land in registers as the A operands of the products that
//   take them: S^T = K.Q^T and dP^T = V.dO^T (SS), p^T and dS^T with lse
//   and delta per column, then dV += p^T.dO and dK += dS^T.Q (RS, dO and
//   Q MN-major), p and dS rounded to bf16. KV tiles launch in order, the
//   first ones (under the causal band, the most query tiles) first; B8's
//   query tiles launch backwards for the same reason.
//
// Numerics. s, dP, the subtraction of delta and every accumulator are f32
// (bf16 x bf16 products are exact in f32); the kernels depart from the
// reference on purpose in exactly four places, as the tensor cores take
// bf16 operands: p before dV += p^T.dO, dS before dK += dS^T.Q and before
// dQ += dS.K (the Pallas kernels keep p and dS in f32, :198-225 and
// :257-280). The plain versions round at the same points.
//
// The GQA group, with no atomics. The TPU kernel sums the group on its
// `g` grid axis into f32 scratch (:171-181). Here each B7 block owns one
// query head: with a group of 1 it writes dK and dV in k's type; with a
// larger group it writes its head's f32 partials into a (b, sk, hq, d)
// scratch, and flash_dkv_group_sum adds the group's partials of each KV
// head in head order and casts the sums. No block reads another's output,
// the sum order is fixed, and the same inputs give the same bits, which
// the training path's exactly-once contract needs. Query rows past sq
// and keys past sk are computed on TMA's zero fill, weigh 0 and are not
// written.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_rows_sm90.cuh"   // the rows' layout and products
#include "sm90_primitives.cuh"   // TMA, mbarriers, wgmma, tensor maps

namespace sm90 {
namespace bwd {

constexpr int ROWS = 64;         // a consumer's rows, and a streamed tile's
constexpr int NCONS = 2;         // consumer warpgroups
constexpr int BLOCK = NCONS * ROWS;   // query rows (B8) or keys (B7) a block
constexpr int STAGES = 2;        // streamed tiles in flight
constexpr int NT = 128 * (NCONS + 1);
constexpr float LOG2E = 1.4426950408889634f;

// The reference's static skip of a 64 x 64 (query tile, KV tile) pair
// (flash_attention.py:184-189).
__device__ __forceinline__ bool pair_runs(int q0, int k0, int q_offset,
                                          int causal, int window) {
  return !(causal && k0 > q0 + q_offset + ROWS - 1) &&
         !(window && !(k0 + ROWS - 1 > q0 + q_offset - window));
}

// Whether any (query, key) of the pair is masked: the tile crosses the
// band, the window or an end of the sequences.
__device__ __forceinline__ bool pair_edge(int q0, int k0, int sq, int sk,
                                          int q_offset, int causal,
                                          int window) {
  return q0 + ROWS > sq || k0 + ROWS > sk ||
         (causal && k0 + ROWS - 1 > q0 + q_offset) ||
         (window && k0 <= q0 + ROWS - 1 + q_offset - window);
}

__device__ __forceinline__ bool masked(int qp, int kp, int sq, int sk,
                                       int q_offset, int causal,
                                       int window) {
  const int pos = qp + q_offset;
  return qp >= sq || kp >= sk || (causal && kp > pos) ||
         (window && kp <= pos - window);
}

// The first and one-past-last streamed tile that any active consumer's
// pairs need: the union of two contiguous ranges one tile apart, itself
// contiguous. `runs(t)` says whether tile t runs for some consumer.
template <typename F>
__device__ __forceinline__ void band(int n, F runs, int& lo, int& hi) {
  lo = 0;
  while (lo < n && !runs(lo)) ++lo;
  hi = lo;
  while (hi < n && runs(hi)) ++hi;
}

// Shared memory of either kernel, each tile 1024-byte aligned (the
// 128-byte swizzle's period): the block's own rows of two operands as
// [consumer][64 rows in Cols' layout] (B8: Q, dO; B7: K, V), the streamed
// tiles of two operands as [stage][64 rows in Cols' layout] (B8: K, V; B7:
// Q, dO), B7's lse and delta per stage, the mbarriers.
template <int D>
struct Smem {
  static constexpr int TILE = Cols<D, ROWS>::BYTES;   // one streamed tile
  static constexpr int OWN = NCONS * TILE;             // one operand's rows
  static constexpr int A_OFF = 0, B_OFF = OWN;
  static constexpr int X_OFF = 2 * OWN;              // streamed, first
  static constexpr int Y_OFF = X_OFF + STAGES * TILE;
  static constexpr int STAT_OFF = Y_OFF + STAGES * TILE;   // B7: lse, delta
  static constexpr int BAR_OFF = STAT_OFF + STAGES * 2 * ROWS * 4;
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

// ---------------------------------------------------------------------------
// B8: dQ
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     __nv_bfloat16* __restrict__ dq, int sq, int sk, int hq,
                     int hkv, int causal, int window, float scale, int nqt,
                     int heads_batch) {
  using S = Smem<D>;
  using C = Cols<D, ROWS>;
  constexpr int CB = C::B128, OP = C::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + S::BAR_OFF;
  const uint32_t bar_k = bar_own + 8, bar_v = bar_k + 8 * STAGES,
                 bar_e = bar_v + 8 * STAGES;   // + 8 * stage

  // query tiles backwards, slowest: the longest causal rows launch first
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / heads_batch;
  const int hb = static_cast<int>(blockIdx.x) % heads_batch;
  const int h = hb % hq, b = hb / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BLOCK, q_offset = sk - sq;

  int lo, hi;
  band((sk + ROWS - 1) / ROWS,
       [&](int kt) {
         bool any = false;
         for (int w = 0; w < NCONS; ++w)
           any |= q0 + ROWS * w < sq &&
                  pair_runs(q0 + ROWS * w, kt * ROWS, q_offset, causal,
                            window);
         return any;
       },
       lo, hi);
  const int n_tiles = hi - lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, NCONS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS * 128) {
    // ---- producer warpgroup: one thread starts every load -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == NCONS * 128) {
      mbar_expect_tx(bar_own, 2 * S::OWN);
      for (int w = 0; w < NCONS; ++w) {
        C::load(base + S::A_OFF + w * OP, &tm_q, bar_own, h,
                     q0 + ROWS * w, b);
        C::load(base + S::B_OFF + w * OP, &tm_do, bar_own, h,
                     q0 + ROWS * w, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (lo + i) * ROWS;
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, S::TILE);
        C::load(base + S::X_OFF + s * S::TILE, &tm_k, bar_k + 8 * s,
                     hk, k0, b);
        mbar_expect_tx(bar_v + 8 * s, S::TILE);
        C::load(base + S::Y_OFF + s * S::TILE, &tm_v, bar_v + 8 * s,
                     hk, k0, b);
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 query rows each --------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
  const int w = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  // this thread holds rows r and r + 8 of the warpgroup's 64, and of each
  // 8-column group the columns c2 and c2 + 1
  const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int qw0 = q0 + ROWS * w;
  const float sl2 = scale * LOG2E;
  const uint32_t q_addr = base + S::A_OFF + w * OP;
  const uint32_t do_addr = base + S::B_OFF + w * OP;
  const size_t stat = ((size_t)b * hq + h) * sq;
  float lse2[2], dl[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qw0 + r + 8 * rr;
    lse2[rr] = row < sq ? lse[stat + row] * LOG2E : 0.f;
    dl[rr] = row < sq ? delta[stat + row] : 0.f;
  }

  // dQ's 64-column blocks and its 16-column tiles
  float acc[C::NB][32], acct[C::NT];
#pragma unroll
  for (int cb = 0; cb < C::NB; ++cb)
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[cb][j] = 0.f;
#pragma unroll
  for (int j = 0; j < C::NT; ++j) acct[j] = 0.f;
  float x[32], dp[32];       // a tile's S then dS in f32, and its dP
  uint32_t pa[4][4];         // dS in bf16: dQ's A operand

  mbar_wait(bar_own, 0);
  __syncwarp();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int k0 = (lo + i) * ROWS;
    const uint32_t k_addr = base + S::X_OFF + s * S::TILE;
    const uint32_t v_addr = base + S::Y_OFF + s * S::TILE;
    // every consumer waits for every tile, so that no consumer's arrival
    // on the empty barrier can run ahead of the other's use of the stage
    mbar_wait(bar_k + 8 * s, ph);
    mbar_wait(bar_v + 8 * s, ph);
    __syncwarp();
    if (qw0 < sq && pair_runs(qw0, k0, q_offset, causal, window)) {
      clear(x);
      clear(dp);
      wgmma_fence();
      start_scores<D, ROWS>(x, q_addr, k_addr);
      start_scores<D, ROWS>(dp, do_addr, v_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      fence_regs(dp);
      const bool edge =
          pair_edge(qw0, k0, sq, sk, q_offset, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int rr = (j / 2) % 2;
        float p = exp2f(x[j] * sl2 - lse2[rr]);   // scale after the product
        if (edge && masked(qw0 + r + 8 * rr, k0 + 8 * (j / 4) + c2 + j % 2,
                           sq, sk, q_offset, causal, window))
          p = 0.f;
        x[j] = p * (dp[j] - dl[rr]) * scale;
      }
      pack(x, pa);
      fence_acc<D, ROWS>(acc, acct);
      wgmma_fence();
      start_update<D, ROWS>(acc, acct, pa, k_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc<D, ROWS>(acc, acct);
    }
    if (lane == 0) mbar_arrive(bar_e + 8 * s);   // the stage is free
  }

#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qw0 + r + 8 * rr;
    if (row >= sq) continue;
    __nv_bfloat16* drow =
        dq + ((size_t)b * sq + row) * hq * D + (size_t)h * D;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int j = 4 * g + 2 * rr;
        *reinterpret_cast<uint32_t*>(drow + cb * 64 + 8 * g + c2) =
            pack_bf16(acc[cb][j], acc[cb][j + 1]);
      }
#pragma unroll
    for (int g = 0; g < 2 * C::T32; ++g) {   // the 16-column tiles
      const int j = 4 * g + 2 * rr;
      *reinterpret_cast<uint32_t*>(drow + 8 * g + c2) =
          pack_bf16(acct[j], acct[j + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// B7: dK and dV
// ---------------------------------------------------------------------------
// PARTIAL: write this query head's f32 partials into (b, sk, hq, d)
// scratch (a group above 1); otherwise dK and dV in bf16, (b, sk, hkv, d).
template <int D, bool PARTIAL>
__global__ void __launch_bounds__(NT, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, void* __restrict__ dk,
                      void* __restrict__ dv, int sq, int sk, int hq, int hkv,
                      int causal, int window, float scale, int heads_batch) {
  using S = Smem<D>;
  using C = Cols<D, ROWS>;
  constexpr int CB = C::B128, OP = C::BYTES;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_own = base + S::BAR_OFF;
  const uint32_t bar_f = bar_own + 8, bar_e = bar_f + 8 * STAGES;
  float* const stats = reinterpret_cast<float*>(
      smem_raw + (base - smem_u32(smem_raw)) + S::STAT_OFF);
  // stage s: lse * log2(e) at stats[2 ROWS s], delta at stats[2 ROWS s + ROWS]

  // KV tiles in order, slowest: under the causal band the first see the
  // most query tiles
  const int kt = static_cast<int>(blockIdx.x) / heads_batch;
  const int hb = static_cast<int>(blockIdx.x) % heads_batch;
  const int h = hb % hq, b = hb / hq;
  const int hk = h / (hq / hkv);
  const int k0 = kt * BLOCK, q_offset = sk - sq;

  int lo, hi;
  band((sq + ROWS - 1) / ROWS,
       [&](int qt) {
         bool any = false;
         for (int w = 0; w < NCONS; ++w)
           any |= k0 + ROWS * w < sk &&
                  pair_runs(qt * ROWS, k0 + ROWS * w, q_offset, causal,
                            window);
         return any;
       },
       lo, hi);
  const int n_tiles = hi - lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_own, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_f + 8 * s, 1 + 32);      // the TMA thread, the stat warp
      mbar_init(bar_e + 8 * s, NCONS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= NCONS * 128) {
    // ---- producer warpgroup: one thread starts the TMA loads, one warp
    // copies each query tile's lse and delta (40 registers: at 24 the
    // copy's addresses spilled) ------------------------------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = tid - NCONS * 128;
    if (pt == 0) {
      mbar_expect_tx(bar_own, 2 * S::OWN);
      for (int w = 0; w < NCONS; ++w) {
        C::load(base + S::A_OFF + w * OP, &tm_k, bar_own, hk,
                     k0 + ROWS * w, b);
        C::load(base + S::B_OFF + w * OP, &tm_v, bar_own, hk,
                     k0 + ROWS * w, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int q0 = (lo + i) * ROWS;
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_f + 8 * s, 2 * S::TILE);
        C::load(base + S::X_OFF + s * S::TILE, &tm_q, bar_f + 8 * s,
                     h, q0, b);
        C::load(base + S::Y_OFF + s * S::TILE, &tm_do, bar_f + 8 * s,
                     h, q0, b);
      }
    } else if (pt >= 32 && pt < 64) {
      const int l = pt - 32;
      const size_t stat = ((size_t)b * hq + h) * sq;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int q0 = (lo + i) * ROWS;
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        float* st = stats + 2 * ROWS * s;
        for (int j = l; j < ROWS; j += 32) {
          const int row = q0 + j;
          st[j] = row < sq ? lse[stat + row] * LOG2E : 0.f;
          st[ROWS + j] = row < sq ? delta[stat + row] : 0.f;
        }
        mbar_arrive(bar_f + 8 * s);   // release: the stores land first
      }
    }
    return;
  }

  // ---- consumer warpgroups: 64 keys each --------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int w = tid / 128, t = tid % 128;
  const int warp = t / 32, lane = t % 32;
  // this thread holds keys r and r + 8 of the warpgroup's 64, and of each
  // 8-column group of query rows the columns c2 and c2 + 1
  const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const int kw0 = k0 + ROWS * w;
  const float sl2 = scale * LOG2E;
  const uint32_t k_addr = base + S::A_OFF + w * OP;
  const uint32_t v_addr = base + S::B_OFF + w * OP;

  // dK's and dV's 64-column blocks and their 16-column tiles
  float dka[C::NB][32], dva[C::NB][32], dkt[C::NT], dvt[C::NT];
#pragma unroll
  for (int cb = 0; cb < C::NB; ++cb)
#pragma unroll
    for (int j = 0; j < 32; ++j) dka[cb][j] = dva[cb][j] = 0.f;
#pragma unroll
  for (int j = 0; j < C::NT; ++j) dkt[j] = dvt[j] = 0.f;
  float x[32], dp[32];        // a tile's S^T then p^T, its dP^T then dS^T
  uint32_t pa[4][4], dsa[4][4];   // p^T and dS^T in bf16: the A operands

  mbar_wait(bar_own, 0);
  __syncwarp();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    const int q0 = (lo + i) * ROWS;
    const uint32_t q_addr = base + S::X_OFF + s * S::TILE;
    const uint32_t do_addr = base + S::Y_OFF + s * S::TILE;
    const float* st = stats + 2 * ROWS * s;
    mbar_wait(bar_f + 8 * s, ph);   // every consumer, as in B8
    __syncwarp();
    if (kw0 < sk && pair_runs(q0, kw0, q_offset, causal, window)) {
      clear(x);
      clear(dp);
      wgmma_fence();
      start_scores<D, ROWS>(x, k_addr, q_addr);
      start_scores<D, ROWS>(dp, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(x);
      fence_regs(dp);
      const bool edge = pair_edge(q0, kw0, sq, sk, q_offset, causal, window);
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int col = 8 * (j / 4) + c2 + j % 2;   // query row q0 + col
        float p = exp2f(x[j] * sl2 - st[col]);
        if (edge && masked(q0 + col, kw0 + r + 8 * ((j / 2) % 2), sq, sk,
                           q_offset, causal, window))
          p = 0.f;
        x[j] = p;
        dp[j] = p * (dp[j] - st[ROWS + col]) * scale;
      }
      pack(x, pa);
      pack(dp, dsa);
      fence_acc<D, ROWS>(dva, dvt);
      fence_acc<D, ROWS>(dka, dkt);
      wgmma_fence();
      start_update<D, ROWS>(dva, dvt, pa, do_addr);
      start_update<D, ROWS>(dka, dkt, dsa, q_addr);
      wgmma_commit();
      wgmma_wait_all();
      fence_acc<D, ROWS>(dva, dvt);
      fence_acc<D, ROWS>(dka, dkt);
    }
    if (lane == 0) mbar_arrive(bar_e + 8 * s);   // the stage is free
  }

  // columns col and col + 1 of one key's dK and dV
  auto put = [&](int key, int col, float k0v, float k1v, float v0, float v1) {
    if (PARTIAL) {
      const size_t off =
          ((size_t)b * sk + key) * hq * D + (size_t)h * D + col;
      *reinterpret_cast<float2*>(static_cast<float*>(dk) + off) =
          make_float2(k0v, k1v);
      *reinterpret_cast<float2*>(static_cast<float*>(dv) + off) =
          make_float2(v0, v1);
    } else {
      const size_t off =
          ((size_t)b * sk + key) * hkv * D + (size_t)hk * D + col;
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dk) + off) =
          pack_bf16(k0v, k1v);
      *reinterpret_cast<uint32_t*>(static_cast<__nv_bfloat16*>(dv) + off) =
          pack_bf16(v0, v1);
    }
  };
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int key = kw0 + r + 8 * rr;
    if (key >= sk) continue;
#pragma unroll
    for (int cb = 0; cb < CB; ++cb)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int j = 4 * g + 2 * rr;
        put(key, cb * 64 + 8 * g + c2, dka[cb][j], dka[cb][j + 1],
            dva[cb][j], dva[cb][j + 1]);
      }
#pragma unroll
    for (int g = 0; g < 2 * C::T32; ++g) {   // the 16-column tiles
      const int j = 4 * g + 2 * rr;
      put(key, 8 * g + c2, dkt[j], dkt[j + 1], dvt[j], dvt[j + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// The GQA group sum of B7's partials
// ---------------------------------------------------------------------------
// dk[row, hk, c] = sum over g in order of part[row, hk group + g, c], and
// the same for dv, cast to bf16: one thread per 4 columns of one (row,
// KV head), rows = b sk.
__global__ void __launch_bounds__(256)
flash_dkv_group_sum_kernel(const float* __restrict__ dk_part,
                           const float* __restrict__ dv_part,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, long long n4,
                           int hkv, int group, int d) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int per_row = hkv * d / 4;
  const long long row = i / per_row;
  const int rem = static_cast<int>(i % per_row);
  const int hk = rem / (d / 4), c = 4 * (rem % (d / 4));
  const size_t src = ((size_t)row * hkv * group + (size_t)hk * group) * d + c;
  float4 sk4 = *reinterpret_cast<const float4*>(dk_part + src);
  float4 sv4 = *reinterpret_cast<const float4*>(dv_part + src);
  for (int g = 1; g < group; ++g) {
    const float4 a = *reinterpret_cast<const float4*>(dk_part + src + g * d);
    const float4 v = *reinterpret_cast<const float4*>(dv_part + src + g * d);
    sk4.x += a.x; sk4.y += a.y; sk4.z += a.z; sk4.w += a.w;
    sv4.x += v.x; sv4.y += v.y; sv4.z += v.z; sv4.w += v.w;
  }
  const size_t dst = (size_t)4 * i;
  uint2 ok, ov;
  ok.x = pack_bf16(sk4.x, sk4.y);
  ok.y = pack_bf16(sk4.z, sk4.w);
  ov.x = pack_bf16(sv4.x, sv4.y);
  ov.y = pack_bf16(sv4.z, sv4.w);
  *reinterpret_cast<uint2*>(dk + dst) = ok;
  *reinterpret_cast<uint2*>(dv + dst) = ov;
}

// ---------------------------------------------------------------------------
// Launches
// ---------------------------------------------------------------------------
// The four operands' maps, boxes of Cols' layout: 64 columns with the
// 128-byte swizzle, or 16 with the 32-byte swizzle.
struct Maps {
  CUtensorMap q, k, v, dout;
};

template <int D>
int maps(Maps& m, const void* q, const void* k, const void* v,
         const void* dout, int b, int sq, int sk, int hq, int hkv) {
  using C = Cols<D, ROWS>;
  int rc = C::map(&m.q, q, b, sq, hq);
  if (rc == 0) rc = C::map(&m.k, k, b, sk, hkv);
  if (rc == 0) rc = C::map(&m.v, v, b, sk, hkv);
  if (rc == 0) rc = C::map(&m.dout, dout, b, sq, hq);
  return rc;
}

template <typename K>
int smem_attr(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int b, int sq,
              int sk, int hq, int hkv, int causal, int window, float scale,
              cudaStream_t stream) {
  Maps m;
  int rc = maps<D>(m, q, k, v, dout, b, sq, sk, hq, hkv);
  if (rc != 0) return rc;
  auto kern = flash_dq_sm90_kernel<D>;
  const int smem = Smem<D>::ALLOC;
  if ((rc = smem_attr(kern, smem)) != 0) return rc;
  const int nqt = (sq + BLOCK - 1) / BLOCK;
  kern<<<nqt * hq * b, NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<__nv_bfloat16*>(dq), sq,
      sk, hq, hkv, causal, window, scale, nqt, hq * b);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
               int causal, int window, float scale, cudaStream_t stream) {
  Maps m;
  int rc = maps<D>(m, q, k, v, dout, b, sq, sk, hq, hkv);
  if (rc != 0) return rc;
  auto kern = hq == hkv ? flash_dkv_sm90_kernel<D, false>
                        : flash_dkv_sm90_kernel<D, true>;
  const int smem = Smem<D>::ALLOC;
  if ((rc = smem_attr(kern, smem)) != 0) return rc;
  const int nkt = (sk + BLOCK - 1) / BLOCK;
  kern<<<nkt * hq * b, NT, smem, stream>>>(
      m.q, m.k, m.v, m.dout, static_cast<const float*>(lse),
      static_cast<const float*>(delta), dk, dv, sq, sk, hq, hkv, causal,
      window, scale, hq * b);
  return (int)cudaGetLastError();
}

// 1 where these bodies take the inputs: bf16 with head_dim 64, 80 or 128.
inline int takes(int is_bf16, int d) {
  return is_bf16 && (d == 64 || d == 80 || d == 128);
}

inline int group_sum(const void* dk_part, const void* dv_part, void* dk,
                     void* dv, int rows, int hq, int hkv, int d,
                     cudaStream_t stream) {
  const long long n4 = (long long)rows * hkv * d / 4;
  if (n4 == 0) return 0;
  const long long blocks = (n4 + 255) / 256;
  flash_dkv_group_sum_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(dk_part), static_cast<const float*>(dv_part),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), n4,
      hkv, hq / hkv, d);
  return (int)cudaGetLastError();
}

}  // namespace bwd
}  // namespace sm90
