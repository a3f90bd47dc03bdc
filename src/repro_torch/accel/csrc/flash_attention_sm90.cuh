// B6's Hopper body: the GQA flash-attention forward for bf16 inputs with
// head_dim 64, 80 or 128, on wgmma tensor-core products over TMA-fed
// tiles. Included by flash_attention.cu, whose C entry point flash_fwd
// takes this body for exactly those inputs and the SIMT body for the
// others.
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:38
// `_fwd_kernel` (its pallas_call at :141) for those inputs.
//
// What bounds it on an H100: at the serving path's prefill shape (b 4,
// sq = sk = 2048, 32 query heads over 8 KV heads, head_dim 128, causal) the
// two products are 137.5 GFLOP over the causal pairs against about 169 MB
// of traffic, so the bf16 tensor-core rate (989 TFLOP/s), not the memory
// (3.35 TB/s), bounds it: 0.139 ms. At hubert-xlarge's layer (b 4, 2,048
// frames, 16/16 heads of 80, non-causal) the products are 85.9 GFLOP
// against 84 MB: 0.0869 ms. The SIMT body's f32 FMAs cannot pass the
// card's 67 TFLOP/s outside the tensor cores (>= 2 ms and 1.3 ms there).
//
// Design (after FlashAttention-3, arXiv:2407.08608). One block of three
// warpgroups per (128 query rows, query head, sequence): warpgroups 0 and
// 1 are consumers of 64 query rows each (wgmma's M), warpgroup 2 the
// producer; setmaxnreg moves registers from the producer (24 a thread) to
// the consumers (240). One producer thread starts TMA loads
// (cp.async.bulk.tensor) of the block's Q once and of K and V tiles of 128
// keys into a ring of stages (3 at head_dim 64 and 80, 2 at 128: below),
// with an mbarrier per stage for K full, V full and the stage empty again.
// The tensor maps are rank 4 over (d, heads, s, b), so a ragged tile's
// rows past s read as zeros of this sequence, never the next one's keys. A row lies in shared memory as
// flash_rows_sm90.cuh lays it out for every Hopper body, and the wgmma
// descriptors carry its swizzle: head_dim 64 and 128 as 64-column blocks
// with the 128-byte swizzle (one TMA box each), 80 as five 16-column
// tiles with the 32-byte swizzle (one box each; five K-major steps for
// the scores, and one N = 80 product a 16-key step for O, over V's five
// tiles, 4,096 B apart at 128 keys). Per KV tile a consumer
//   - runs S = Q.K^T as wgmma with both operands in shared memory (bf16 x
//     bf16 products are exact in f32, so this is the reference's
//     upcast-then-dot up to summation order), f32 accumulators in
//     registers;
//   - masks only a tile that the causal band, the window or the end of
//     the keys crosses (masked scores -1e30, keys past sk -inf, as the
//     SIMT body), scales, and runs the online softmax in registers: a
//     row's max and sum are over the 4 threads that hold it (shuffles);
//     exp2f with scale * log2(e) folded into the score, m kept in that
//     base-2 unit and lse = m ln 2 + log(l_safe) written in f32;
//   - rounds p to bf16 in registers and runs O += P.V as wgmma with A
//     from registers and V from shared memory as an MN-major operand
//     (the transpose bit: no transposed copy). Here the kernel departs
//     from the reference on purpose: the Pallas kernel keeps p in f32
//     (flash_attention.py:86-91); l sums the f32 p, as there.
// A consumer waits for each product before it reads the result; the two
// consumers' products and softmax interleave on the SM. (FA3's
// schedule, S of tile i started beside P.V of tile i-1 with the two
// consumers taking turns, measured slower in this kernel: PERF.md.)
// The KV tiles that run for the block are the reference's static skips
// (:58-63) at this body's 128 x 128 tiles, one range [lo, hi). Query rows
// past sq are computed on TMA's zero fill and not written. Under the
// causal band the q tiles with the most KV tiles launch first (the q tile
// index runs backwards and slowest in blockIdx.x). No atomics and no
// split of the keys: the same inputs give the same bits, which the
// training path's exactly-once contract needs.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_rows_sm90.cuh"   // the rows' layout and products
#include "sm90_primitives.cuh"   // TMA, mbarriers, wgmma, tensor maps

namespace sm90 {

constexpr int BQ = 128;          // query rows per block
constexpr int BK = 128;          // keys per KV tile
constexpr int NCONS = 2;         // consumer warpgroups of 64 rows
constexpr int NT = 128 * (NCONS + 1);
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float MASKED = -1e30f;

// KV tiles in flight. On an H100 3 stages ran 4-7 % ahead of 2 at head_dim
// 64 and at hubert-xlarge's training layer (d 80), and 6 % behind at
// Qwen3-8B's prefill (d 128, where Q and three stages take 224 KB of the
// 227 a block may have): PERF.md.
template <int D>
constexpr int stages() {
  return D == 128 ? 2 : 3;
}

// Shared memory, each block or tile 1024-byte aligned: Q as [consumer][64
// rows in Cols' layout], K and V as [stage][BK rows in Cols' layout], then
// the mbarriers.
template <int D>
struct Smem {
  static constexpr int STAGES = stages<D>();
  static constexpr int Q_PART = Cols<D, 64>::BYTES;   // a consumer's Q
  static constexpr int KV_BYTES = Cols<D, BK>::BYTES;  // one K or V tile
  static constexpr int Q_BYTES = NCONS * Q_PART;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int ALLOC = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int sq, int sk, int hq,
                      int hkv, int causal, int window, float scale, int nqt,
                      int heads_batch) {
  using S = Smem<D>;
  constexpr int STAGES = S::STAGES;
  using CQ = Cols<D, 64>;
  using CK = Cols<D, BK>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::BAR_OFF;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * STAGES,
                 bar_e = bar_v + 8 * STAGES;   // + 8 * stage

  // q tiles backwards, slowest: the longest causal rows launch first
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / heads_batch;
  const int hb = static_cast<int>(blockIdx.x) % heads_batch;
  const int h = hb % hq, b = hb / hq;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ, q_offset = sk - sq;

  // The reference's static skips (flash_attention.py:58-63) at this
  // body's tiles: one range [lo, hi) for the whole block.
  const int nkt = (sk + BK - 1) / BK;
  auto runs = [&](int kt) {
    const int k0 = kt * BK;
    return !(causal && k0 > q0 + q_offset + BQ - 1) &&
           !(window && !(k0 + BK - 1 > q0 + q_offset - window));
  };
  int lo = 0;
  while (lo < nkt && !runs(lo)) ++lo;
  int hi = lo;
  while (hi < nkt && runs(hi)) ++hi;
  const int n_tiles = hi - lo;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(bar_q, 1);
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
      mbar_expect_tx(bar_q, S::Q_BYTES);
      for (int w = 0; w < NCONS; ++w)
        CQ::load(base + w * S::Q_PART, &tm_q, bar_q, h, q0 + 64 * w, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % STAGES;
        const int k0 = (lo + i) * BK;
        mbar_wait(bar_e + 8 * s, ((i / STAGES) & 1) ^ 1);
        mbar_expect_tx(bar_k + 8 * s, S::KV_BYTES);
        CK::load(base + S::K_OFF + s * S::KV_BYTES, &tm_k, bar_k + 8 * s, hk,
                 k0, b);
        mbar_expect_tx(bar_v + 8 * s, S::KV_BYTES);
        CK::load(base + S::V_OFF + s * S::KV_BYTES, &tm_v, bar_v + 8 * s, hk,
                 k0, b);
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
  const int qw0 = q0 + 64 * w;
  const float sl2 = scale * LOG2E;
  const uint32_t q_addr = base + w * S::Q_PART;

  // O's 64-column blocks, or its row of 80 over the 16-column tiles (40
  // floats: register j holds row r + 8 ((j / 2) % 2), column 8 (j / 4) +
  // c2 + j % 2)
  float o[CK::NB][32], ot[CK::NT];
#pragma unroll
  for (int cb = 0; cb < CK::NB; ++cb)
#pragma unroll
    for (int j = 0; j < 32; ++j) o[cb][j] = 0.f;
#pragma unroll
  for (int j = 0; j < CK::NT; ++j) ot[j] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float x[64];               // a tile's scores, then its p in f32
  uint32_t pa[BK / 16][4];   // p in bf16: P.V's A operand

  // Tile k0's scores in x: masks (only where the band, the window or the
  // end of the keys crosses the tile), scale, online softmax; x becomes
  // p in f32, l sums it, and corr is what O must be rescaled by.
  auto softmax = [&](int k0, float (&corr)[2]) {
    // register j holds row r + 8 ((j / 2) % 2), column 8 (j / 4) + c2 +
    // j % 2 of the tile
    const bool edge = k0 + BK > sk ||
                      (causal && k0 + BK - 1 > qw0 + q_offset) ||
                      (window && k0 <= qw0 + 63 + q_offset - window);
#pragma unroll
    for (int j = 0; j < 64; ++j) x[j] *= sl2;   // scale after the product
    if (edge) {
#pragma unroll
      for (int j = 0; j < 64; ++j) {
        const int kp = k0 + 8 * (j / 4) + c2 + (j % 2);
        const int qp = qw0 + r + 8 * ((j / 2) % 2) + q_offset;
        if (kp >= sk) {
          x[j] = -INFINITY;              // ragged tile: no key at all
        } else if ((causal && kp > qp) || (window && kp <= qp - window)) {
          x[j] = MASKED;                 // :81
        }
      }
    }
    float mx[2] = {m[0], m[1]}, sum[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 64; ++j)
      mx[(j / 2) % 2] = fmaxf(mx[(j / 2) % 2], x[j]);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      corr[rr] = exp2f(m[rr] - mx[rr]);
      m[rr] = mx[rr];
    }
#pragma unroll
    for (int j = 0; j < 64; ++j) {
      x[j] = exp2f(x[j] - m[(j / 2) % 2]);
      sum[(j / 2) % 2] += x[j];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = corr[rr] * l[rr] + sum[rr];
  };
  // O *= corr (a register's row is (j / 2) % 2 in either accumulator)
  auto rescale = [&](const float (&corr)[2]) {
#pragma unroll
    for (int cb = 0; cb < CK::B128; ++cb)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[cb][j] *= corr[(j / 2) % 2];
    if constexpr (CK::T32 != 0) {
#pragma unroll
      for (int j = 0; j < CK::NT; ++j) ot[j] *= corr[(j / 2) % 2];
    }
  };

  mbar_wait(bar_q, 0);
  __syncwarp();
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % STAGES;
    const uint32_t ph = (i / STAGES) & 1;
    float corr[2];
    mbar_wait(bar_k + 8 * s, ph);
    __syncwarp();
    clear(x);
    wgmma_fence();
    start_scores<D, BK>(x, q_addr, base + S::K_OFF + s * S::KV_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(x);
    softmax((lo + i) * BK, corr);
    rescale(corr);
    pack(x, pa);   // p rounded to bf16 pairs: the accumulator's layout
                   // is the A fragment's, 16 keys a step
    mbar_wait(bar_v + 8 * s, ph);
    __syncwarp();
    fence_acc<D, BK>(o, ot);
    wgmma_fence();
    start_update<D, BK>(o, ot, pa, base + S::V_OFF + s * S::KV_BYTES);
    wgmma_commit();
    wgmma_wait_all();
    fence_acc<D, BK>(o, ot);
    if (lane == 0) mbar_arrive(bar_e + 8 * s);   // the stage is free
  }

  // l: this thread's share of its rows' sums, summed over the quad
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
  }
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int row = qw0 + r + 8 * rr;
    if (row >= sq) continue;
    const float l_safe = l[rr] == 0.f ? 1.f : l[rr];   // :98
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow =
        out + ((size_t)b * sq + row) * hq * D + (size_t)h * D;
#pragma unroll
    for (int cb = 0; cb < CK::B128; ++cb)
#pragma unroll
      for (int g = 0; g < 8; ++g) {
        const int j = 4 * g + 2 * rr;
        *reinterpret_cast<uint32_t*>(orow + cb * 64 + 8 * g + c2) =
            pack_bf16(o[cb][j] * inv, o[cb][j + 1] * inv);
      }
#pragma unroll
    for (int g = 0; g < 2 * CK::T32; ++g) {   // the 16-column tiles
      const int j = 4 * g + 2 * rr;
      *reinterpret_cast<uint32_t*>(orow + 8 * g + c2) =
          pack_bf16(ot[j] * inv, ot[j + 1] * inv);
    }
    if (lane % 4 == 0)
      lse[((size_t)b * hq + h) * sq + row] = m[rr] * LN2 + logf(l_safe);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int sq, int sk, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  int rc = Cols<D, 64>::map(&mq, q, b, sq, hq);
  if (rc == 0) rc = Cols<D, BK>::map(&mk, k, b, sk, hkv);
  if (rc == 0) rc = Cols<D, BK>::map(&mv, v, b, sk, hkv);
  if (rc != 0) return rc;
  auto kern = flash_fwd_sm90_kernel<D>;
  const int smem = Smem<D>::ALLOC;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int nqt = (sq + BQ - 1) / BQ;
  kern<<<nqt * hq * b, NT, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(out), static_cast<float*>(lse),
      sq, sk, hq, hkv, causal, window, scale, nqt, hq * b);
  return (int)cudaGetLastError();
}

// 1 where this body takes the inputs: bf16 with head_dim 64, 80 or 128.
inline int takes(int is_bf16, int d) {
  return is_bf16 && (d == 64 || d == 80 || d == 128);
}

inline int dispatch(int d, const void* q, const void* k, const void* v,
                    void* out, void* lse, int b, int sq, int sk, int hq,
                    int hkv, int causal, int window, float scale,
                    cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<64>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal,
                        window, scale, stream);
    case 80:
      return launch<80>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal,
                        window, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal,
                         window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sm90
