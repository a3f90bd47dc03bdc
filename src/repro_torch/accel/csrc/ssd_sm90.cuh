// B10's Hopper body: the Mamba-2 SSD chunked scan for bf16 inputs with
// head_dim and d_state each 64 or 128 and chunks of 64 to 256 rows in
// steps of 64, on wgmma tensor-core products over TMA-fed tiles. Included
// by ssd.cu, whose C entry point ssd_fwd_tc runs it for exactly those
// inputs (ssd_tc); ssd_fwd runs the SIMT body for the others.
//
// Replaces src/repro/kernels/ssd/ssd.py:29 `_ssd_kernel` (its pallas_call
// at :105) for those inputs.
//
// What bounds it on an H100: at Mamba2-2.7B's layer (b 4, s 2,048, 80
// heads of 64, one group, d_state 128, chunk 256) the scan must read x,
// dt, B, C and write y and the state, about 185 MB, 0.055 ms at 3.35
// TB/s; its products are about 32.5 GFLOP with C.B^T counted once per
// group, 0.033 ms at the bf16 tensor-core rate. The SIMT body walked the
// chunks of each (sequence, head) in order with every product as f32 FMAs
// on the CUDA cores and C.B^T recomputed for each of the 80 heads of the
// group (about 21 GFLOP of it): 5.49 ms, 99x its bound (PERF.md).
//
// Design (the chunked algorithm of Mamba-2's SSD, arXiv:2405.21060), three
// kernels on the stream, no atomics, every sum in a fixed order, so the
// same inputs give the same bits:
//   1. ssd_prep_kernel, a block per (64-row tile i of a chunk, chunk,
//      group, sequence): the chunk cumsum a_cs of dt * A for its share of
//      the group's heads, one thread a head, rows in order (each product
//      and sum rounded on its own, as the plain version), dt staged in
//      shared memory, and a_cs, dt and w_s = dt_s exp(total - a_cs[s])
//      written as (b, h, chunk, Q) rows; then
//      C.B^T of row tile i against column tiles j <= i, once for the
//      group, as SS m64n64k16 with both operands K-major, written in the
//      accumulator's register order (four registers of every thread, then
//      the next four), so that step 3 reads its fragments with 16-byte
//      loads, 512 contiguous bytes a warp.
//   2. ssd_state_kernel, a block per (head, 64-row block of head_dim,
//      sequence): each chunk's local state S_c^T = (x w)^T . B, w_s =
//      dt_s exp(total - a_cs[s]), over 32-row tiles streamed through a
//      3-stage TMA ring (w from step 1, loaded a chunk ahead), with the
//      state pass in chunk order in the same registers: at a chunk's
//      start the state is scaled by exp(total)
//      and the chunk's products accumulate into it (float32), so no chunk
//      state goes to memory; the state entering each chunk after the
//      first is written as a bf16 pair (hi, lo), through shared memory as
//      whole rows (the fragments' scattered 4-byte stores cost half the
//      kernel's time on an H100: PERF.md), the final one into
//      `state` (out_state). The threads multiply each tile of x by w in
//      place in shared memory; the product is SS m64n64k16 with both
//      operands MN-major (x's and B's rows as they arrive). (The chunks
//      in parallel, with each chunk's state through memory and a separate
//      pass, measured slower on an H100: PERF.md.)
//   3. ssd_out_kernel, a block per (64-row tile of a chunk, head, chunk,
//      sequence), the chunks in parallel: y = exp(a_cs[l]) C_l . state_in
//      (SS, both K-major) + sum over column tiles j <= i of P . x_j (RS: P
//      in registers, x MN-major as B6's V) + D x, with P = (C.B^T)
//      exp(a_cs[l] - a_cs[s]) dt_s; exp is taken only where s <= l (the
//      exponent is positive above the diagonal and can overflow, which
//      is why the oracle masks before exp). C and the state land on one
//      mbarrier, x's tiles stream through two slots on two more, and the
//      next column tile's C.B^T fragment loads while this one is used; the
//      first chunk loads no C. (A block per (chunk, head) with two
//      warpgroups taking row tiles in pairs, and two heads a block in
//      step 2, read fewer bytes from L2 and measured slower on an H100:
//      PERF.md.)
// Rounding: each operand the kernel computes and then hands to the
// tensor cores, the weighted x, the scores P and the state entering a
// chunk, goes in as a bf16 pair: hi = bf16(v), lo = bf16(v - hi), two
// products. |P| and the state reach tens, so one bf16 rounding would move
// y by more than bf16 2e-2 wherever the kernel's float32 sums differ
// from the plain version's in the last bit; the pair keeps v to about
// 2^-16. ssd_tc_plain (kernels/ssd/ssd.py) rounds at exactly these
// places. Ragged chunks: the rank-4 tensor maps zero-fill rows past s
// within the sequence (dt = 0 there, the oracle's padding, the
// identity), and rows past s are never written. A thread of the block
// (or of a warpgroup) issues the TMA loads.
// expf for the cumsum's weights and decays; the scores' exp is exp2f of
// the difference times log2(e), within a few units in the last place of
// expf (the pair keeps P to about 2^-16); built without -use_fast_math.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90_primitives.cuh"   // TMA, mbarriers, wgmma, tensor maps

namespace ssd90 {

constexpr int TQ = 64;           // rows of a tile: wgmma's M, one TMA box
constexpr int NT = 128;          // one warpgroup a block
constexpr int ROW = 128;         // bytes of one swizzled row: 64 bf16
constexpr int TILE = TQ * ROW;   // 64 rows x 64 columns of bf16
constexpr int MAXQ = 256;        // largest chunk
constexpr int SUB = 32;          // rows of a state-kernel tile
constexpr int SUBT = SUB * ROW;  // 32 rows x 64 columns of bf16
constexpr int STAGES = 3;        // state-kernel tiles in flight
constexpr int KB = 32;           // heads of one cumsum batch
constexpr float LOG2E = 1.4426950408889634f;

__host__ __device__ constexpr int tri(int n) { return n * (n + 1) / 2; }

// 1 where this body takes the inputs.
inline int takes(int is_bf16, int p, int n, int Q) {
  return is_bf16 && (p == 64 || p == 128) && (n == 64 || n == 128) &&
         Q % TQ == 0 && Q >= TQ && Q <= MAXQ;
}

__device__ __forceinline__ uint32_t aligned(uint8_t* raw) {
  return (sm90::smem_u32(raw) + 1023u) & ~1023u;
}

__device__ __forceinline__ void init_bars(uint32_t bar, int count) {
  for (int s = 0; s < count; ++s) sm90::mbar_init(bar + 8 * s, 1);
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Register j of a m64n64 accumulator holds row r + 8 ((j / 2) % 2) and
// column 8 (j / 4) + c2 + j % 2, with r = 16 warp + lane / 4 and c2 =
// 2 (lane % 4).
__device__ __forceinline__ int acc_row(int j) { return 8 * ((j / 2) % 2); }
__device__ __forceinline__ int acc_col(int j) { return 8 * (j / 4) + j % 2; }

// (hi, lo) of v: hi = bf16(v), lo = bf16(v - hi), packed in pairs.
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(__fsub_rn(v0, hf.x), __fsub_rn(v1, hf.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int N>
struct PrepSmem {   // C's row tile, B's rows, dt and a_cs batches, barrier
  static constexpr int NB = N / 64;
  static constexpr int B_OFF = NB * TILE;
  static constexpr int D_OFF = B_OFF + NB * MAXQ * ROW;
  static constexpr int A_OFF = D_OFF + MAXQ * (KB + 1) * 4;
  static constexpr int BAR = A_OFF + MAXQ * (KB + 1) * 4;
  static constexpr int ALLOC = BAR + 8 + 1024;
};

template <int N>
__global__ void __launch_bounds__(NT)
ssd_prep_kernel(const __grid_constant__ CUtensorMap tm_c,
                const __grid_constant__ CUtensorMap tm_b,
                const float* __restrict__ dt, const float* __restrict__ A,
                float* __restrict__ a_cs, float* __restrict__ dtp,
                float* __restrict__ wts, float* __restrict__ cb, int S,
                int H, int G, int Q, int nc) {
  using L = PrepSmem<N>;
  constexpr int NB = L::NB, KP = KB + 1;   // a batch's padded row
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  float* sD = reinterpret_cast<float*>(gbase + L::D_OFF);
  float* sA = reinterpret_cast<float*>(gbase + L::A_OFF);
  const uint32_t bar = base + L::BAR;
  const int i = blockIdx.x, c = blockIdx.y / G, g = blockIdx.y % G;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int nt = Q / TQ, c0 = c * Q, qv = min(Q, S - c0), hg = H / G;

  // the cumsum of this block's heads g hg + [k0, k1), in batches of KB:
  // dt staged (rows past s are 0), one thread a head walks the rows in
  // order, then a_cs, dt and the state weights w = dt exp(total - a_cs)
  // written row by row
  const int per = (hg + nt - 1) / nt;
  const int k1 = min((i + 1) * per, hg);
  for (int kb = i * per; kb < k1; kb += KB) {
    const int nk = min(KB, k1 - kb), h0 = g * hg + kb;
    for (int e = tid; e < Q * nk; e += NT) {
      const int r = e / nk, k = e % nk;
      sD[r * KP + k] =
          r < qv ? dt[((size_t)b * S + c0 + r) * H + h0 + k] : 0.f;
    }
    __syncthreads();
    if (tid < nk) {
      const float a = A[h0 + tid];
      float run = 0.f;
      for (int r = 0; r < Q; ++r) {
        run = __fadd_rn(run, __fmul_rn(sD[r * KP + tid], a));
        sA[r * KP + tid] = run;
      }
    }
    __syncthreads();
    for (int e = tid; e < Q * nk; e += NT) {
      const int k = e / Q, r = e % Q;
      const size_t at = (((size_t)b * H + h0 + k) * nc + c) * Q + r;
      const float total = sA[(Q - 1) * KP + k];
      a_cs[at] = sA[r * KP + k];
      dtp[at] = sD[r * KP + k];
      wts[at] = __fmul_rn(sD[r * KP + k],
                          expf(__fsub_rn(total, sA[r * KP + k])));
    }
    __syncthreads();
  }
  const int l0 = i * TQ;
  if (l0 >= qv) return;   // rows all past s: no output reads these scores

  if (tid == 0) init_bars(bar, 1);
  __syncthreads();
  if (tid == 0) {
    sm90::mbar_expect_tx(bar, NB * TILE * (i + 2));
    for (int nb = 0; nb < NB; ++nb) {
      sm90::tma_load(base + nb * TILE, &tm_c, bar, nb * 64, g, c0 + l0, b);
      for (int j = 0; j <= i; ++j)
        sm90::tma_load(base + L::B_OFF + (nb * MAXQ + j * TQ) * ROW, &tm_b,
                       bar, nb * 64, g, c0 + j * TQ, b);
    }
  }
  sm90::mbar_wait(bar, 0);
  __syncwarp();
  float4* out = reinterpret_cast<float4*>(
      cb + ((((size_t)b * nc + c) * G + g) * tri(nt) + tri(i)) * (TQ * TQ));
  for (int j = 0; j <= i; ++j) {
    float d[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) d[e] = 0.f;
    sm90::fence_regs(d);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      sm90::wgmma_ss_n64(
          d, sm90::desc_sw128(base + (kk / 4) * TILE + off, 16),
          sm90::desc_sw128(base + L::B_OFF + ((kk / 4) * MAXQ + j * TQ) *
                                              ROW + off, 16),
          kk > 0);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    sm90::fence_regs(d);
    // registers 4 q .. 4 q + 3 of every thread, then 4 q + 4 ..: a warp's
    // 16-byte loads of one q are 512 contiguous bytes
    float4* dst = out + (size_t)j * (TQ * TQ / 4);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      dst[q * NT + tid] = make_float4(d[4 * q], d[4 * q + 1], d[4 * q + 2],
                                      d[4 * q + 3]);
  }
}

template <int N>
struct StateSmem {   // STAGES x [x rows, then hi | lo of x w | B rows],
                     // the state's staging rows, w, barriers
  static constexpr int NB = N / 64;
  static constexpr int STAGE = 2 * SUBT + NB * SUBT;
  static constexpr int OUT_OFF = STAGES * STAGE;   // 64 rows x N bf16
  static constexpr int W_OFF = OUT_OFF + NB * TILE;
  static constexpr int BAR = W_OFF + MAXQ * 4;
  static constexpr int ALLOC = BAR + 8 * STAGES + 1024;
};

// The 8 bf16 values of v times w: hi = bf16(v w) in v, lo = bf16(v w - hi)
// in lo, each product rounded to float32 first.
__device__ __forceinline__ void split_scaled(uint4& v, uint4& lo, float w) {
  uint32_t* hv = reinterpret_cast<uint32_t*>(&v);
  uint32_t* lv = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 f = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&hv[e]));
    split2(__fmul_rn(f.x, w), __fmul_rn(f.y, w), hv[e], lv[e]);
  }
}

template <int P, int N>
__global__ void __launch_bounds__(NT)
ssd_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                 const __grid_constant__ CUtensorMap tm_b,
                 const float* __restrict__ a_cs,
                 const float* __restrict__ wts,
                 __nv_bfloat16* __restrict__ st_in,
                 float* __restrict__ state, int S, int H, int G, int Q,
                 int nc) {
  using L = StateSmem<N>;
  constexpr int NB = L::NB, PB = P / 64;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  float* sW = reinterpret_cast<float*>(gbase + L::W_OFF);
  uint8_t* sout = gbase + L::OUT_OFF;
  const uint32_t bar = base + L::BAR;   // + 8 * stage
  const int h = blockIdx.x / PB, pb = blockIdx.x % PB, b = blockIdx.y;
  const int g = h / (H / G), tid = threadIdx.x;
  const int U = (S + SUB - 1) / SUB;     // tiles; Q is a multiple of SUB
  const CUtensorMap* map_x = &tm_x;
  const CUtensorMap* map_b = &tm_b;
  auto load = [&](int st, int u) {
    const uint32_t dst = base + st * L::STAGE, full = bar + 8 * st;
    sm90::mbar_expect_tx(full, SUBT + NB * SUBT);
    sm90::tma_load(dst, map_x, full, pb * 64, h, u * SUB, b);
    for (int nb = 0; nb < NB; ++nb)
      sm90::tma_load(dst + (2 + nb) * SUBT, map_b, full, nb * 64, g,
                     u * SUB, b);
  };
  if (tid == 0) {
    init_bars(bar, STAGES);
    for (int u = 0; u < min(STAGES, U); ++u) load(u, u);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  const size_t part = (size_t)P * N;
  // the state, rows 64 pb + r (+ 8) of head_dim; each chunk's products
  // accumulate into it after it is scaled by the chunk's decay
  float st[NB][32];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 32; ++e) st[nb][e] = 0.f;
  }
  // a chunk's weights (rows tid, tid + NT, ...) and total, loaded a chunk
  // ahead so that their latency hides behind the chunk before
  constexpr int WR = MAXQ / NT;
  const float* wrow = wts + ((size_t)b * H + h) * nc * Q;
  const float* arow = a_cs + ((size_t)b * H + h) * nc * Q;
  float w_next[WR], total_next = arow[Q - 1];
#pragma unroll
  for (int k = 0; k < WR; ++k)
    w_next[k] = tid + k * NT < Q ? wrow[tid + k * NT] : 0.f;
  for (int u = 0; u < U; ++u) {
    const int c = u * SUB / Q, t0 = u * SUB - c * Q;
    if (t0 == 0) {   // chunk c starts
      if (c > 0) {   // the state entering it, as (hi, lo), each part
                     // through the staging rows and out as 16-byte rows
        __nv_bfloat16* dst =
            st_in + (((size_t)b * nc + c) * H + h) * 2 * part;
        for (int half = 0; half < 2; ++half) {
#pragma unroll
          for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
            for (int e = 0; e < 32; e += 2) {
              uint32_t hl[2];
              split2(st[nb][e], st[nb][e + 1], hl[0], hl[1]);
              const int row = r + acc_row(e), col = 64 * nb + acc_col(e) + c2;
              *reinterpret_cast<uint32_t*>(sout + row * (N * 2) +
                                           (((col / 8) ^ (row % 8)) * 16) +
                                           (col % 8) * 2) = hl[half];
            }
          }
          __syncthreads();
          for (int q = tid; q < 64 * (N / 8); q += NT) {
            const int row = q / (N / 8), cq = q % (N / 8);
            *reinterpret_cast<uint4*>(
                dst + half * part + (size_t)(64 * pb + row) * N + cq * 8) =
                *reinterpret_cast<const uint4*>(
                    sout + row * (N * 2) + ((cq ^ (row % 8)) * 16));
          }
          __syncthreads();
        }
      }
      const float decay = expf(total_next);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
        for (int e = 0; e < 32; ++e) st[nb][e] = __fmul_rn(st[nb][e], decay);
      }
      // sW's last readers passed the previous tile's closing barrier
#pragma unroll
      for (int k = 0; k < WR; ++k)
        if (tid + k * NT < Q) sW[tid + k * NT] = w_next[k];
      if (c + 1 < nc) {
        total_next = arow[(size_t)(c + 1) * Q + Q - 1];
#pragma unroll
        for (int k = 0; k < WR; ++k)
          w_next[k] = tid + k * NT < Q
                          ? wrow[(size_t)(c + 1) * Q + tid + k * NT] : 0.f;
      }
      __syncthreads();   // sW (and, the first time, the barriers)
    }
    const int stg = u % STAGES;
    sm90::mbar_wait(bar + 8 * stg, (u / STAGES) & 1);
    // x w as (hi, lo) in place: 16-byte chunk q of the x tile lies in
    // row q / 8
    uint8_t* sx = gbase + stg * L::STAGE;
    for (int q = tid; q < SUB * 8; q += NT) {
      uint4 v = *reinterpret_cast<const uint4*>(sx + q * 16), lo;
      split_scaled(v, lo, sW[t0 + q / 8]);
      *reinterpret_cast<uint4*>(sx + q * 16) = v;
      *reinterpret_cast<uint4*>(sx + SUBT + q * 16) = lo;
    }
    sm90::fence_proxy_async();
    __syncthreads();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sm90::fence_regs(st[nb]);
    sm90::wgmma_fence();
    const uint32_t ax = base + stg * L::STAGE;
#pragma unroll
    for (int kk = 0; kk < SUB / 16; ++kk) {
      const uint32_t off = kk * 16 * ROW;
      const uint64_t dhi = sm90::desc_sw128(ax + off, 1024);
      const uint64_t dlo = sm90::desc_sw128(ax + SUBT + off, 1024);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const uint64_t db =
            sm90::desc_sw128(ax + (2 + nb) * SUBT + off, 1024);
        sm90::wgmma_ss_n64_mn(st[nb], dhi, db, 1);
        sm90::wgmma_ss_n64_mn(st[nb], dlo, db, 1);
      }
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) sm90::fence_regs(st[nb]);
    __syncthreads();   // every product has read this stage
    if (tid == 0 && u + STAGES < U) load(stg, u + STAGES);
  }
  float* out = state + ((size_t)b * H + h) * part;
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) {
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int row = 64 * pb + r + acc_row(e);
      const int col = 64 * nb + acc_col(e) + c2;
      *reinterpret_cast<float2*>(out + (size_t)row * N + col) =
          make_float2(st[nb][e], st[nb][e + 1]);
    }
  }
}

template <int P, int N>
struct OutSmem {   // C's row tile, 2 slots of x tiles, the state (hi, lo),
                   // a_cs, dt, barriers
  static constexpr int NB = N / 64, PB = P / 64;
  static constexpr int X_OFF = NB * TILE;
  static constexpr int ST_OFF = X_OFF + 2 * PB * TILE;
  static constexpr int ST_PART = NB * P * ROW;   // hi, then lo
  static constexpr int A_OFF = ST_OFF + 2 * ST_PART;
  static constexpr int BAR = A_OFF + 2 * MAXQ * 4;
  static constexpr int ALLOC = BAR + 24 + 1024;
};

template <int P, int N>
__global__ void __launch_bounds__(NT)
ssd_out_kernel(const __grid_constant__ CUtensorMap tm_c,
               const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_st,
               const float* __restrict__ a_cs, const float* __restrict__ dtp,
               const float* __restrict__ cb, const float* __restrict__ Dv,
               __nv_bfloat16* __restrict__ y, int S, int H, int G, int Q,
               int nc) {
  using L = OutSmem<P, N>;
  constexpr int NB = L::NB, PB = L::PB;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = aligned(smem_raw);
  uint8_t* gbase = smem_raw + (base - sm90::smem_u32(smem_raw));
  float* sA = reinterpret_cast<float*>(gbase + L::A_OFF);
  float* sDt = sA + MAXQ;
  // C and the state on bar_cs; x tile j in slot j % 2, on bar_x + 8 (j % 2)
  const uint32_t bar_cs = base + L::BAR, bar_x = bar_cs + 8;
  const int nt = Q / TQ;
  const int i = blockIdx.x % nt, h = blockIdx.x / nt, c = blockIdx.y;
  const int b = blockIdx.z, tid = threadIdx.x;
  const int g = h / (H / G), c0 = c * Q, qv = min(Q, S - c0), l0 = i * TQ;
  if (l0 >= qv) return;   // every row past s
  const CUtensorMap* map_x = &tm_x;
  auto load_x = [&](int j) {
    const uint32_t full = bar_x + 8 * (j % 2);
    sm90::mbar_expect_tx(full, PB * TILE);
    for (int pb = 0; pb < PB; ++pb)
      sm90::tma_load(base + L::X_OFF + ((j % 2) * PB + pb) * TILE, map_x,
                     full, pb * 64, h, c0 + j * TQ, b);
  };
  if (tid == 0) {
    init_bars(bar_cs, 3);
    if (c > 0) {   // C's row tile and the state entering the chunk
      sm90::mbar_expect_tx(bar_cs, NB * TILE + 2 * L::ST_PART);
      for (int nb = 0; nb < NB; ++nb)
        sm90::tma_load(base + nb * TILE, &tm_c, bar_cs, nb * 64, g, c0 + l0,
                       b);
      for (int part = 0; part < 2; ++part)
        for (int nb = 0; nb < NB; ++nb)
          for (int pb = 0; pb < PB; ++pb)
            sm90::tma_load(base + L::ST_OFF + part * L::ST_PART +
                               (nb * P + pb * 64) * ROW,
                           &tm_st, bar_cs, nb * 64, 0, pb * 64,
                           (((b * nc + c) * H + h) * 2 + part));
    }
    for (int j = 0; j <= min(i, 1); ++j) load_x(j);
  }
  // C.B^T fragments of row tile i: tile jt's 32 floats of this thread,
  // the next one loaded while this one is used
  const float4* cbt = reinterpret_cast<const float4*>(
      cb + ((((size_t)b * nc + c) * G + g) * tri(nt) + tri(i)) * (TQ * TQ)) +
      tid;
  float4 next[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) next[q] = cbt[q * NT];
  const size_t at = (((size_t)b * H + h) * nc + c) * Q;
  for (int q = tid; q < Q; q += NT) {
    sA[q] = a_cs[at + q];
    sDt[q] = dtp[at + q];
  }
  __syncthreads();   // sA, sDt and the barriers

  const int warp = tid / 32, lane = tid % 32;
  const int r = 16 * warp + lane / 4, c2 = 2 * (lane % 4);
  float acc[PB][32];
#pragma unroll
  for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[pb][e] = 0.f;
    sm90::fence_regs(acc[pb]);
  }
  if (c > 0) {   // exp(a_cs[l]) C_l . (hi + lo) (the first chunk's is 0)
    sm90::mbar_wait(bar_cs, 0);
    __syncwarp();
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;
      const uint64_t da = sm90::desc_sw128(base + (kk / 4) * TILE + off, 16);
#pragma unroll
      for (int part = 0; part < 2; ++part)
#pragma unroll
        for (int pb = 0; pb < PB; ++pb)
          sm90::wgmma_ss_n64(
              acc[pb], da,
              sm90::desc_sw128(base + L::ST_OFF + part * L::ST_PART +
                                   ((kk / 4) * P + pb * 64) * ROW + off,
                               16),
              1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
    const float e0 = expf(sA[l0 + r]), e1 = expf(sA[l0 + r + 8]);
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) {
      sm90::fence_regs(acc[pb]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[pb][e] *= acc_row(e) ? e1 : e0;
    }
  }
  for (int jt = 0; jt <= i; ++jt) {
    float w[32];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      w[4 * q] = next[q].x; w[4 * q + 1] = next[q].y;
      w[4 * q + 2] = next[q].z; w[4 * q + 3] = next[q].w;
    }
    if (jt < i) {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        next[q] = cbt[(jt + 1) * (TQ * TQ / 4) + q * NT];
    }
    // P = (C.B^T) exp(a_cs[l] - a_cs[s]) dt_s where s <= l, else 0; exp
    // as exp2 of the difference times log2(e) (MUFU.EX2: a few units in
    // the last place of expf, below the pair's resolution)
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int lr = r + acc_row(e), sc = acc_col(e) + c2;
      const int l = l0 + lr, s = jt * TQ + sc;
      w[e] = (jt < i || sc <= lr)
                 ? w[e] * exp2f((sA[l] - sA[s]) * LOG2E) * sDt[s]
                 : 0.f;
    }
    // P as bf16 pairs (hi, lo): the A operand, 16 columns a step
    uint32_t ph[TQ / 16][4], pl[TQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split2(w[8 * kk + 2 * q], w[8 * kk + 2 * q + 1], ph[kk][q],
               pl[kk][q]);
    sm90::mbar_wait(bar_x + 8 * (jt % 2), (jt / 2) & 1);
    __syncwarp();
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) sm90::fence_regs(acc[pb]);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TQ / 16; ++kk)
#pragma unroll
      for (int pb = 0; pb < PB; ++pb) {
        const uint64_t dx = sm90::desc_sw128(
            base + L::X_OFF + ((jt % 2) * PB + pb) * TILE + kk * 16 * ROW,
            1024);
        sm90::wgmma_rs_n64(acc[pb], ph[kk], dx);
        sm90::wgmma_rs_n64(acc[pb], pl[kk], dx);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait_all();
#pragma unroll
    for (int pb = 0; pb < PB; ++pb) sm90::fence_regs(acc[pb]);
    if (jt + 2 <= i) {   // the slot is free again: x tile jt + 2 into it
      __syncthreads();
      if (tid == 0) load_x(jt + 2);
    }
  }

  // y = acc + D x: x's tile i is still in its slot (the 128-byte swizzle
  // puts 16-byte chunk q of row l at chunk q ^ (l % 8)); y goes through
  // the slot in the same layout, then out as 16-byte rows
  const float dh = Dv[h];
  uint8_t* slot = gbase + L::X_OFF + (i % 2) * PB * TILE;
  uint32_t yv[PB][16];
#pragma unroll
  for (int pb = 0; pb < PB; ++pb)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int lr = r + 8 * rr;
#pragma unroll
      for (int gq = 0; gq < 8; ++gq) {
        const int j = 4 * gq + 2 * rr;
        const uint32_t off = pb * TILE + lr * ROW +
                             ((gq ^ (lr % 8)) * 16) + c2 * 2;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(slot + off));
        yv[pb][8 * rr + gq] = sm90::pack_bf16(acc[pb][j] + dh * xv.x,
                                              acc[pb][j + 1] + dh * xv.y);
      }
    }
  __syncthreads();   // every x read is done
#pragma unroll
  for (int pb = 0; pb < PB; ++pb)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int lr = r + 8 * rr;
#pragma unroll
      for (int gq = 0; gq < 8; ++gq)
        *reinterpret_cast<uint32_t*>(slot + pb * TILE + lr * ROW +
                                     ((gq ^ (lr % 8)) * 16) + c2 * 2) =
            yv[pb][8 * rr + gq];
    }
  __syncthreads();
  for (int q = tid; q < PB * TQ * 8; q += NT) {
    const int pb = q / (TQ * 8), lr = (q / 8) % TQ, cq = q % 8;
    if (l0 + lr >= qv) continue;
    *reinterpret_cast<uint4*>(
        y + (((size_t)b * S + c0 + l0 + lr) * H + h) * P + pb * 64 + cq * 8) =
        *reinterpret_cast<const uint4*>(slot + pb * TILE + lr * ROW +
                                        ((cq ^ (lr % 8)) * 16));
  }
}

template <typename K>
int set_smem(K kern, int bytes) {
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* state, void* a_cs,
           void* dtp, void* wts, void* cb, void* st_in, int b, int S, int H,
           int G, int Q, cudaStream_t stream) {
  const int nc = (S + Q - 1) / Q, nt = Q / TQ, PB = P / 64;
  CUtensorMap mx, mb, mc, mxs, mbs, mst;
  int rc = sm90::make_map(&mx, x, b, S, H, P, TQ);
  if (rc == 0) rc = sm90::make_map(&mc, C, b, S, G, N, TQ);
  if (rc == 0) rc = sm90::make_map(&mb, B, b, S, G, N, TQ);
  if (rc == 0) rc = sm90::make_map(&mxs, x, b, S, H, P, SUB);
  if (rc == 0) rc = sm90::make_map(&mbs, B, b, S, G, N, SUB);
  if (rc == 0) rc = sm90::make_map(&mst, st_in, b * nc * H * 2, P, 1, N, TQ);
  if (rc != 0) return rc;
  float* facs = static_cast<float*>(a_cs);
  float* fdtp = static_cast<float*>(dtp);
  float* fwts = static_cast<float*>(wts);
  float* fcb = static_cast<float*>(cb);

  auto k1 = ssd_prep_kernel<N>;
  if ((rc = set_smem(k1, PrepSmem<N>::ALLOC)) != 0) return rc;
  k1<<<dim3(nt, nc * G, b), NT, PrepSmem<N>::ALLOC, stream>>>(
      mc, mb, static_cast<const float*>(dt), static_cast<const float*>(A),
      facs, fdtp, fwts, fcb, S, H, G, Q, nc);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;

  auto k2 = ssd_state_kernel<P, N>;
  if ((rc = set_smem(k2, StateSmem<N>::ALLOC)) != 0) return rc;
  k2<<<dim3(H * PB, b), NT, StateSmem<N>::ALLOC, stream>>>(
      mxs, mbs, facs, fwts, static_cast<__nv_bfloat16*>(st_in),
      static_cast<float*>(state), S, H, G, Q, nc);
  if ((rc = (int)cudaGetLastError()) != 0) return rc;

  auto k3 = ssd_out_kernel<P, N>;
  if ((rc = set_smem(k3, OutSmem<P, N>::ALLOC)) != 0) return rc;
  k3<<<dim3(H * nt, nc, b), NT, OutSmem<P, N>::ALLOC, stream>>>(
      mc, mx, mst, facs, fdtp, fcb, static_cast<const float*>(D),
      static_cast<__nv_bfloat16*>(y), S, H, G, Q, nc);
  return (int)cudaGetLastError();
}

inline int dispatch(int p, int n, const void* x, const void* dt,
                    const void* A, const void* B, const void* C,
                    const void* D, void* y, void* state, void* a_cs,
                    void* dtp, void* wts, void* cb, void* st_in, int b,
                    int S, int H, int G, int Q, cudaStream_t st) {
#define SSD90_CASE(PP, NN)                                                  \
  if (p == PP && n == NN)                                                   \
    return launch<PP, NN>(x, dt, A, B, C, D, y, state, a_cs, dtp, wts, cb,  \
                          st_in, b, S, H, G, Q, st);
  SSD90_CASE(64, 64)
  SSD90_CASE(64, 128)
  SSD90_CASE(128, 64)
  SSD90_CASE(128, 128)
#undef SSD90_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace ssd90
