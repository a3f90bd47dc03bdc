// The layout of an attention operand's rows in shared memory, and the
// products over it, shared by B6's Hopper body (flash_attention_sm90.cuh)
// and B7's and B8's (flash_attention_bwd_sm90.cuh): one layout of a row of
// head_dim D for every body, with the row count a parameter (B6 streams K
// and V in tiles of 128 rows, B7/B8 stream tiles of 64; every consumer
// holds 64 rows, wgmma's M).
//
// Head_dim 64 and 128 lie as 64-column blocks with the 128-byte swizzle.
// A bf16 row of 80 (hubert-xlarge: 16 heads of 80) is 160 bytes, no
// multiple of the 128-byte swizzle, so it lies as five 16-column tiles
// with the 32-byte swizzle, each loaded as a 16-column TMA box: five
// K-major steps for a product over the depth, and one m64n80k16 product a
// step of 16 rows for an output of width 80, its B operand the five tiles
// read MN-major (the descriptor's leading offset from tile to tile). That
// is exactly the head_dim-80 work, 40 accumulator floats a thread per
// output. On an H100 at hubert-xlarge's training layer it beat both a
// 64-column block plus a 16-column tail and a row padded to 128 by TMA's
// zero fill, B7 and B8 together (PERF.md).
#pragma once

#include <cuda.h>
#include <stdint.h>

#include "sm90_primitives.cuh"   // TMA, mbarriers, wgmma, tensor maps

namespace sm90 {

// R rows (64 or 128) of one bf16 operand of head_dim D: B128 blocks of 64
// columns (PART bytes each) or T32 tiles of 16 columns (TPART bytes each).
// Each block or tile is one TMA box of BOX columns with SWIZZLE; BYTES,
// PART and TPART are multiples of 1024, so every block and tile stays
// 1024-byte aligned. NB and NT size a thread's accumulators of a product
// of width D: NB blocks of 32 floats (N = 64 each) or NT floats over the
// tiles (N = 80 in one product); one float where there are none.
template <int D, int R>
struct Cols {
  static_assert(D == 64 || D == 80 || D == 128,
                "a head_dim the Hopper bodies lay out");
  static_assert(R == 64 || R == 128, "a row count the Hopper bodies use");
  static constexpr int B128 = D % 64 == 0 ? D / 64 : 0;
  static constexpr int T32 = D % 64 == 0 ? 0 : D / 16;
  static constexpr int PART = R * 128;   // R rows of one 64-column block
  static constexpr int TPART = R * 32;   // R rows of one 16-column tile
  static constexpr int BYTES = B128 * PART + T32 * TPART;
  static constexpr int NB = B128 > 0 ? B128 : 1;
  static constexpr int NT = T32 > 0 ? 8 * T32 : 1;
  static constexpr int BOX = T32 > 0 ? 16 : 64;
  static constexpr CUtensorMapSwizzle SWIZZLE =
      T32 > 0 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B;

  // The K-major descriptor of step kk (16 columns) of the depth: 32 B on
  // inside a 128-byte row, 4 steps a block; or the next tile.
  __device__ static __forceinline__ uint64_t kmajor(uint32_t addr, int kk) {
    if constexpr (T32 == 0)
      return desc_sw128(addr + (kk / 4) * PART + (kk % 4) * 32, 16);
    else
      return desc_sw32(addr + kk * TPART);
  }

  // The MN-major descriptor of rows [16 kk, 16 kk + 16) as the B operand
  // of a product of N = 64 over block cb (16 rows are 2,048 B), or of
  // N = 80 over the five tiles (cb unused; 16 rows are 512 B, and the
  // leading offset is one tile, TPART: 4,096 B at 128 rows, 2,048 at 64).
  __device__ static __forceinline__ uint64_t mnmajor(uint32_t addr, int cb,
                                                     int kk) {
    if constexpr (T32 == 0)
      return desc_sw128(addr + cb * PART + kk * 16 * 128, 1024);
    else
      return desc_sw32(addr + kk * 16 * 32, TPART);
  }

  // Loads rows [row0, row0 + R) of head `head` of sequence b at dst, one
  // box a block or tile, completing on bar.
  __device__ static __forceinline__ void load(uint32_t dst,
                                              const CUtensorMap* m,
                                              uint32_t bar, int head,
                                              int row0, int b) {
    for (int cb = 0; cb < B128; ++cb)
      tma_load(dst + cb * PART, m, bar, cb * 64, head, row0, b);
    for (int t = 0; t < T32; ++t)
      tma_load(dst + t * TPART, m, bar, 16 * t, head, row0, b);
  }

  // The map of a contiguous (b, s, heads, D) bf16 array with this
  // layout's boxes.
  static int map(CUtensorMap* m, const void* ptr, int b, int s, int heads) {
    return make_map(m, ptr, b, s, heads, D, R, BOX, SWIZZLE);
  }
};

// S (64 x R f32) = A.B^T over D, started: A's 64 rows and B's R rows
// K-major in shared memory in Cols' layout, D / 16 steps.
template <int D, int R>
__device__ __forceinline__ void start_scores(float (&s)[R / 2], uint32_t a,
                                             uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint64_t da = Cols<D, 64>::kmajor(a, kk);
    const uint64_t db = Cols<D, R>::kmajor(b, kk);
    if constexpr (R == 128)
      wgmma_ss_n128(s, da, db, kk > 0);
    else
      wgmma_ss_n64(s, da, db, kk > 0);
  }
}

// acc (the blocks) or tail (the tiles) += P.B, started: P (64 x R bf16) as
// A fragments of 16 columns, B's R rows in shared memory in Cols' layout
// read MN-major, R / 16 steps.
template <int D, int R>
__device__ __forceinline__ void start_update(
    float (&acc)[Cols<D, R>::NB][32], float (&tail)[Cols<D, R>::NT],
    const uint32_t (&pa)[R / 16][4], uint32_t b) {
  using C = Cols<D, R>;
#pragma unroll
  for (int kk = 0; kk < R / 16; ++kk) {
    if constexpr (C::T32 == 0) {
#pragma unroll
      for (int cb = 0; cb < C::B128; ++cb)
        wgmma_rs_n64(acc[cb], pa[kk], C::mnmajor(b, cb, kk));
    } else {
      wgmma_rs_n80(tail, pa[kk], C::mnmajor(b, 0, kk));
    }
  }
}

// Orders the accumulators' registers around the asynchronous products.
template <int D, int R>
__device__ __forceinline__ void fence_acc(float (&acc)[Cols<D, R>::NB][32],
                                          float (&tail)[Cols<D, R>::NT]) {
#pragma unroll
  for (int cb = 0; cb < Cols<D, R>::B128; ++cb) fence_regs(acc[cb]);
  if constexpr (Cols<D, R>::T32 != 0) fence_regs(tail);
}

// An accumulator of 64 x N f32 rounded to bf16 A fragments: register j
// holds row r + 8 ((j / 2) % 2), column 8 (j / 4) + c2 + j % 2, which is
// the A fragment's layout, 16 columns a step.
template <int N>
__device__ __forceinline__ void pack(const float (&x)[N],
                                     uint32_t (&pa)[N / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    pa[kk][0] = pack_bf16(x[8 * kk], x[8 * kk + 1]);      // row r
    pa[kk][1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);  // row r + 8
    pa[kk][2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);  // row r, + 8
    pa[kk][3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);  // r + 8, + 8
  }
}

template <int N>
__device__ __forceinline__ void clear(float (&x)[N]) {
#pragma unroll
  for (int j = 0; j < N; ++j) x[j] = 0.f;
  fence_regs(x);
}

}  // namespace sm90
