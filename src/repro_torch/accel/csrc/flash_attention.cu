// B6: GQA flash-attention forward for sm_90a (plain C interface, ctypes).
//
// Replaces src/repro/kernels/flash_attention/flash_attention.py:38
// `_fwd_kernel` (its pallas_call at :141, reached via `flash_attention_fwd`,
// :103): causal and/or sliding-window attention with q_offset = sk - sq,
// online softmax in float32, masked scores set to -1e30, fully masked
// tiles skipped, the l == 0 guard, out in q's type and lse in float32.
//
// Two bodies; the C entry point flash_fwd picks one from the dtype and
// head_dim alone, never from a failure:
//   - bf16 with head_dim 64, 80 or 128 (every attention layer of the
//     serving and training paths; 80 is hubert-xlarge's): the Hopper body
//     of flash_attention_sm90.cuh, wgmma tensor-core products on TMA-fed
//     tiles of 128 x 128, p rounded to bf16 before P.V (its note says why
//     and what bounds it);
//   - float32 at every head_dim, and bf16 with head_dim 16 or 32: the
//     SIMT body below, float32 FMAs on 64 x 64 tiles. It keeps the
//     reference's f32 arithmetic (q, k and v upcast before both dots, p
//     in f32); TF32 tensor cores would miss the f32 limits.
//
// The SIMT body. What bounds it on an H100: at the serving path's
// prefill shape (b 4, sq = sk = 2048, 32 query heads over 8 KV heads,
// head_dim 128, causal) the work is 2 b hq d sq (sq + 1) = 137.5 GFLOP
// against about 169 MB of traffic, so arithmetic bounds it; this body
// does not reach the tensor cores, so the f32 rate outside them (67
// TFLOP/s) does: about 5.30 ms there (PERF.md), which is why bf16 at
// head_dim 64, 80 and 128 takes the Hopper body.
//
// Design. One block of 256 threads per (query tile of 64 rows, query
// head, batch). The block loops over KV tiles of 64 keys staged in
// shared memory as float32; that loop replaces the TPU's sequential grid
// dimension (flash_attention.py:42-44). Each thread loads its share of a
// tile as 16-byte vectors into registers one tile ahead, so the next
// tile's loads are in flight while this one is computed (element loads at
// the point of use took 5.971 ms at the prefill shape, against 5.30 ms
// now, on an H100 80GB HBM3 at 700 W; PERF.md). The online-softmax state
// m, l and the output accumulator live in registers across it. Thread
// (ty, tx) of a 16 x 16 layout owns query rows ty + 16 i and key
// columns tx + 16 j (i, j < 4) of the score tile, and output columns
// tx + 16 c (c < D / 16); a row's 16 owners are one half-warp, so its
// max and sum are shuffles. Tiles fully masked by the causal band or the
// window are skipped with the reference's conditions (:58-63, with this
// kernel's tile sizes). Inside a tile, masked scores are -1e30 exactly as
// at :81; keys past sk (a ragged last tile, which the reference cannot
// have since it asserts divisibility) are -inf and so weigh exactly 0,
// and query rows past sq are computed on zeros and not written.
// Query head h reads KV head h / (hq / hkv), as the reference's index
// map does (:146). A row with no unmasked key in its unskipped tiles
// gets the mean of those tiles' V (masked scores are finite), where the
// reference oracle gives NaN; callers avoid such rows (both bodies).
// expf/logf, not the fast intrinsics; built without -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "flash_attention_sm90.cuh"
#include "flash_tiles.cuh"

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BK = 64;    // keys per staged tile
constexpr int NT = 256;   // threads per block (16 x 16)

__device__ __forceinline__ float half_warp_max(float x) {
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_floats() {
  // Q and K with a padded row (no bank conflicts), V, P with a padded row
  return (size_t)BQ * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)BQ * (BK + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int sq, int sk, int hq, int hkv,
                 int causal, int window, float scale) {
  static_assert(D % 16 == 0, "head_dim must be a multiple of 16");
  constexpr int DP = D + 1, PP = BK + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ, q_offset = sk - sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;

  {
    Tile<T, BQ, D, NT> tq;
    tq.fetch(qb, q_row, q0, sq, tid);
    tq.template stash<DP>(sQ, tid);
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // The reference's static skips (flash_attention.py:58-63): the causal
  // band ends the tiles that run, the window starts them, so they are one
  // range [lo, hi), the same for the whole block.
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

  // K and V tiles travel in registers: the next tile's loads are in
  // flight while this tile is computed.
  Tile<T, BK, D, NT> tk, tv;
  if (lo < hi) {
    tk.fetch(kb, kv_row, lo * BK, sk, tid);
    tv.fetch(vb, kv_row, lo * BK, sk, tid);
  }
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    tk.template stash<DP>(sK, tid);
    tv.template stash<D>(sV, tid);
    __syncthreads();
    if (kt + 1 < hi) {
      tk.fetch(kb, kv_row, k0 + BK, sk, tid);
      tv.fetch(vb, kv_row, k0 + BK, sk, tid);
    }

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      float qa[4], ka[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty + 16 * i) * DP + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) ka[j] = sK[(tx + 16 * j) * DP + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty + 16 * i + q_offset;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        float x = s[i][j] * scale;  // scale after the f32 product (:70-72)
        if (kp >= sk) {
          x = -INFINITY;            // ragged tile: no key at all
        } else {
          bool keep = true;
          if (causal) keep = kp <= qp;
          if (window) keep = keep && (kp > qp - window);
          if (!keep) x = -1e30f;    // :81
        }
        s[i][j] = x;
        row_max = fmaxf(row_max, x);
      }
      const float m_new = fmaxf(m[i], half_warp_max(row_max));
      float p_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sP[(ty + 16 * i) * PP + tx + 16 * j] = p;
        p_sum += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = corr * l[i] + half_warp_sum(p_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float va[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) va[c] = sV[j * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(p, va[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    const float l_safe = l[i] == 0.f ? 1.f : l[i];  // :98
    T* orow = out + ((size_t)b * sq + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) orow[tx + 16 * c] = from_f<T>(acc[i][c] / l_safe);
    if (tx == 0) lse[((size_t)b * hq + h) * sq + r] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int b, int sq, int sk, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + BQ - 1) / BQ, hq, b);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<float*>(lse), sq, sk, hq, hkv, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             void* lse, int b, int sq, int sk, int hq, int hkv, int causal,
             int window, float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window, scale, stream);
    case 32: return launch<T, 32>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window, scale, stream);
  }
  // bf16 at head_dim 64, 80 and 128 runs the Hopper body (flash_fwd)
  if constexpr (std::is_same<T, float>::value) {
    switch (d) {
      case 64: return launch<T, 64>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window, scale, stream);
      // hubert-xlarge's layers (1,280 over 16 heads)
      case 80: return launch<T, 80>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window, scale, stream);
      case 128: return launch<T, 128>(q, k, v, out, lse, b, sq, sk, hq, hkv, causal, window, scale, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// The tile sizes of the SIMT body and of the Hopper body, for the
// wrapper's checks and the plain version; and which body takes the
// inputs (1: the Hopper body).
int flash_fwd_block_q() { return BQ; }
int flash_fwd_block_k() { return BK; }
int flash_fwd_tc_block_q() { return sm90::BQ; }
int flash_fwd_tc_block_k() { return sm90::BK; }
int flash_fwd_tc(int is_bf16, int d) { return sm90::takes(is_bf16, d); }

// q (b, sq, hq, d), k/v (b, sk, hkv, d) contiguous, all bf16 (is_bf16 = 1)
// or all float32; out (b, sq, hq, d) in their type, lse (b, hq, sq) f32.
// d in {16, 32, 64, 80, 128}. Returns a cudaError_t (0: launched), or 10000 +
// a CUDA driver error of the Hopper body's tensor maps.
int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int b, int sq, int sk, int hq, int hkv, int d,
              int causal, int window, float scale, int is_bf16,
              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sm90::takes(is_bf16, d))
    return sm90::dispatch(d, q, k, v, out, lse, b, sq, sk, hq, hkv, causal,
                          window, scale, st);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, out, lse, b, sq, sk, hq, hkv,
                                   causal, window, scale, st);
  return dispatch<float>(d, q, k, v, out, lse, b, sq, sk, hq, hkv, causal,
                         window, scale, st);
}

}  // extern "C"
