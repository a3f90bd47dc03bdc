// B7 and B8: the GQA flash-attention backward for sm_90a (plain C
// interface, ctypes).
//
// B7 replaces src/repro/kernels/flash_attention/flash_attention.py:169
// `_dkv_kernel` (its pallas_call at :322, in `flash_attention_bwd`, :290):
// dK and dV of one KV head, summed over its query group. B8 replaces
// `_dq_kernel` (:235, pallas_call at :361): dQ of one query head. Both
// recompute s = (q . k^T) * scale and p = exp(s - lse) with p = 0 where
// masked (a `where`, :212-214 and :275-277, not the forward's -1e30),
// dP = dO . V^T and dS = p * (dP - delta) * scale (:219-221, :278-280),
// with delta = rowsum(dO * out) computed by the wrapper (the reference
// computes it outside its kernels too, :309). Then B7 adds dV += p^T . dO
// and dK += dS^T . q, and B8 adds dQ += dS . K. Outputs are in the input
// type: dq in q's, dk and dv in k's and v's (:342-343, :375).
//
// Two bodies each; the C entry points flash_bwd_dq and flash_bwd_dkv pick
// one from the dtype and head_dim alone, never from a failure:
//   - bf16 with head_dim 64, 80 or 128 (every attention layer of the
//     training paths: Qwen1.5-0.5B's 64, internvl2's and moonshot's 128,
//     hubert-xlarge's 80): the Hopper bodies of
//     flash_attention_bwd_sm90.cuh, wgmma tensor-core products on TMA-fed
//     tiles, p and dS rounded to bf16 before the products that take them
//     (its note says why, what bounds them, and how a 160-byte row of 80
//     is laid out: five 16-column tiles), the GQA group split across
//     blocks and summed in head order by flash_dkv_group_sum;
//   - float32 at every head_dim, and bf16 with head_dim 16 or 32: the SIMT
//     bodies below.
//
// The SIMT bodies. What bounds them on an H100: at the training path's
// shape (Qwen1.5-0.5B: b 1, sq = sk = 2048, 16 heads over 16, head_dim
// 64, causal) B7 does four products of 2 d flops per unmasked (q, k) pair
// and head, 17.19 GFLOP, and B8 three, 12.89 GFLOP, against about 24 and
// 20 MB of traffic: arithmetic bounds them. These bodies do not reach the
// tensor cores: every product is a float32 FMA from shared memory, with
// the reference's float32 arithmetic, so the f32 rate outside the tensor
// cores (67 TFLOP/s) holds them: 0.919 and 0.708 ms there on an H100
// 80GB HBM3 at 700 W (PERF.md), which is why bf16 at head_dim 64/80/128
// takes the Hopper bodies.
//
// The SIMT bodies' design. The TPU kernel carries the GQA group and the
// query tiles as sequential grid axes with float32 scratch (:171-181,
// :318); here that sum is a loop inside one block, so no two blocks write
// the same output and there are no atomics: the sum order is fixed and
// the result is the same bits on every run (the live runtime's
// exactly-once reduce needs a microbatch computed twice, on two hosts, to
// give the same gradient).
//
// - B7: one block of 256 threads per (KV tile of 64 keys, KV head,
//   sequence). K and V stay in shared memory; the block loops over the
//   group's query heads h = hk * group + g and, for each, over the query
//   tiles of 64 rows whose band reaches this KV tile (the skips of
//   :184-189 make them one range). dK and dV of the block's 64 keys live
//   in registers as float32 and are written once.
// - B8: one block per (query tile of 64 rows, query head, sequence),
//   looping over the KV tiles in the band (the same range as B6's); dQ of
//   its rows lives in registers as float32 and is written once. dQ is not
//   folded into B7 with atomic adds, as FlashAttention-2 does.
//
// Thread (ty, tx) of a 16 x 16 layout owns score rows ty + 16 i and
// columns tx + 16 j (i, j < 4) of a 64 x 64 tile, and accumulator rows
// ty + 16 i and columns tx + 16 c (c < D / 16). Tiles are staged as
// float32 with a padded row (no bank conflicts), fetched as 16-byte
// vectors one tile ahead (flash_tiles.cuh). Keys past sk and query rows
// past sq (a ragged last tile, which the reference cannot have: its grid
// floor-divides, :318 and :357) are loaded as zeros and weigh exactly 0;
// rows past the ends are not written. Query head h reads KV head
// h / (hq / hkv). expf, not the fast intrinsic; no -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd_sm90.cuh"
#include "flash_tiles.cuh"

namespace {

constexpr int BQ = 64;    // query rows per tile
constexpr int BK = 64;    // keys per tile
constexpr int NT = 256;   // threads per block (16 x 16)
constexpr int PP = BK + 1;

// The reference's static skip of a (query tile, KV tile) pair
// (flash_attention.py:184-189): above the causal band, or below the
// window.
__device__ __forceinline__ bool pair_runs(int q0, int k0, int q_offset,
                                          int causal, int window) {
  return !(causal && k0 > q0 + q_offset + BQ - 1) &&
         !(window && !(k0 + BK - 1 > q0 + q_offset - window));
}

__device__ __forceinline__ bool keeps(int qp, int kp, int causal,
                                      int window) {
  bool keep = true;
  if (causal) keep = kp <= qp;
  if (window) keep = keep && (kp > qp - window);
  return keep;
}

template <int D>
constexpr size_t dq_smem_floats() {
  // Q, dO, K, V with padded rows, dS with a padded row
  return 4 * (size_t)BQ * (D + 1) + (size_t)BQ * PP;
}

template <int D>
constexpr size_t dkv_smem_floats() {
  // K, V, Q, dO with padded rows, P and dS with padded rows, lse, delta
  return 4 * (size_t)BQ * (D + 1) + 2 * (size_t)BQ * PP + 2 * (size_t)BQ;
}

// s = Q K^T and dp = dO V^T on a staged (query tile, KV tile) pair, for
// the thread's rows ty + 16 i and columns tx + 16 j.
template <int D>
__device__ __forceinline__ void scores(const float* sQ, const float* sDO,
                                       const float* sK, const float* sV,
                                       int tx, int ty, float (&s)[4][4],
                                       float (&dp)[4][4]) {
  constexpr int DP = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < D; ++c) {
    float qa[4], oa[4], ka[4], va[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = sQ[(ty + 16 * i) * DP + c];
      oa[i] = sDO[(ty + 16 * i) * DP + c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ka[j] = sK[(tx + 16 * j) * DP + c];
      va[j] = sV[(tx + 16 * j) * DP + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
        dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
      }
  }
}

// ---------------------------------------------------------------------------
// B8: dQ
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta, T* __restrict__ dq, int sq,
                int sk, int hq, int hkv, int causal, int window,
                float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + BQ * DP;
  float* sK = sDO + BQ * DP;
  float* sV = sK + BK * DP;
  float* sDS = sV + BK * DP;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const int q0 = qt * BQ, q_offset = sk - sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;
  const T* qb = q + (size_t)b * sq * q_row + (size_t)h * D;
  const T* ob = dout + (size_t)b * sq * q_row + (size_t)h * D;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;
  const size_t stat = ((size_t)b * hq + h) * sq;

  {
    Tile<T, BQ, D, NT> t;
    t.fetch(qb, q_row, q0, sq, tid);
    t.template stash<DP>(sQ, tid);
    t.fetch(ob, q_row, q0, sq, tid);
    t.template stash<DP>(sDO, tid);
  }
  float lse_r[4], delta_r[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    lse_r[i] = r < sq ? lse[stat + r] : 0.f;
    delta_r[i] = r < sq ? delta[stat + r] : 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  // The KV tiles in the band: one range [lo, hi), as in B6.
  const int nkt = (sk + BK - 1) / BK;
  int lo = 0;
  while (lo < nkt && !pair_runs(q0, lo * BK, q_offset, causal, window)) ++lo;
  int hi = lo;
  while (hi < nkt && pair_runs(q0, hi * BK, q_offset, causal, window)) ++hi;

  Tile<T, BK, D, NT> tk, tv;
  if (lo < hi) {
    tk.fetch(kb, kv_row, lo * BK, sk, tid);
    tv.fetch(vb, kv_row, lo * BK, sk, tid);
  }
  for (int kt = lo; kt < hi; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K and dS are consumed
    tk.template stash<DP>(sK, tid);
    tv.template stash<DP>(sV, tid);
    __syncthreads();
    if (kt + 1 < hi) {
      tk.fetch(kb, kv_row, k0 + BK, sk, tid);
      tv.fetch(vb, kv_row, k0 + BK, sk, tid);
    }
    float s[4][4], dp[4][4];
    scores<D>(sQ, sDO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + ty + 16 * i, qp = r + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        const bool keep = r < sq && kp < sk && keeps(qp, kp, causal, window);
        // scale after the float32 product (:263-264), p zeroed by mask
        const float p = keep ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        sDS[(ty + 16 * i) * PP + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BK; ++j) {
      float ka[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) ka[c] = sK[j * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = sDS[(ty + 16 * i) * PP + j];
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = fmaf(ds, ka[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    if (r >= sq) continue;
    T* row = dq + ((size_t)b * sq + r) * q_row + (size_t)h * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) row[tx + 16 * c] = from_f<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// B7: dK and dV
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk,
                 T* __restrict__ dv, int sq, int sk, int hq, int hkv,
                 int causal, int window, float scale) {
  constexpr int DP = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * DP;
  float* sQ = sV + BK * DP;
  float* sDO = sQ + BQ * DP;
  float* sP = sDO + BQ * DP;
  float* sDS = sP + BQ * PP;
  float* sL = sDS + BQ * PP;
  float* sDl = sL + BQ;

  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = hq / hkv;
  const int k0 = kt * BK, q_offset = sk - sq;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const size_t q_row = (size_t)hq * D, kv_row = (size_t)hkv * D;
  const T* kb = k + (size_t)b * sk * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * sk * kv_row + (size_t)hk * D;

  {
    Tile<T, BK, D, NT> t;
    t.fetch(kb, kv_row, k0, sk, tid);
    t.template stash<DP>(sK, tid);
    t.fetch(vb, kv_row, k0, sk, tid);
    t.template stash<DP>(sV, tid);
  }
  float dk_acc[4][DC], dv_acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  // The query tiles whose band reaches this KV tile: one range [lo, hi)
  // (the causal band starts it, the window ends it).
  const int nqt = (sq + BQ - 1) / BQ;
  int lo = 0;
  while (lo < nqt && !pair_runs(lo * BQ, k0, q_offset, causal, window)) ++lo;
  int hi = lo;
  while (hi < nqt && pair_runs(hi * BQ, k0, q_offset, causal, window)) ++hi;
  const int n = (hi - lo) * group;   // (g, query tile) steps, g outer

  auto head_of = [&](int it) { return hk * group + it / (hi - lo); };
  auto tile_of = [&](int it) { return lo + it % (hi - lo); };
  Tile<T, BQ, D, NT> tq, to;
  if (n > 0) {
    const size_t off = (size_t)b * sq * q_row + (size_t)head_of(0) * D;
    tq.fetch(q + off, q_row, tile_of(0) * BQ, sq, tid);
    to.fetch(dout + off, q_row, tile_of(0) * BQ, sq, tid);
  }
  for (int it = 0; it < n; ++it) {
    const int h = head_of(it), q0 = tile_of(it) * BQ;
    const size_t stat = ((size_t)b * hq + h) * sq;
    __syncthreads();  // the previous step's Q, dO, P and dS are consumed
    tq.template stash<DP>(sQ, tid);
    to.template stash<DP>(sDO, tid);
    if (tid < BQ) {
      const int r = q0 + tid;
      sL[tid] = r < sq ? lse[stat + r] : 0.f;
      sDl[tid] = r < sq ? delta[stat + r] : 0.f;
    }
    __syncthreads();
    if (it + 1 < n) {
      const size_t off =
          (size_t)b * sq * q_row + (size_t)head_of(it + 1) * D;
      tq.fetch(q + off, q_row, tile_of(it + 1) * BQ, sq, tid);
      to.fetch(dout + off, q_row, tile_of(it + 1) * BQ, sq, tid);
    }
    float s[4][4], dp[4][4];
    scores<D>(sQ, sDO, sK, sV, tx, ty, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int rl = ty + 16 * i, r = q0 + rl, qp = r + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kl = tx + 16 * j, kp = k0 + kl;
        const bool keep = r < sq && kp < sk && keeps(qp, kp, causal, window);
        const float p = keep ? expf(s[i][j] * scale - sL[rl]) : 0.f;
        sP[rl * PP + kl] = p;
        sDS[rl * PP + kl] = p * (dp[i][j] - sDl[rl]) * scale;
      }
    }
    __syncthreads();
    // dV[key] += p[q, key] dO[q], dK[key] += dS[q, key] Q[q], over the
    // tile's query rows in order
#pragma unroll 2
    for (int r = 0; r < BQ; ++r) {
      float oa[DC], qa[DC];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        oa[c] = sDO[r * DP + tx + 16 * c];
        qa[c] = sQ[r * DP + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = sP[r * PP + ty + 16 * i];
        const float ds = sDS[r * PP + ty + 16 * i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          dv_acc[i][c] = fmaf(p, oa[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(ds, qa[c], dk_acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const size_t off = ((size_t)b * sk + key) * kv_row + (size_t)hk * D;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk[off + tx + 16 * c] = from_f<T>(dk_acc[i][c]);
      dv[off + tx + 16 * c] = from_f<T>(dv_acc[i][c]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  int b, sq, sk, hq, hkv, causal, window;
  float scale;
  cudaStream_t stream;
};

template <typename T, int D>
int launch_dq(const Args& a, void* dq) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  auto kern = flash_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sq + BQ - 1) / BQ, a.hq, a.b);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dq), a.sq, a.sk, a.hq, a.hkv, a.causal, a.window,
      a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const Args& a, void* dk, void* dv) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  auto kern = flash_dkv_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((a.sk + BK - 1) / BK, a.hkv, a.b);
  kern<<<grid, NT, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(dk), static_cast<T*>(dv), a.sq, a.sk, a.hq, a.hkv,
      a.causal, a.window, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_dq(int d, const Args& a, void* dq) {
  switch (d) {
    case 16: return launch_dq<T, 16>(a, dq);
    case 32: return launch_dq<T, 32>(a, dq);
    case 64: return launch_dq<T, 64>(a, dq);
    case 80: return launch_dq<T, 80>(a, dq);
    case 128: return launch_dq<T, 128>(a, dq);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch_dkv(int d, const Args& a, void* dk, void* dv) {
  switch (d) {
    case 16: return launch_dkv<T, 16>(a, dk, dv);
    case 32: return launch_dkv<T, 32>(a, dk, dv);
    case 64: return launch_dkv<T, 64>(a, dk, dv);
    case 80: return launch_dkv<T, 80>(a, dk, dv);
    case 128: return launch_dkv<T, 128>(a, dk, dv);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The Hopper body of head_dim d, by an explicit switch (null for a
// head_dim it does not take).
template <typename F>
F hopper_body(int d, F d64, F d80, F d128) {
  switch (d) {
    case 64: return d64;
    case 80: return d80;
    case 128: return d128;
    default: return nullptr;
  }
}

}  // namespace

extern "C" {

// The tile sizes, for the wrapper's checks and the plain versions: the
// SIMT bodies' (query tile, KV tile) pairs, and the Hopper bodies' (a
// consumer's 64 rows against a streamed tile of 64).
int flash_bwd_block_q() { return BQ; }
int flash_bwd_block_k() { return BK; }
int flash_bwd_tc_block_q() { return sm90::bwd::ROWS; }
int flash_bwd_tc_block_k() { return sm90::bwd::ROWS; }
// 1 where the Hopper bodies take the inputs: bf16 at head_dim 64, 80 or
// 128.
int flash_bwd_tc(int is_bf16, int d) { return sm90::bwd::takes(is_bf16, d); }

// q and dout (b, sq, hq, d), k/v (b, sk, hkv, d) contiguous, all bf16
// (is_bf16 = 1) or all float32; lse and delta (b, hq, sq) float32; dq
// (b, sq, hq, d) in their type. d in {16, 32, 64, 80, 128}. Returns a
// cudaError_t (0: launched), or 10000 + a driver error of the Hopper
// body's tensor maps.
int flash_bwd_dq(const void* q, const void* k, const void* v,
                 const void* dout, const void* lse, const void* delta,
                 void* dq, int b, int sq, int sk, int hq, int hkv, int d,
                 int causal, int window, float scale, int is_bf16,
                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sm90::bwd::takes(is_bf16, d)) {
    const auto launch = hopper_body(d, &sm90::bwd::launch_dq<64>,
                                    &sm90::bwd::launch_dq<80>,
                                    &sm90::bwd::launch_dq<128>);
    if (launch == nullptr) return (int)cudaErrorInvalidValue;
    return launch(q, k, v, dout, lse, delta, dq, b, sq, sk, hq, hkv, causal,
                  window, scale, st);
  }
  const Args a{q, k, v, dout, lse, delta, b, sq, sk, hq, hkv, causal,
               window, scale, st};
  return is_bf16 ? dispatch_dq<__nv_bfloat16>(d, a, dq)
                 : dispatch_dq<float>(d, a, dq);
}

// As flash_bwd_dq; dk and dv (b, sk, hkv, d) in the inputs' type, except
// where the Hopper body takes the inputs with a group above 1 (hq > hkv):
// there dk and dv are (b, sk, hq, d) float32 partials, one per query
// head, for flash_bwd_group_sum.
int flash_bwd_dkv(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dk, void* dv, int b, int sq, int sk, int hq, int hkv,
                  int d, int causal, int window, float scale, int is_bf16,
                  void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (sm90::bwd::takes(is_bf16, d)) {
    const auto launch = hopper_body(d, &sm90::bwd::launch_dkv<64>,
                                    &sm90::bwd::launch_dkv<80>,
                                    &sm90::bwd::launch_dkv<128>);
    if (launch == nullptr) return (int)cudaErrorInvalidValue;
    return launch(q, k, v, dout, lse, delta, dk, dv, b, sq, sk, hq, hkv,
                  causal, window, scale, st);
  }
  const Args a{q, k, v, dout, lse, delta, b, sq, sk, hq, hkv, causal,
               window, scale, st};
  return is_bf16 ? dispatch_dkv<__nv_bfloat16>(d, a, dk, dv)
                 : dispatch_dkv<float>(d, a, dk, dv);
}

// The group sum of the Hopper body's partials: dk_part and dv_part
// (rows, hq, d) float32 contiguous, rows = b sk; dk and dv (rows, hkv, d)
// bf16, each the sum of its KV head's hq / hkv partials in head order. d
// a multiple of 4, the arrays 16-byte aligned.
int flash_bwd_group_sum(const void* dk_part, const void* dv_part, void* dk,
                        void* dv, int rows, int hq, int hkv, int d,
                        void* stream) {
  return sm90::bwd::group_sum(dk_part, dv_part, dk, dv, rows, hq, hkv, d,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
