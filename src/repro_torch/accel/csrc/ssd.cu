// B10: the Mamba-2 SSD chunked scan, for sm_90a (plain C interface,
// ctypes).
//
// Replaces src/repro/kernels/ssd/ssd.py:29 `_ssd_kernel` (its pallas_call
// at :105, reached via `ssd_pallas`, :83): per (batch, head) and chunk of
// Q rows, with a_cs the inclusive cumsum of dt * A over the chunk,
//   y_l   = sum_{s <= l} (C_l . B_s) exp(a_cs[l] - a_cs[s]) dt_s x_s
//         + exp(a_cs[l]) C_l . state + D x_l
//   state = state exp(total) + sum_s B_s dt_s exp(total - a_cs[s]) x_s^T
// with total = a_cs[Q - 1]; B and C of head h are those of group
// h / (heads / groups). Returns y in x's type and the final state
// (b, h, p, n) float32, as the reference's wrapper transposes it
// (ssd.py:130-132).
//
// Two bodies. bf16 inputs with head_dim and d_state each 64 or 128 and
// chunks of 64 to 256 rows in steps of 64 (Mamba2-2.7B's layer among
// them) run the Hopper body of ssd_sm90.cuh through ssd_fwd_tc: three
// kernels, every product on wgmma (its header says what bounds it and
// how). float32 inputs and the other shapes run
// the SIMT body below through ssd_fwd; ssd_tc says which.
//
// SIMT body (f32 FMAs on the CUDA cores, whose 67 TFLOP/s bound it; C.B^T
// is recomputed for every head of a group). The TPU
// kernel carries the state in VMEM scratch across a sequential grid axis;
// here one block of 256 threads per (batch, head) loops over the chunks in
// order and keeps the (p x n) state in shared memory. Per chunk: dt is
// staged and one thread takes the inclusive cumsum of dt * A in row order,
// each product and sum rounded on its own (no fused multiply-add), as the
// plain version and the Hopper body take it: within a 256-row chunk a_cs
// reaches hundreds, and exp(a_cs[l] - a_cs[s]) turns a last-bit
// difference there into a relative error of about 1e-4 in y (a fused
// cumsum put y 4.3e-4 from the plain version's at s = 2,048 on an H100:
// PERF.md); the chunk is cut into sub-tiles of R = 64 rows,
// since a 256-row chunk of B and C in float32 (128 KB each at n = 128)
// does not fit shared memory whole. For each row tile l: C_l is staged,
// the carried-state term computed, then for each column tile s <= l the
// scores C_l B_s^T are scaled by exp(a_cs[l] - a_cs[s]) dt_s only where
// s <= l (exp is never taken for an anti-causal pair: its exponent is
// positive and can overflow, which is why the oracle masks before exp) and
// multiplied into x_s; the diagonal tile comes last, so x_l is staged for
// D x_l. Then the state update walks the row tiles once more. Each thread
// holds a 4 x (P/16) (or (P/16) x (N/16)) register tile on a 16 x 16
// thread grid, rows ty + 16 i and columns tx + 16 j; rows of shared arrays
// are padded by one float so those reads fall in distinct banks.
// Ragged chunks: a chunk past the sequence's end is shorter; rows past s
// load as zeros (dt = 0: the oracle's padding, the identity) and are never
// written. Shared memory at p 64, n 128, Q 256: about 134 KB, one block
// per SM; b * h = 320 blocks on 132 SMs.
// expf, not the fast intrinsic; built without -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "ssd_sm90.cuh"   // the Hopper body

namespace {

constexpr int R = 64;      // rows of a sub-tile
constexpr int NT = 256;    // threads per block, a 16 x 16 grid
constexpr int RI = R / 16; // rows per thread in a sub-tile

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Rows [r0, r0 + R) of a (rows, W) slice with `stride` elements between
// rows into shared memory (pitch W + 1) as float32, tile row r times
// scale[r] when scale is given; rows at or past r_end are zeros.
template <typename T, int W>
__device__ __forceinline__ void stage(float* dst, const T* src,
                                      size_t stride, int r0, int r_end,
                                      const float* scale, int tid) {
  for (int i = tid; i < R * W; i += NT) {
    const int r = i / W, c = i % W;
    float v = 0.f;
    if (r0 + r < r_end) {
      v = to_f(src[(size_t)(r0 + r) * stride + c]);
      if (scale) v *= scale[r];
    }
    dst[r * (W + 1) + c] = v;
  }
}

size_t smem_floats(int p, int n, int Q) {
  // state, C tile, B tile, x tile, scores, dt and a_cs of the chunk
  return (size_t)p * (n + 1) + 2 * (size_t)R * (n + 1) +
         (size_t)R * (p + 1) + (size_t)R * (R + 1) + 2 * (size_t)Q;
}

template <typename T, int P, int N>
__global__ void __launch_bounds__(NT)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ D,
           T* __restrict__ y, float* __restrict__ state_out, int S, int H,
           int G, int Q) {
  constexpr int PJ = P / 16, NJ = N / 16;
  constexpr int NP = N + 1, PP = P + 1, RP = R + 1;
  extern __shared__ float smem[];
  float* sState = smem;
  float* sC = sState + P * NP;
  float* sB = sC + R * NP;
  float* sX = sB + R * NP;
  float* sS = sX + R * PP;
  float* sDt = sS + R * RP;
  float* sAcs = sDt + Q;

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int g = h / (H / G);
  const float a_h = A[h], d_h = D[h];
  const size_t xs = (size_t)H * P, bs = (size_t)G * N;  // row strides
  const T* xb = x + (size_t)b * S * xs + (size_t)h * P;
  T* yb = y + (size_t)b * S * xs + (size_t)h * P;
  const T* Bb = Bm + (size_t)b * S * bs + (size_t)g * N;
  const T* Cb = Cm + (size_t)b * S * bs + (size_t)g * N;
  const float* dtb = dt + (size_t)b * S * H + h;

  for (int i = tid; i < P * NP; i += NT) sState[i] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int qv = min(Q, S - c0);         // valid rows of this chunk
    const int tiles = (qv + R - 1) / R;
    __syncthreads();  // the previous chunk's readers of sDt/sAcs are done
    for (int i = tid; i < Q; i += NT)
      sDt[i] = i < qv ? dtb[(size_t)(c0 + i) * H] : 0.f;
    __syncthreads();
    if (tid == 0) {
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run = __fadd_rn(run, __fmul_rn(sDt[i], a_h));
        sAcs[i] = run;
      }
    }
    __syncthreads();
    const float total = sAcs[Q - 1];

    for (int lt = 0; lt < tiles; ++lt) {
      const int l0 = lt * R;
      // sC was last read before the previous tile's final barrier
      stage<T, N>(sC, Cb + (size_t)c0 * bs, bs, l0, qv, nullptr, tid);
      __syncthreads();
      float acc[RI][PJ];
#pragma unroll
      for (int i = 0; i < RI; ++i) {
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      }
      // carried state: exp(a_cs[l]) C_l . state[p]
      for (int k = 0; k < N; ++k) {
        float cv[RI], sv[PJ];
#pragma unroll
        for (int i = 0; i < RI; ++i) cv[i] = sC[(ty + 16 * i) * NP + k];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = sState[(tx + 16 * j) * NP + k];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
        }
      }
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const float e = expf(sAcs[min(l0 + ty + 16 * i, Q - 1)]);
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }

      for (int st = 0; st <= lt; ++st) {
        const int s0 = st * R;
        __syncthreads();  // sB, sX, sS of the previous step are consumed
        stage<T, N>(sB, Bb + (size_t)c0 * bs, bs, s0, qv, nullptr, tid);
        stage<T, P>(sX, xb + (size_t)c0 * xs, xs, s0, qv, nullptr, tid);
        __syncthreads();
        // scores of the causal pairs: (C_l . B_s) exp(a_cs[l] - a_cs[s]) dt_s
        float sc[RI][RI];
#pragma unroll
        for (int i = 0; i < RI; ++i) {
#pragma unroll
          for (int j = 0; j < RI; ++j) sc[i][j] = 0.f;
        }
        for (int k = 0; k < N; ++k) {
          float cv[RI], bv[RI];
#pragma unroll
          for (int i = 0; i < RI; ++i) cv[i] = sC[(ty + 16 * i) * NP + k];
#pragma unroll
          for (int j = 0; j < RI; ++j) bv[j] = sB[(tx + 16 * j) * NP + k];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
#pragma unroll
            for (int j = 0; j < RI; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
          }
        }
#pragma unroll
        for (int i = 0; i < RI; ++i) {
          const int l = l0 + ty + 16 * i;
#pragma unroll
          for (int j = 0; j < RI; ++j) {
            const int s = s0 + tx + 16 * j;
            float w = 0.f;
            if (s <= l && l < qv)
              w = sc[i][j] * expf(sAcs[l] - sAcs[s]) * sDt[s];
            sS[(ty + 16 * i) * RP + tx + 16 * j] = w;
          }
        }
        __syncthreads();
        for (int s = 0; s < R; ++s) {
          float wv[RI], xv[PJ];
#pragma unroll
          for (int i = 0; i < RI; ++i) wv[i] = sS[(ty + 16 * i) * RP + s];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = sX[s * PP + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RI; ++i) {
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(wv[i], xv[j], acc[i][j]);
          }
        }
      }
      // sX holds the diagonal tile, x_l: add D x_l and write y
#pragma unroll
      for (int i = 0; i < RI; ++i) {
        const int r = ty + 16 * i;
        if (l0 + r < qv) {
#pragma unroll
          for (int j = 0; j < PJ; ++j) {
            const int p = tx + 16 * j;
            yb[(size_t)(c0 + l0 + r) * xs + p] =
                from_f<T>(acc[i][j] + d_h * sX[r * PP + p]);
          }
        }
      }
      __syncthreads();  // sC, sX and sAcs readers are done with this tile
    }

    // state <- state exp(total) + sum_s (B_s dt_s exp(total - a_cs[s])) x_s^T
    float upd[PJ][NJ];
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) upd[i][j] = 0.f;
    }
    for (int st = 0; st < tiles; ++st) {
      const int s0 = st * R;
      __syncthreads();
      // the row weights dt_s exp(total - a_cs[s]) go into sS's first row
      for (int i = tid; i < R; i += NT)
        sS[i] = s0 + i < qv ? sDt[s0 + i] * expf(total - sAcs[s0 + i]) : 0.f;
      __syncthreads();
      stage<T, N>(sB, Bb + (size_t)c0 * bs, bs, s0, qv, sS, tid);
      stage<T, P>(sX, xb + (size_t)c0 * xs, xs, s0, qv, nullptr, tid);
      __syncthreads();
      for (int s = 0; s < R; ++s) {
        float xv[PJ], bv[NJ];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = sX[s * PP + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NJ; ++j) bv[j] = sB[s * NP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i) {
#pragma unroll
          for (int j = 0; j < NJ; ++j) upd[i][j] = fmaf(xv[i], bv[j], upd[i][j]);
        }
      }
    }
    __syncthreads();  // every reader of the old state is done
    const float decay = expf(total);
#pragma unroll
    for (int i = 0; i < PJ; ++i) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        float* e = sState + (ty + 16 * i) * NP + tx + 16 * j;
        *e = *e * decay + upd[i][j];
      }
    }
  }
  __syncthreads();
  float* so = state_out + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += NT)
    so[i] = sState[(i / N) * NP + i % N];
}

template <typename T, int P, int N>
int launch(const void* x, const void* dt, const void* A, const void* B,
           const void* C, const void* D, void* y, void* state, int b, int S,
           int H, int G, int Q, cudaStream_t stream) {
  const size_t smem = smem_floats(P, N, Q) * sizeof(float);
  auto kern = ssd_kernel<T, P, N>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(H, b);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(B),
      static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<T*>(y), static_cast<float*>(state), S, H, G, Q);
  return (int)cudaGetLastError();
}

template <typename T, int P>
int dispatch_n(int n, const void* x, const void* dt, const void* A,
               const void* B, const void* C, const void* D, void* y,
               void* state, int b, int S, int H, int G, int Q,
               cudaStream_t st) {
  switch (n) {
    case 16: return launch<T, P, 16>(x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 32: return launch<T, P, 32>(x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 64: return launch<T, P, 64>(x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 128: return launch<T, P, 128>(x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int p, int n, const void* x, const void* dt, const void* A,
             const void* B, const void* C, const void* D, void* y,
             void* state, int b, int S, int H, int G, int Q,
             cudaStream_t st) {
  switch (p) {
    case 16: return dispatch_n<T, 16>(n, x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 32: return dispatch_n<T, 32>(n, x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 64: return dispatch_n<T, 64>(n, x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    case 128: return dispatch_n<T, 128>(n, x, dt, A, B, C, D, y, state, b, S, H, G, Q, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int ssd_tile_rows() { return R; }
int ssd_tc_tile() { return ssd90::TQ; }
int ssd_tc_max_chunk() { return ssd90::MAXQ; }

// 1 where the Hopper body takes the inputs (ssd_fwd_tc), 0 where the SIMT
// body does (ssd_fwd): bf16 with p, n in {64, 128} and Q a multiple of
// 64 up to 256.
int ssd_tc(int is_bf16, int p, int n, int Q) {
  return ssd90::takes(is_bf16, p, n, Q);
}

// Shared memory (bytes) of one block at head_dim p, d_state n, chunk Q.
size_t ssd_smem(int p, int n, int Q) {
  return smem_floats(p, n, Q) * sizeof(float);
}

// x (b, S, H, p) and B, C (b, S, G, n) contiguous, all bf16 (is_bf16 = 1)
// or all float32; dt (b, S, H), A (H,), D (H,) float32; y (b, S, H, p) in
// x's type; state (b, H, p, n) float32. p, n in {16, 32, 64, 128}, H a
// multiple of G, 1 <= Q. Returns a cudaError_t.
int ssd_fwd(const void* x, const void* dt, const void* A, const void* B,
            const void* C, const void* D, void* y, void* state, int b, int S,
            int H, int G, int p, int n, int Q, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (G < 1 || H % G != 0 || Q < 1) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(p, n, x, dt, A, B, C, D, y, state, b, S,
                                   H, G, Q, st);
  return dispatch<float>(p, n, x, dt, A, B, C, D, y, state, b, S, H, G, Q,
                         st);
}

// The Hopper body: x (b, S, H, p), B, C (b, S, G, n) contiguous bf16 with
// 16-byte-aligned bases; dt (b, S, H), A, D (H,) float32; y in x's type,
// state (b, H, p, n) float32. Scratch, with nc = ceil(S / Q) chunks:
// a_cs, dtp and wts (b, H, nc, Q) float32, cb (b, nc, G, t (t + 1) / 2,
// 4096) float32 with t = Q / 64, st_in (b, nc, H, 2, p, n) bf16. Launches
// the three kernels in order. Returns a cudaError_t, or 10000 + a driver
// error of the tensor maps.
int ssd_fwd_tc(const void* x, const void* dt, const void* A, const void* B,
               const void* C, const void* D, void* y, void* state,
               void* a_cs, void* dtp, void* wts, void* cb, void* st_in,
               int b, int S, int H, int G, int p, int n, int Q,
               void* stream) {
  if (!ssd90::takes(1, p, n, Q) || G < 1 || H % G != 0 || b < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  return ssd90::dispatch(p, n, x, dt, A, B, C, D, y, state, a_cs, dtp, wts,
                         cb, st_in, b, S, H, G, Q,
                         static_cast<cudaStream_t>(stream));
}

}  // extern "C"
