// B9: single-token decode attention against a KV cache, for sm_90a
// (plain C interface, ctypes).
//
// Replaces src/repro/kernels/decode_attention/decode_attention.py:28
// `_decode_kernel` (its pallas_call at :108, reached via
// `decode_attention_pallas`, :69): one query token per sequence, the
// whole GQA query group resident, a per-sequence valid length that masks
// the cache's tail with -inf, online softmax in float32.
//
// What bounds it on an H100: the cache read. At the serving path's
// decode shape (b 4, 32 query heads over 8 KV heads, head_dim 128, a
// 4,096-slot bf16 cache filled to about 2,100) it must read about 34 MB
// of K and V, 0.010 ms at 3.35 TB/s; the arithmetic is 4 flops per cached
// element and query head, far below the tensor-core rate.
//
// Design. One block of 128 threads per (KV head, sequence): it holds the
// group's query rows (hq / hkv of them, up to 64) in shared memory as
// float32 and walks the cache in tiles of 64 keys, staged in shared
// memory, only up to valid[b]; the next tile's 16-byte loads are issued
// into registers before this tile is computed (element loads at the point
// of use took 0.499 ms at the decode shape, against 0.205 ms now, on an
// H100 80GB HBM3 at 700 W; PERF.md). Skipping the tiles past valid gives
// the reference's bits: the TPU kernel streams them, every score is -inf,
// so it adds exactly 0 with corr = exp(0) = 1 (decode_attention.py:50-60).
// Scores (group x 64) and the accumulator (group x head_dim) live in
// shared memory; warp w reduces rows w, w + 4, ... with shuffles. Query
// head h is row h % group of KV head h / group, as the reference's
// reshape (b, hkv, group, d) makes it.
// Precondition: valid[b] >= 1. With valid[b] <= 0 every score is -inf and
// the reference gives NaN (exp(-inf - -inf)); this kernel writes NaN for
// that sequence too. valid[b] > S reads the whole cache, as the
// reference's mask does.
// At the slice's batch the grid is b * hkv = 32 blocks on 132 SMs, so the
// kernel under-fills the card; splitting the KV range across blocks with
// an LSE combine is later work (ROADMAP).
// expf, not the fast intrinsic; built without -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;     // keys per staged tile (two per lane)
constexpr int NT = 128;    // threads per block
constexpr int NW = NT / 32;
constexpr int MAX_GROUP = 64;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 16-byte loads: 8 bf16 or 4 float32 values at a time.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float* out);
template <>
__device__ __forceinline__ void unpack<float>(const uint4& raw, float* out) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(const uint4& raw,
                                                      float* out) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// A (rows x D) tile of a (.., row_stride) array, rows [r0, r_end) of it
// valid, as NC 16-byte chunks per thread held in registers: fetch() issues
// the loads, stash() converts them into shared memory (row pitch P) as
// float32, zeros past r_end.
template <typename T, int ROWS, int D, int NTH>
struct Tile {
  static constexpr int V = Vec<T>::N, PER_ROW = D / V;
  static constexpr int CHUNKS = ROWS * PER_ROW;
  static constexpr int NC = (CHUNKS + NTH - 1) / NTH;
  uint4 reg[NC];

  __device__ __forceinline__ void fetch(const T* base, size_t row_stride,
                                        int r0, int r_end, int tid) {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int idx = tid + j * NTH, r = idx / PER_ROW;
      const int c = (idx % PER_ROW) * V;
      reg[j] = make_uint4(0u, 0u, 0u, 0u);
      if (idx < CHUNKS && r0 + r < r_end)
        reg[j] = *reinterpret_cast<const uint4*>(
            base + (size_t)(r0 + r) * row_stride + c);
    }
  }

  template <int P>
  __device__ __forceinline__ void stash(float* dst, int tid) const {
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int idx = tid + j * NTH, r = idx / PER_ROW;
      const int c = (idx % PER_ROW) * V;
      if (idx < CHUNKS) unpack<T>(reg[j], dst + r * P + c);
    }
  }
};

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
size_t smem_floats(int group) {
  // Q and K with a padded row, V, scores, accumulator, m / l / corr
  return (size_t)group * (D + 1) + (size_t)BK * (D + 1) + (size_t)BK * D +
         (size_t)group * BK + (size_t)group * D + 3 * (size_t)group;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid,
              T* __restrict__ out, int S, int hq, int hkv, float scale) {
  constexpr int DP = D + 1;
  extern __shared__ float smem[];
  const int group = hq / hkv;
  float* sQ = smem;
  float* sK = sQ + group * DP;
  float* sV = sK + BK * DP;
  float* sS = sV + BK * D;
  float* sAcc = sS + group * BK;
  float* sM = sAcc + group * D;
  float* sL = sM + group;
  float* sC = sL + group;

  const int hk = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const size_t kv_row = (size_t)hkv * D;
  const T* qb = q + ((size_t)b * hq + (size_t)hk * group) * D;
  T* ob = out + ((size_t)b * hq + (size_t)hk * group) * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;

  int n = valid[b];
  if (n <= 0) {  // no valid key: the reference's softmax over all -inf
    for (int i = tid; i < group * D; i += NT) ob[i] = from_f<T>(NAN);
    return;
  }
  n = min(n, S);

  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, c = i % D;
    sQ[g * DP + c] = to_f(qb[i]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < group; g += NT) {
    sM[g] = -INFINITY;
    sL[g] = 0.f;
  }

  // K and V tiles travel in registers: the next tile's loads are in
  // flight while this tile is computed.
  Tile<T, BK, D, NT> tk, tv;
  tk.fetch(kb, kv_row, 0, n, tid);
  tv.fetch(vb, kv_row, 0, n, tid);
  for (int k0 = 0; k0 < n; k0 += BK) {
    __syncthreads();  // the previous tile is consumed; Q and state are set
    tk.template stash<DP>(sK, tid);
    tv.template stash<D>(sV, tid);
    __syncthreads();
    if (k0 + BK < n) {
      tk.fetch(kb, kv_row, k0 + BK, n, tid);
      tv.fetch(vb, kv_row, k0 + BK, n, tid);
    }

    for (int i = tid; i < group * BK; i += NT) {
      const int g = i / BK, c = i % BK;
      const float* qr = sQ + g * DP;
      const float* kr = sK + c * DP;
      float dot = 0.f;
#pragma unroll 8
      for (int j = 0; j < D; ++j) dot = fmaf(qr[j], kr[j], dot);
      sS[i] = k0 + c < n ? dot * scale : -INFINITY;
    }
    __syncthreads();

    for (int g = warp; g < group; g += NW) {
      float* row = sS + g * BK;
      const float a = row[lane], c = row[lane + 32];
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(a, c)));
      const float pa = expf(a - m_new), pc = expf(c - m_new);
      row[lane] = pa;
      row[lane + 32] = pc;
      const float sum = warp_sum(pa + pc);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[g] = corr;
        sL[g] = corr * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < group * D; i += NT) {
      const int g = i / D, c = i % D;
      const float* p = sS + g * BK;
      float a = sAcc[i] * sC[g];
#pragma unroll 8
      for (int j = 0; j < BK; ++j) a = fmaf(p[j], sV[j * D + c], a);
      sAcc[i] = a;
    }
  }
  __syncthreads();

  for (int i = tid; i < group * D; i += NT) {
    const float l = sL[i / D];
    ob[i] = from_f<T>(sAcc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, int b, int S, int hq, int hkv, float scale,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>(hq / hkv) * sizeof(float);
  auto kern = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(hkv, b);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<T*>(out), S, hq, hkv, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* valid, void* out, int b, int S, int hq, int hkv,
             float scale, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, valid, out, b, S, hq, hkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, valid, out, b, S, hq, hkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, b, S, hq, hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, b, S, hq, hkv, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int decode_block_k() { return BK; }
int decode_max_group() { return MAX_GROUP; }

// q (b, hq, d); k/v (b, S, hkv, d) contiguous, all bf16 (is_bf16 = 1) or
// all float32; valid (b,) int32; out (b, hq, d) in q's type.
// d in {16, 32, 64, 128}, hq / hkv <= 64. Returns a cudaError_t.
int decode_attn(const void* q, const void* k, const void* v,
                const void* valid, void* out, int b, int S, int hq, int hkv,
                int d, float scale, int is_bf16, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hq % hkv != 0 || hq / hkv > MAX_GROUP) return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, valid, out, b, S, hq, hkv,
                                   scale, st);
  return dispatch<float>(d, q, k, v, valid, out, b, S, hq, hkv, scale, st);
}

}  // extern "C"
