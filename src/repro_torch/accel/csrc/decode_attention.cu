// B9: single-token decode attention against a KV cache, split across
// blocks (flash-decoding), for sm_90a (plain C interface, ctypes).
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
// element and query head, far below the tensor-core rate. So what counts
// is enough bytes in flight on enough SMs: one block per (KV head,
// sequence) gave 32 blocks on 132 SMs, each with one tile in flight, and
// took 20x its bound (PERF.md).
//
// Design (FlashDecoding). The grid is (splits, KV heads, sequences); a
// split is SPLIT = 128 keys, and the number of splits comes from S, the
// cache's capacity, so the host never reads `valid`. A split that starts
// at or past min(valid[b], S) exits at once (at S 4,096 and valid 2,100,
// 544 of 1,024 blocks run). A live block of 128 threads holds the group's
// query rows (up to 64) in shared memory as float32 and streams its keys
// through a ring of STAGES = 3 tiles of BK = 32 keys: K and V stay in
// their own type (bf16 or float32) in shared memory, filled by 16-byte
// cp.async copies, two tiles in flight while one is computed; a tile
// past the end of the keys reads zeros. (Splits of 256 keys with 4 stages,
// and 64 or 128 keys with 2 to 4 stages, measured within 10 % of this on
// an H100: PERF.md.) K's 16-byte chunks are XOR-
// swizzled by row, so lane j reading key j's row finds a bank of its own.
// Per tile: warp w scores rows w, w + 4, ... (lane j against key j, keys
// at or past the valid length -inf) and runs their online softmax with
// shuffles; after one barrier each thread updates 4 columns of one
// row's accumulator against V; two barriers a tile. The block writes
// float32 partials per query head: the unnormalised accumulator, m and
// l. The combine kernel then adds, per (query head, sequence), the live
// splits in split order: M = max m_s, w_s = exp(m_s - M), L = sum w_s
// l_s, out = sum w_s acc_s / L; no atomics, so the same inputs give the
// same bits. A split with no valid key is never read, so it adds exactly
// 0 and no exp(-inf - -inf) is taken; every tile a live split walks holds
// a valid key, so its running max is finite.
// Query head h is row h % group of KV head h / group, as the reference's
// reshape (b, hkv, group, d) makes it.
// Precondition: valid[b] >= 1. With valid[b] <= 0 every score is -inf and
// the reference gives NaN (exp(-inf - -inf)); the combine writes NaN for
// that sequence too. valid[b] > S reads the whole cache, as the
// reference's mask does.
// The lse mode (decode_attn_lse) serves the sequence-parallel decode
// (src/repro_torch/kernels/decode_attention/distributed.py), where each
// rank runs B9 over its own chunk of the cache and the ranks combine
// their rows by log-sum-exp: the combine writes the row in float32 and
// its lse = M + log(L) beside it, and a row with valid <= 0 (a chunk
// that holds no key yet) is o = 0, lse = -inf. The split kernel is the
// same; decode_attn's output and its NaN rows are untouched.
// expf, not the fast intrinsic; built without -use_fast_math.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;       // keys per staged tile: one per lane
constexpr int SPLIT = 128;   // keys per split: one block
constexpr int STAGES = 3;    // tiles in the shared-memory ring
constexpr int NT = 128;      // threads per block
constexpr int NW = NT / 32;
constexpr int COLS = 4;      // accumulator columns per thread and item
constexpr int MAX_GROUP = 64;
constexpr int COMBINE_NT = 128;

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

// 16 bytes of T as float32: 8 bf16 or 4 float32 values.
template <typename T> struct Vec { static constexpr int N = 16 / sizeof(T); };

__device__ __forceinline__ void unpack(const uint4& raw, float* out, float) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}
__device__ __forceinline__ void unpack(const uint4& raw, float* out,
                                       __nv_bfloat16) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// COLS consecutive values of T as float32.
__device__ __forceinline__ void load_cols(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}
__device__ __forceinline__ void load_cols(const __nv_bfloat16* p,
                                          float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; the bytes past `src_bytes` (0 or
// 16) are zeros.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// Shared memory of a split block: the ring of K and V tiles, then the
// query rows, the accumulator, p, m, l and corr (float32).
template <typename T, int D>
struct Layout {
  static constexpr int CH = D * (int)sizeof(T) / 16;   // 16-byte chunks a row
  static constexpr int SW = (CH < 8 ? CH : 8) - 1;     // K's swizzle mask
  // The chunks that are swizzled: whole groups of 8 (all of a row whose
  // chunk count is a power of two). At head_dim 80 a row is 10 chunks
  // (bf16) or 20 (float32): c ^ (r & 7) of chunk 8 or 16 would leave
  // the row, so its last 2 or 4 chunks stay in place.
  static constexpr int SWZ = CH < 8 ? CH : CH / 8 * 8;
  static __device__ __forceinline__ int swizzle(int c, int r) {
    return c < SWZ ? c ^ (r & SW) : c;
  }
  static constexpr int TILE = BK * D * (int)sizeof(T); // bytes of K or V
  static constexpr int RING = STAGES * 2 * TILE;
  static size_t bytes(int group) {
    return RING + sizeof(float) * ((size_t)group * (2 * D + BK) + 3 * group);
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(NT)
decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const int* __restrict__ valid,
                    float* __restrict__ part_acc, float* __restrict__ part_m,
                    float* __restrict__ part_l, int S, int hq, int hkv,
                    float scale) {
  using L = Layout<T, D>;
  constexpr int CH = L::CH, VN = Vec<T>::N;
  extern __shared__ __align__(16) uint8_t smem[];
  const int group = hq / hkv;
  float* sQ = reinterpret_cast<float*>(smem + L::RING);
  float* sAcc = sQ + group * D;
  float* sP = sAcc + group * D;
  float* sM = sP + group * BK;
  float* sL = sM + group;
  float* sC = sL + group;

  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int n = min(valid[b], S);
  const int s0 = split * SPLIT;
  if (s0 >= n) return;   // no valid key (every split when valid <= 0)
  const int s_end = min(s0 + SPLIT, n);
  const int ntiles = (s_end - s0 + BK - 1) / BK;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t kv_row = (size_t)hkv * D;
  const T* qb = q + ((size_t)b * hq + (size_t)hk * group) * D;
  const T* kb = k + (size_t)b * S * kv_row + (size_t)hk * D;
  const T* vb = v + (size_t)b * S * kv_row + (size_t)hk * D;
  const uint32_t ring = smem_u32(smem);

  // Tile t of this split into stage t % STAGES: chunk c of key row r goes
  // to chunk swizzle(c, r) of K's row, chunk c of V's; keys past s_end
  // read zeros (their scores are -inf, and 0 x V stays finite).
  auto load_tile = [&](int t) {
    const int k0 = s0 + t * BK;
    const uint32_t st = ring + (t % STAGES) * 2 * L::TILE;
    for (int idx = tid; idx < BK * CH; idx += NT) {
      const int r = idx / CH, c = idx % CH;
      const bool in = k0 + r < s_end;
      const size_t off = (size_t)(in ? k0 + r : s0) * kv_row + c * VN;
      cp_async16(st + (r * CH + L::swizzle(c, r)) * 16, kb + off,
                 in ? 16 : 0);
      cp_async16(st + L::TILE + (r * CH + c) * 16, vb + off, in ? 16 : 0);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }
  for (int i = tid; i < group * D; i += NT) {
    sQ[i] = to_f(qb[i]);
    sAcc[i] = 0.f;
  }
  for (int g = tid; g < group; g += NT) {
    sM[g] = -INFINITY;
    sL[g] = 0.f;
  }

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();   // tile t has landed (this thread's part)
    __syncthreads();   // ... everyone's; tile t - 1 and its p are consumed
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_async_commit();

    const int k0 = s0 + t * BK;
    const uint8_t* sK = smem + (t % STAGES) * 2 * L::TILE;
    const T* sV = reinterpret_cast<const T*>(sK + L::TILE);
    const bool live = k0 + lane < s_end;
    // scores and online softmax: warp w owns rows w, w + 4, ...; lane j
    // scores key j of the tile
    for (int g = warp; g < group; g += NW) {
      const float* qr = sQ + g * D;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(
            sK + (lane * CH + L::swizzle(c, lane)) * 16);
        float kv[VN];
        unpack(raw, kv, T());
#pragma unroll
        for (int e = 0; e < VN; ++e) dot = fmaf(qr[c * VN + e], kv[e], dot);
      }
      const float s = live ? dot * scale : -INFINITY;
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, warp_max(s));   // finite: a live key
      const float p = expf(s - m_new);
      sP[g * BK + lane] = p;
      const float sum = warp_sum(p);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        sC[g] = corr;
        sL[g] = corr * sL[g] + sum;
        sM[g] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * corr + p . V, COLS columns of one row per item
    for (int it = tid; it < group * (D / COLS); it += NT) {
      const int g = it / (D / COLS), c = (it % (D / COLS)) * COLS;
      float* acc = sAcc + g * D + c;
      const float corr = sC[g];
      float a[COLS];
#pragma unroll
      for (int e = 0; e < COLS; ++e) a[e] = acc[e] * corr;
      const float* p = sP + g * BK;
#pragma unroll 8
      for (int j = 0; j < BK; ++j) {
        float vv[COLS];
        load_cols(sV + j * D + c, vv);
        const float pj = p[j];
#pragma unroll
        for (int e = 0; e < COLS; ++e) a[e] = fmaf(pj, vv[e], a[e]);
      }
#pragma unroll
      for (int e = 0; e < COLS; ++e) acc[e] = a[e];
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // float32 partials of query heads hk * group + g, split `split`
  const size_t row0 = ((size_t)b * hq + (size_t)hk * group) * nsplit + split;
  for (int i = tid; i < group * D; i += NT) {
    const int g = i / D, c = i % D;
    part_acc[(row0 + (size_t)g * nsplit) * D + c] = sAcc[i];
  }
  for (int g = tid; g < group; g += NT) {
    part_m[row0 + (size_t)g * nsplit] = sM[g];
    part_l[row0 + (size_t)g * nsplit] = sL[g];
  }
}

// One block per (query head, sequence): the live splits' partials added
// in split order, the splits' m and l staged in shared memory. TO is the
// output's type: T for serving, float32 in the lse mode (LSE), which also
// writes the row's log-sum-exp M + log(L) for a combine across chunks of a
// cache (the sequence-parallel decode): there a sequence whose chunk
// holds no key yet is normal, and its row is o = 0 with lse = -inf (a
// weight of exp(-inf - m) = 0 in the cross-chunk combine), where serving
// writes NaN.

template <typename TO, bool LSE>
__global__ void __launch_bounds__(COMBINE_NT)
decode_combine_kernel(const float* __restrict__ part_acc,
                      const float* __restrict__ part_m,
                      const float* __restrict__ part_l,
                      const int* __restrict__ valid, TO* __restrict__ out,
                      float* __restrict__ lse, int S, int hq, int d,
                      int nsplit) {
  extern __shared__ float sw[];   // m_s, then w_s, and l_s of the splits
  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  TO* ob = out + ((size_t)b * hq + h) * d;
  const int n = min(valid[b], S);
  if (n <= 0) {
    if (LSE) {    // an empty chunk: no weight in the cross-chunk combine
      for (int c = tid; c < d; c += COMBINE_NT) ob[c] = from_f<TO>(0.f);
      if (tid == 0) lse[(size_t)b * hq + h] = -INFINITY;
    } else {      // no key: the reference's softmax over all -inf
      for (int c = tid; c < d; c += COMBINE_NT) ob[c] = from_f<TO>(NAN);
    }
    return;
  }
  const int live = (n + SPLIT - 1) / SPLIT;
  const size_t row0 = ((size_t)b * hq + h) * nsplit;
  float* sl = sw + nsplit;
  for (int s = tid; s < live; s += COMBINE_NT) {
    sw[s] = part_m[row0 + s];
    sl[s] = part_l[row0 + s];
  }
  __syncthreads();
  float M = -INFINITY;
  for (int s = 0; s < live; ++s) M = fmaxf(M, sw[s]);
  __syncthreads();   // every m is read
  for (int s = tid; s < live; s += COMBINE_NT) sw[s] = expf(sw[s] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < live; ++s) L = fmaf(sw[s], sl[s], L);
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  if (LSE && tid == 0) lse[(size_t)b * hq + h] = M + logf(L);
  for (int c = tid; c < d; c += COMBINE_NT) {
    float o = 0.f;
#pragma unroll 4
    for (int s = 0; s < live; ++s)
      o = fmaf(sw[s], part_acc[(row0 + s) * d + c], o);
    ob[c] = from_f<TO>(o * inv);
  }
}

// The split kernel, then the combine; `lse` null for serving (out in T),
// else the lse mode (out float32).
template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* valid,
           void* out, void* lse, void* part_acc, void* part_m, void* part_l,
           int b, int S, int hq, int hkv, float scale, cudaStream_t stream) {
  const size_t smem = Layout<T, D>::bytes(hq / hkv);
  auto kern = decode_split_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nsplit = (S + SPLIT - 1) / SPLIT;
  kern<<<dim3(nsplit, hkv, b), NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(valid),
      static_cast<float*>(part_acc), static_cast<float*>(part_m),
      static_cast<float*>(part_l), S, hq, hkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the splits' m (then w) and l: under 48 KB up to S of 1.5 M keys
  const size_t csmem = 2 * (size_t)nsplit * sizeof(float);
  const float* pa = static_cast<const float*>(part_acc);
  const float* pm = static_cast<const float*>(part_m);
  const float* pl = static_cast<const float*>(part_l);
  const int* vb = static_cast<const int*>(valid);
  if (lse == nullptr)
    decode_combine_kernel<T, false><<<dim3(hq, b), COMBINE_NT, csmem,
                                      stream>>>(
        pa, pm, pl, vb, static_cast<T*>(out), nullptr, S, hq, D, nsplit);
  else
    decode_combine_kernel<float, true><<<dim3(hq, b), COMBINE_NT, csmem,
                                         stream>>>(
        pa, pm, pl, vb, static_cast<float*>(out), static_cast<float*>(lse),
        S, hq, D, nsplit);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* valid, void* out, void* lse, void* pa, void* pm,
             void* pl, int b, int S, int hq, int hkv, float scale,
             cudaStream_t stream) {
  switch (d) {
    case 16: return launch<T, 16>(q, k, v, valid, out, lse, pa, pm, pl, b, S, hq, hkv, scale, stream);
    case 32: return launch<T, 32>(q, k, v, valid, out, lse, pa, pm, pl, b, S, hq, hkv, scale, stream);
    case 64: return launch<T, 64>(q, k, v, valid, out, lse, pa, pm, pl, b, S, hq, hkv, scale, stream);
    case 80: return launch<T, 80>(q, k, v, valid, out, lse, pa, pm, pl, b, S, hq, hkv, scale, stream);
    case 128: return launch<T, 128>(q, k, v, valid, out, lse, pa, pm, pl, b, S, hq, hkv, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int run(const void* q, const void* k, const void* v, const void* valid,
        void* out, void* lse, void* part_acc, void* part_m, void* part_l,
        int b, int S, int hq, int hkv, int d, float scale, int is_bf16,
        void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (hkv < 1 || hq % hkv != 0 || hq / hkv > MAX_GROUP || b < 1 || S < 1)
    return (int)cudaErrorInvalidValue;
  if (is_bf16)
    return dispatch<__nv_bfloat16>(d, q, k, v, valid, out, lse, part_acc,
                                   part_m, part_l, b, S, hq, hkv, scale, st);
  return dispatch<float>(d, q, k, v, valid, out, lse, part_acc, part_m,
                         part_l, b, S, hq, hkv, scale, st);
}

}  // namespace

extern "C" {

int decode_block_k() { return BK; }
int decode_split() { return SPLIT; }
int decode_stages() { return STAGES; }
int decode_max_group() { return MAX_GROUP; }

// q (b, hq, d); k/v (b, S, hkv, d) contiguous, all bf16 (is_bf16 = 1) or
// all float32; valid (b,) int32; out (b, hq, d) in q's type; scratch
// part_acc (b, hq, splits, d) and part_m, part_l (b, hq, splits) float32
// with splits = ceil(S / SPLIT). d in {16, 32, 64, 80, 128}, hq / hkv <= 64.
// Launches the split kernel, then the combine. Returns a cudaError_t.
int decode_attn(const void* q, const void* k, const void* v,
                const void* valid, void* out, void* part_acc, void* part_m,
                void* part_l, int b, int S, int hq, int hkv, int d,
                float scale, int is_bf16, void* stream) {
  return run(q, k, v, valid, out, nullptr, part_acc, part_m, part_l, b, S,
             hq, hkv, d, scale, is_bf16, stream);
}

// The lse mode: as decode_attn, but out (b, hq, d) is float32 and lse
// (b, hq) float32 gets each row's log-sum-exp; a sequence with
// valid <= 0 gets out = 0 and lse = -inf.
int decode_attn_lse(const void* q, const void* k, const void* v,
                    const void* valid, void* out, void* lse, void* part_acc,
                    void* part_m, void* part_l, int b, int S, int hq, int hkv,
                    int d, float scale, int is_bf16, void* stream) {
  return run(q, k, v, valid, out, lse, part_acc, part_m, part_l, b, S, hq,
             hkv, d, scale, is_bf16, stream);
}

}  // extern "C"
