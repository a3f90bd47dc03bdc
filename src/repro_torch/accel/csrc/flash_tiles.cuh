// Tile staging shared by the flash-attention kernels B6
// (flash_attention.cu) and B7/B8 (flash_attention_bwd.cu): 16-byte
// vector loads of a (rows x D) tile of bf16 or float32 values into
// registers, and their conversion into float32 shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace
