// Batch pricing kernel of the epsilon-fair network, hand-written for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Build (repro_torch/accel/kernels.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libbulk.so bulk.cu
//
// B5 — frozen-rate batch pricing.
// Replaces PallasBulk._price_core.kernel (src/repro/accel/bulk.py:252),
// called through pl.pallas_call at :261.
// Per flow row i: max(min(share[links[i, c]] over the valid c < 4), 1.0).
// A row with no valid link (the caller's padding) prices to +inf, as the
// reference's padded rows do; the caller drops those rows.
// Exactness: a min and a max of float64 values are order-free, so the
// result equals NumpyBulk.price bit for bit. NaN propagates as np.min and
// np.maximum propagate it. A valid link id outside [0, nL) yields NaN
// instead of reading outside `share`.
// Bound on the card: bytes. Each row reads 16 bytes of link ids, 4 valid
// flags and at most four 8-byte shares, and writes 8 bytes; it does at most
// five comparisons. At the fair network's sizes (a few thousand rows, nL =
// 2 * nodes + racks) that is tens of KB: launch latency bounds it.
// Design: one thread per flow row, the four link ids and flags read once,
// shares gathered for valid links only (the share table, under 20 KB for
// a thousand nodes, stays in L1/L2).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NTHREADS 256

__global__ void price_kernel(const double* __restrict__ share,
                             const int* __restrict__ links,
                             const unsigned char* __restrict__ valid,
                             int cap, int nL, double* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cap) return;
    const int* row = links + (size_t)i * 4;
    const unsigned char* ok = valid + (size_t)i * 4;
    double r = INFINITY;
    for (int c = 0; c < 4; ++c) {
        if (!ok[c]) continue;
        const int l = row[c];
        const double x = (l >= 0 && l < nL) ? share[l] : (double)NAN;
        // np.min: a NaN anywhere wins and stays.
        if (isnan(x) || x < r) r = isnan(r) ? r : x;
    }
    // np.maximum(r, 1.0): NaN propagates from r.
    out[i] = (isnan(r) || r > 1.0) ? r : 1.0;
}

extern "C" int bulk_price(const void* share, const void* links,
                          const void* valid, int cap, int nL, void* out,
                          void* stream) {
    if (cap <= 0) return 0;
    const int blocks = (cap + NTHREADS - 1) / NTHREADS;
    price_kernel<<<blocks, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const double*)share, (const int*)links,
        (const unsigned char*)valid, cap, nL, (double*)out);
    return (int)cudaGetLastError();
}
