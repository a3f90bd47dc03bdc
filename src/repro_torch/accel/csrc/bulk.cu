// The epsilon-fair network's bulk solver kernels, hand-written for Hopper
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
// 2 * nodes + racks) that is tens of KB: launch latency bounds it, and the
// call's cost lies around the kernel. So the design is in the caller
// (TorchBulk.price): one copy up of the padded ids and flags through a
// pinned staging buffer, the share table left on the card by the
// water-fill below, one copy down of the prices.
// Design: one thread per flow row, the four link ids and flags read once,
// shares gathered for valid links only (the share table, under 20 KB for
// a thousand nodes, stays in L1/L2).
//
// Water-fill — the epsilon-fair max-min solve, all its rounds in one
// launch. It replaces no Pallas kernel: the reference computes it in jnp,
// in one jitted lax.while_loop (src/repro/accel/bulk.py:187
// _make_waterfill), which PallasBulk inherits because a data-dependent
// loop has no natural grid. On the card that loop has a natural home: one
// block runs every round of NumpyBulk.waterfill (accel/bulk.py), with the
// per-link tables in shared memory, so a solve costs one launch and one
// host read instead of about 25 launches and one host read a round.
// Per round, over k flows (four link ids each, valid flags beside them)
// and nL links:
//   1. count the alive flows' valid link slots (integer atomics: the
//      counts are order-free and exact);
//   2. s = min over links with a count of rem / count (IEEE division; a
//      NaN wins, as in np.min);
//   3. bottleneck links: counted, rem / count <= s * eps1 (eps1 = 1 + eps
//      as the host computes it); their share becomes s;
//   4. every alive flow on a bottleneck link is hit: its rate becomes s,
//      it dies, and its valid slots are counted again;
//   5. rem = max(rem - (double)hits * s, 0.0) on every link, the product
//      rounded before the subtraction (-fmad=false), the max as
//      np.maximum takes it (NaN propagates, -0.0 becomes 0.0).
// The loop ends when no flow is alive; then share = rem on the links that
// never were a bottleneck. A link that was a bottleneck once has no alive
// flow afterwards, so step 4 may test "ever a bottleneck" instead of "a
// bottleneck this round", and each link's share is written once.
// Exactness: every value is computed by the same IEEE operations as the
// numpy loop, so share, rate and the number of rounds equal it bit for bit.
// With finite inputs each round freezes at least one flow, so a solve
// takes at most k rounds. A NaN capacity stops progress (the numpy loop
// spins forever): the kernel stops after k + 1 rounds and reports
// FILL_NO_PROGRESS; it never hangs the card. A valid link id outside
// [0, nL) reports FILL_BAD_LINK before any round.
// Tables: rem (8 B), count (4 B) and a frozen flag (1 B) per link and an
// alive flag (1 B) per flow: 13 nL + k bytes, in shared memory while that
// fits the 227 KB opt-in (nL = 2,040 at 1,000 nodes and 40 racks: 26.5 KB
// plus the flows), past it in a global work buffer the caller allocates
// (bulk_waterfill_work_bytes), which sits in L2 (at 10,000 nodes nL
// passes 20,000). Link ids and flags stay in global memory, read through
// the read-only path once a round.
// Bound on the card: bytes (eff, ids and flags read once, share and rate
// written once); a solve is a few rounds of a few thousand-entry passes
// with a block barrier between them, so the barriers and the one block's
// latency bound it, far above that: a solve is one launch instead of a
// round trip to the host a round.

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

// ---------------------------------------------------------------------------
// Water-fill
// ---------------------------------------------------------------------------
#define FILL_THREADS 1024
#define FILL_WARPS (FILL_THREADS / 32)
// Dynamic shared memory the kernel may take: the 227 KB opt-in less room
// for its static shared memory.
#define FILL_MAX_SMEM (232448 - 1024)

enum { FILL_OK = 0, FILL_NO_PROGRESS = 1, FILL_BAD_LINK = 2 };

__device__ __forceinline__ double nan_min(double a, double b) {
    if (isnan(a)) return a;          // np.min: a NaN wins
    if (isnan(b)) return b;
    return b < a ? b : a;
}

__device__ __forceinline__ double block_min(double m, double* red,
                                            double* out) {
    for (int o = 16; o; o >>= 1)
        m = nan_min(m, __shfl_xor_sync(0xffffffffu, m, o));
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x < 32) {
        double x = red[threadIdx.x];     // FILL_WARPS == 32
        for (int o = 16; o; o >>= 1)
            x = nan_min(x, __shfl_xor_sync(0xffffffffu, x, o));
        if (threadIdx.x == 0) *out = x;
    }
    __syncthreads();
    return *out;
}

// The valid slots of row i: bit c set where flag c is.
__device__ __forceinline__ unsigned slots(const unsigned* valid, int i) {
    const unsigned v = __ldg(valid + i);
    return (v & 1u) | ((v >> 7) & 2u) | ((v >> 14) & 4u) | ((v >> 21) & 8u);
}

__device__ __forceinline__ int slot_id(const int4& id, int c) {
    return c == 0 ? id.x : c == 1 ? id.y : c == 2 ? id.z : id.w;
}

template <bool SMEM>
__global__ void __launch_bounds__(FILL_THREADS, 1)
waterfill_kernel(const double* __restrict__ eff,
                 const int4* __restrict__ links,
                 const unsigned* __restrict__ valid, int k, int nL,
                 double eps1, unsigned char* __restrict__ work,
                 double* __restrict__ share, double* __restrict__ rate,
                 int* __restrict__ info) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ double red[FILL_WARPS];
    __shared__ double s_shared;
    unsigned char* tables = SMEM ? smem : work;
    double* rem = (double*)tables;
    int* cnt = (int*)(tables + 8 * (size_t)nL);
    unsigned char* frozen = tables + 12 * (size_t)nL;
    unsigned char* alive = frozen + nL;
    const int tid = threadIdx.x;

    for (int l = tid; l < nL; l += FILL_THREADS) {
        rem[l] = eff[l];
        cnt[l] = 0;
        frozen[l] = 0;
    }
    int bad = 0;
    for (int i = tid; i < k; i += FILL_THREADS) {
        const unsigned m = slots(valid, i);
        const int4 id = __ldg(links + i);
        for (int c = 0; c < 4; ++c) {
            const int l = slot_id(id, c);
            if ((m >> c & 1u) && (l < 0 || l >= nL)) bad = 1;
        }
        alive[i] = m != 0;
        rate[i] = 0.0;
    }
    if (__syncthreads_or(bad)) {
        if (tid == 0) { info[0] = 0; info[1] = FILL_BAD_LINK; }
        return;
    }
    int rounds = 0, status = FILL_OK;
    while (true) {
        // 1. the alive flows' link counts
        int any = 0;
        for (int i = tid; i < k; i += FILL_THREADS) {
            if (!alive[i]) continue;
            any = 1;
            const unsigned m = slots(valid, i);
            const int4 id = __ldg(links + i);
            for (int c = 0; c < 4; ++c)
                if (m >> c & 1u) atomicAdd(cnt + slot_id(id, c), 1);
        }
        if (!__syncthreads_or(any)) break;
        if (rounds == k + 1) { status = FILL_NO_PROGRESS; break; }
        ++rounds;
        // 2. the least equal share over the counted links
        double m = INFINITY;
        for (int l = tid; l < nL; l += FILL_THREADS) {
            const int c = cnt[l];
            if (c > 0) m = nan_min(m, rem[l] / (double)c);
        }
        const double s = block_min(m, red, &s_shared);
        const double thr = s * eps1;
        // 3. bottleneck links; the counts are spent
        for (int l = tid; l < nL; l += FILL_THREADS) {
            const int c = cnt[l];
            if (c > 0 && rem[l] / (double)c <= thr) {
                frozen[l] = 1;
                share[l] = s;
            }
            cnt[l] = 0;
        }
        __syncthreads();
        // 4. the flows they hit, and those flows' slots counted again
        for (int i = tid; i < k; i += FILL_THREADS) {
            if (!alive[i]) continue;
            const unsigned m4 = slots(valid, i);
            const int4 id = __ldg(links + i);
            bool hit = false;
            for (int c = 0; c < 4; ++c)
                if ((m4 >> c & 1u) && frozen[slot_id(id, c)]) hit = true;
            if (!hit) continue;
            rate[i] = s;
            alive[i] = 0;
            for (int c = 0; c < 4; ++c)
                if (m4 >> c & 1u) atomicAdd(cnt + slot_id(id, c), 1);
        }
        __syncthreads();
        // 5. the remaining capacities
        for (int l = tid; l < nL; l += FILL_THREADS) {
            const double dec = (double)cnt[l] * s;
            const double x = rem[l] - dec;
            rem[l] = (isnan(x) || x > 0.0) ? x : 0.0;
            cnt[l] = 0;
        }
        __syncthreads();
    }
    // Links that never bottlenecked expose their residual headroom.
    for (int l = tid; l < nL; l += FILL_THREADS)
        if (!frozen[l]) share[l] = rem[l];
    if (tid == 0) { info[0] = rounds; info[1] = status; }
}

static size_t fill_table_bytes(int k, int nL) {
    return 13 * (size_t)nL + (size_t)k;
}

// Bytes of the global work buffer a solve of k flows over nL links needs:
// 0 while its tables fit in shared memory.
extern "C" size_t bulk_waterfill_work_bytes(int k, int nL) {
    const size_t bytes = fill_table_bytes(k, nL);
    return bytes <= FILL_MAX_SMEM ? 0 : bytes;
}

extern "C" int bulk_waterfill_threads() { return FILL_THREADS; }

// eff (nL,) float64; links (k, 4) int32, 16-byte aligned; valid (k, 4)
// bool, 4-byte aligned; work: bulk_waterfill_work_bytes(k, nL) bytes (may
// be null when that is 0); share (nL,) and rate (k,) float64; info (2,)
// int32: the number of rounds and the status (FILL_*).
extern "C" int bulk_waterfill(const void* eff, const void* links,
                              const void* valid, int k, int nL, double eps1,
                              void* work, void* share, void* rate,
                              void* info, void* stream) {
    const size_t bytes = fill_table_bytes(k, nL);
    cudaStream_t st = (cudaStream_t)stream;
    if (bytes <= FILL_MAX_SMEM) {
        static bool opted = false;
        if (!opted) {
            const cudaError_t e = cudaFuncSetAttribute(
                waterfill_kernel<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, FILL_MAX_SMEM);
            if (e != cudaSuccess) return (int)e;
            opted = true;
        }
        waterfill_kernel<true><<<1, FILL_THREADS, bytes, st>>>(
            (const double*)eff, (const int4*)links, (const unsigned*)valid,
            k, nL, eps1, nullptr, (double*)share, (double*)rate, (int*)info);
    } else {
        if (work == nullptr) return (int)cudaErrorInvalidValue;
        waterfill_kernel<false><<<1, FILL_THREADS, 0, st>>>(
            (const double*)eff, (const int4*)links, (const unsigned*)valid,
            k, nL, eps1, (unsigned char*)work, (double*)share, (double*)rate,
            (int*)info);
    }
    return (int)cudaGetLastError();
}
