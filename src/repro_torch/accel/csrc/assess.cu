// Assessment kernels of the speculation loop, hand-written for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Build (repro_torch/accel/kernels.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libassess.so assess.cu
//
// Exactness contract: every result equals the numpy reference backend bit
// for bit, not within a tolerance.
//   - Each float64 bucket is summed by ONE thread, visiting rows in
//     canonical order: the association order of np.bincount. No atomics
//     touch a double.
//   - -fmad=false keeps a*b+c as two rounded operations, as numpy does.
//   - float64 '/' and sqrt are IEEE round-to-nearest in CUDA by default.
//   - Order statistics, maxima and integer flags are order-free.
// Inputs arrive in canonical row order, padded to `cap` rows; pad rows are
// already masked out of `running`/`alive`/`runatt`/`live` by the caller.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

// np.maximum(x, c) for a constant c: NaN propagates from x.
__device__ __forceinline__ double np_max(double x, double c) {
    return (isnan(x) || x > c) ? x : c;
}

// Order-preserving block compaction: every thread of the block calls this
// with its flag; returns the flag's exclusive prefix count over the block
// (thread order) and the block total in *total.
__device__ __forceinline__ int block_slot(int flag, int* warp_counts,
                                          int* total) {
    const unsigned lane = threadIdx.x & 31u;
    const unsigned warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(0xffffffffu, flag);
    const int within = __popc(ballot & ((1u << lane) - 1u));
    if (lane == 0) warp_counts[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, all = 0;
    for (int w = 0; w < NWARPS; ++w) {
        const int c = warp_counts[w];
        before += (w < (int)warp) ? c : 0;
        all += c;
    }
    *total = all;
    __syncthreads();  // warp_counts is reused by the next call
    return before + within;
}

// ---------------------------------------------------------------------------
// B1 — Eq. 1 spatial pass.
// Replaces _spatial_kernel (src/repro/accel/pallas_backend.py:51), called
// from _pallas_spatial (:223).
// Bound on the card: it reads ~24 bytes per row and writes 2n bytes per
// job; at the simulator's sizes (a few thousand rows, 1000 nodes) that is a
// few hundred KB, under a microsecond of bandwidth. Latency bounds it: the
// launch, and each block's pass over all rows in NTHREADS-row chunks.
// Design: one block per job. The block streams the rows in chunks of
// NTHREADS, compacts the job's running rows of each chunk into shared
// memory in canonical order, and each (phase, node) bucket is then summed
// by the one thread that owns it (bucket % NTHREADS), row by row in that
// order. The neighbourhood mean and sigma are left-to-right sums over k,
// the order np.nansum uses for k < 8. One launch covers every job.
// ---------------------------------------------------------------------------
__global__ void spatial_kernel(const double* __restrict__ rho,
                               const int* __restrict__ node,
                               const int* __restrict__ kind,
                               const int* __restrict__ jls,
                               const int* __restrict__ running,
                               const int* __restrict__ nh,
                               int cap, int n, int k,
                               unsigned char* __restrict__ fired) {
    extern __shared__ double smem[];
    double* sums = smem;                          // 2n: sums, then P
    double* crho = sums + 2 * n;                  // NTHREADS
    int* counts = (int*)(crho + NTHREADS);        // 2n
    int* cbucket = counts + 2 * n;                // NTHREADS
    int* warp_counts = cbucket + NTHREADS;        // NWARPS
    const int j = blockIdx.x;
    const int tid = threadIdx.x;
    const int nb = 2 * n;

    for (int b = tid; b < nb; b += NTHREADS) {
        sums[b] = 0.0;
        counts[b] = 0;
    }
    __syncthreads();
    for (int base = 0; base < cap; base += NTHREADS) {
        const int i = base + tid;
        int flag = 0, bucket = 0;
        double r = 0.0;
        if (i < cap && running[i] == 1 && jls[i] == j) {
            const int ph = kind[i], v = node[i];
            if (ph >= 0 && ph < 2 && v >= 0 && v < n) {
                flag = 1;
                bucket = ph * n + v;
                r = rho[i];
            }
        }
        int total;
        const int slot = block_slot(flag, warp_counts, &total);
        if (flag) {
            cbucket[slot] = bucket;
            crho[slot] = r;
        }
        __syncthreads();
        for (int e = 0; e < total; ++e) {
            const int b = cbucket[e];
            if (b % NTHREADS == tid) {
                sums[b] = sums[b] + crho[e];
                counts[b] += 1;
            }
        }
        __syncthreads();
    }
    // P = mean rho per bucket, NaN where the bucket is empty.
    for (int b = tid; b < nb; b += NTHREADS)
        sums[b] = counts[b] > 0 ? sums[b] / (double)counts[b] : (double)NAN;
    __syncthreads();
    for (int b = tid; b < nb; b += NTHREADS) {
        const int ph = b / n, v = b - ph * n;
        const double* Pp = sums + ph * n;
        const int* row = nh + (size_t)v * k;
        int cnt = 0;
        double s = 0.0;
        for (int kk = 0; kk < k; ++kk) {
            const double x = Pp[row[kk]];
            const bool valid = !isnan(x);
            cnt += valid ? 1 : 0;
            const double xv = valid ? x : 0.0;
            s = (kk == 0) ? xv : s + xv;
        }
        const double denom = (double)(cnt > 1 ? cnt : 1);
        const double mean = s / denom;
        double vs = 0.0;
        for (int kk = 0; kk < k; ++kk) {
            const double x = Pp[row[kk]];
            const double d = x - mean;
            const double sq = isnan(x) ? 0.0 : d * d;
            vs = (kk == 0) ? sq : vs + sq;
        }
        const double sd = sqrt(vs / denom);
        const double P = Pp[v];
        const bool hit = cnt >= 2 && !isnan(P) && (P < mean - sd);
        fired[((size_t)j * 2 + ph) * n + v] = hit ? 1 : 0;
    }
}

// ---------------------------------------------------------------------------
// B2 — Eq. 2-3 zeta accumulation.
// Replaces _temporal_kernel (src/repro/accel/pallas_backend.py:85), called
// from _pallas_temporal (:245).
// Bound on the card: ~28 bytes per row read and 16n bytes per job written,
// under a microsecond of bandwidth at the simulator's sizes; latency (the
// launch and the chunked pass over the rows) bounds it.
// Design: as B1, with n node buckets per job; each bucket's zeta_now,
// zeta_prev and count are owned by one thread and summed in canonical
// order. NaN marks nodes with no surviving attempt.
// ---------------------------------------------------------------------------
__global__ void temporal_kernel(const double* __restrict__ prog,
                                const double* __restrict__ tprog,
                                const int* __restrict__ node,
                                const int* __restrict__ jls,
                                const int* __restrict__ alive,
                                int cap, int n,
                                double* __restrict__ zn,
                                double* __restrict__ zp) {
    extern __shared__ double smem[];
    double* szn = smem;                           // n
    double* szp = szn + n;                        // n
    double* cprog = szp + n;                      // NTHREADS
    double* ctprog = cprog + NTHREADS;            // NTHREADS
    int* scnt = (int*)(ctprog + NTHREADS);        // n
    int* cnode = scnt + n;                        // NTHREADS
    int* warp_counts = cnode + NTHREADS;          // NWARPS
    const int j = blockIdx.x;
    const int tid = threadIdx.x;

    for (int b = tid; b < n; b += NTHREADS) {
        szn[b] = 0.0;
        szp[b] = 0.0;
        scnt[b] = 0;
    }
    __syncthreads();
    for (int base = 0; base < cap; base += NTHREADS) {
        const int i = base + tid;
        int flag = 0, v = 0;
        double a = 0.0, b = 0.0;
        if (i < cap && alive[i] == 1 && jls[i] == j) {
            v = node[i];
            if (v >= 0 && v < n) {
                flag = 1;
                a = prog[i];
                b = tprog[i];
            }
        }
        int total;
        const int slot = block_slot(flag, warp_counts, &total);
        if (flag) {
            cnode[slot] = v;
            cprog[slot] = a;
            ctprog[slot] = b;
        }
        __syncthreads();
        for (int e = 0; e < total; ++e) {
            const int c = cnode[e];
            if (c % NTHREADS == tid) {
                szn[c] = szn[c] + cprog[e];
                szp[c] = szp[c] + ctprog[e];
                scnt[c] += 1;
            }
        }
        __syncthreads();
    }
    for (int b = tid; b < n; b += NTHREADS) {
        const bool have = scnt[b] > 0;
        zn[(size_t)j * n + b] = have ? szn[b] : (double)NAN;
        zp[(size_t)j * n + b] = have ? szp[b] : (double)NAN;
    }
}

// ---------------------------------------------------------------------------
// B3 — LATE victim and collective winning verdict.
// Replaces _late_kernel (src/repro/accel/pallas_backend.py:112), called
// from _late_call (:273) for _pallas_late (:306) and _pallas_winning
// (:312).
// Bound on the card: ~48 bytes per row read, 8 bytes per job written,
// under a microsecond of bandwidth; latency bounds it (the launch, the
// segment walks, the rank count). The rank count is O(m^2) per job in the
// number m of candidate tasks (a few hundred here). Pad rows arrive as
// one-row segments, so no thread walks the pad run.
// Design: one block per job. Task segments are contiguous in canonical
// order, so the thread that finds a segment's first row walks the segment
// alone: best running attempt (max zeta, first wins), its start, the
// has-speculative flag, and the winning test's max original/speculative
// rates. Candidates go to a per-job list in global scratch (order free).
// np.percentile's two order statistics are selected exactly by counting
// ranks (no sort), then interpolated with numpy's _lerp. The victim is the
// slow candidate of largest estimated remaining time, lowest task on ties.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool better(double e1, int p1, double e2, int p2) {
    return e1 > e2 || (e1 == e2 && p1 < p2);
}

__global__ void late_kernel(const double* __restrict__ prog,
                            const double* __restrict__ start,
                            const double* __restrict__ rate,
                            const int* __restrict__ spec,
                            const int* __restrict__ tseg,
                            const int* __restrict__ jls,
                            const int* __restrict__ running,
                            const int* __restrict__ runatt,
                            const int* __restrict__ order,
                            int cap, double now, double min_runtime,
                            double q, double win_factor,
                            double* __restrict__ c_rho,
                            double* __restrict__ c_est,
                            int* __restrict__ c_pos,
                            int* __restrict__ victim,
                            int* __restrict__ win) {
    __shared__ int s_nrows, s_m, s_win;
    __shared__ double s_a, s_b;
    __shared__ double tile[NTHREADS];
    __shared__ double r_est[NTHREADS];
    __shared__ int r_pos[NTHREADS];
    const int j = blockIdx.x;
    const int tid = threadIdx.x;
    double* crho = c_rho + (size_t)j * cap;
    double* cest = c_est + (size_t)j * cap;
    int* cpos = c_pos + (size_t)j * cap;
    if (tid == 0) {
        s_nrows = 0;
        s_m = 0;
        s_win = 0;
        s_a = 0.0;
        s_b = 0.0;
    }
    __syncthreads();

    // Pass 1: one thread per task segment of this job.
    for (int i = tid; i < cap; i += NTHREADS) {
        const int s = tseg[i];
        if (i > 0 && tseg[i - 1] == s) continue;      // not a segment head
        double bprog = -INFINITY, bstart = 0.0;
        int bpos = -1, hspec = 0, nrun = 0;
        double hi = -INFINITY, lo = -INFINITY;
        int has_spec = 0, has_orig = 0;
        for (int r = i; r < cap && tseg[r] == s; ++r) {
            if (jls[r] != j) continue;
            const int sp = spec[r];
            if (running[r] == 1) {
                ++nrun;
                if (prog[r] > bprog) {                 // first wins ties
                    bprog = prog[r];
                    bpos = r;
                    bstart = start[r];
                }
                hspec |= sp;
            }
            if (runatt[r] == 1) {
                if (sp) {
                    hi = isnan(hi) ? hi : np_max(rate[r], hi);
                    has_spec = 1;
                } else {
                    lo = isnan(lo) ? lo : np_max(rate[r], lo);
                    has_orig = 1;
                }
            }
        }
        if (nrun) atomicAdd(&s_nrows, nrun);
        if (has_spec && (!has_orig || hi > lo * win_factor)) s_win = 1;
        if (bpos >= 0 && !hspec && (now - bstart >= min_runtime)) {
            const double rho = bprog / np_max(now - bstart, 1e-9);
            const double est = (1.0 - bprog) / np_max(rho, 1e-9);
            const int c = atomicAdd(&s_m, 1);
            crho[c] = rho;
            cest[c] = est;
            cpos[c] = bpos;
        }
    }
    __syncthreads();
    const int m = s_m;
    if (tid == 0) win[j] = s_win;
    if (s_nrows < 2 || m < 2) {                        // block-uniform
        if (tid == 0) victim[j] = -1;
        return;
    }

    // np.percentile(rho, q), 'linear': virtual index (m-1)*q/100.
    const double v = (double)(m - 1) * (q / 100.0);
    const double flo = floor(v);
    const double gamma = v - flo;
    int loi = (int)flo;
    loi = loi < 0 ? 0 : (loi > m - 1 ? m - 1 : loi);
    const int hii = loi + 1 > m - 1 ? m - 1 : loi + 1;
    // Sorted value at index t is the x with #(<x) <= t < #(<=x).
    for (int cb = 0; cb < m; cb += NTHREADS) {
        const int c = cb + tid;
        const double x = c < m ? crho[c] : 0.0;
        int less = 0, leq = 0;
        for (int tb = 0; tb < m; tb += NTHREADS) {
            const int t = tb + tid;
            tile[tid] = t < m ? crho[t] : 0.0;
            __syncthreads();
            const int lim = m - tb < NTHREADS ? m - tb : NTHREADS;
            for (int e = 0; e < lim; ++e) {
                const double y = tile[e];
                less += y < x ? 1 : 0;
                leq += y <= x ? 1 : 0;
            }
            __syncthreads();
        }
        if (c < m) {
            if (less <= loi && loi < leq) s_a = x;
            if (less <= hii && hii < leq) s_b = x;
        }
    }
    __syncthreads();
    const double a = s_a, b = s_b;
    const double diff = b - a;
    const double thresh = gamma >= 0.5 ? b - diff * (1.0 - gamma)
                                       : a + diff * gamma;

    // Victim: max est among slow candidates, lowest position on ties.
    double best_e = -INFINITY;
    int best_p = INT32_MAX;
    for (int c = tid; c < m; c += NTHREADS) {
        if (crho[c] < thresh && better(cest[c], cpos[c], best_e, best_p)) {
            best_e = cest[c];
            best_p = cpos[c];
        }
    }
    r_est[tid] = best_e;
    r_pos[tid] = best_p;
    __syncthreads();
    for (int w = NTHREADS / 2; w > 0; w >>= 1) {
        if (tid < w && better(r_est[tid + w], r_pos[tid + w],
                              r_est[tid], r_pos[tid])) {
            r_est[tid] = r_est[tid + w];
            r_pos[tid] = r_pos[tid + w];
        }
        __syncthreads();
    }
    if (tid == 0)
        victim[j] = r_pos[0] == INT32_MAX ? -1 : order[r_pos[0]];
}

// ---------------------------------------------------------------------------
// B4 — sibling reap rows.
// Replaces _reap_kernel (src/repro/accel/pallas_backend.py:191), called
// from _pallas_reap (:318).
// Bound on the card: 12 bytes per row read, 4 written; launch latency
// bounds it (two launches and a memset).
// Design: two passes over the rows, one thread per row. Pass 1 sets an
// integer flag for every task segment holding a completed live attempt
// (any order of the stores gives the same flags); pass 2 marks the live
// running rows of flagged segments.
// ---------------------------------------------------------------------------
__global__ void reap_mark_kernel(const int* __restrict__ a_state,
                                 const int* __restrict__ tseg,
                                 const int* __restrict__ live, int cap,
                                 int* __restrict__ done) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < cap && live[i] == 1 && a_state[i] == 1) {
        const int s = tseg[i];
        if (s >= 0 && s < cap) done[s] = 1;
    }
}

__global__ void reap_emit_kernel(const int* __restrict__ a_state,
                                 const int* __restrict__ tseg,
                                 const int* __restrict__ live, int cap,
                                 const int* __restrict__ done,
                                 int* __restrict__ out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= cap) return;
    const int s = tseg[i];
    const bool hit = live[i] == 1 && a_state[i] == 0 && s >= 0 && s < cap
                     && done[s] == 1;
    out[i] = hit ? 1 : 0;
}

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------
static const size_t kDefaultSmem = 48 * 1024;

extern "C" size_t assess_spatial_smem(int n) {
    return (size_t)(2 * n + NTHREADS) * sizeof(double)
           + (size_t)(2 * n + NTHREADS + NWARPS) * sizeof(int);
}

extern "C" size_t assess_temporal_smem(int n) {
    return (size_t)(2 * n + 2 * NTHREADS) * sizeof(double)
           + (size_t)(n + NTHREADS + NWARPS) * sizeof(int);
}

extern "C" int assess_spatial(const void* rho, const void* node,
                              const void* kind, const void* jls,
                              const void* running, const void* nh, int cap,
                              int n, int k, int jcap, void* fired,
                              void* stream) {
    const size_t smem = assess_spatial_smem(n);
    if (smem > kDefaultSmem) {
        cudaError_t e = cudaFuncSetAttribute(
            spatial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    spatial_kernel<<<jcap, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const double*)rho, (const int*)node, (const int*)kind,
        (const int*)jls, (const int*)running, (const int*)nh, cap, n, k,
        (unsigned char*)fired);
    return (int)cudaGetLastError();
}

extern "C" int assess_temporal(const void* prog, const void* tprog,
                               const void* node, const void* jls,
                               const void* alive, int cap, int n, int jcap,
                               void* zn, void* zp, void* stream) {
    const size_t smem = assess_temporal_smem(n);
    if (smem > kDefaultSmem) {
        cudaError_t e = cudaFuncSetAttribute(
            temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    temporal_kernel<<<jcap, NTHREADS, smem, (cudaStream_t)stream>>>(
        (const double*)prog, (const double*)tprog, (const int*)node,
        (const int*)jls, (const int*)alive, cap, n, (double*)zn,
        (double*)zp);
    return (int)cudaGetLastError();
}

extern "C" int assess_late(const void* prog, const void* start,
                           const void* rate, const void* spec,
                           const void* tseg, const void* jls,
                           const void* running, const void* runatt,
                           const void* order, int cap, int jcap, double now,
                           double min_runtime, double q, double win_factor,
                           void* c_rho, void* c_est, void* c_pos,
                           void* victim, void* win, void* stream) {
    late_kernel<<<jcap, NTHREADS, 0, (cudaStream_t)stream>>>(
        (const double*)prog, (const double*)start, (const double*)rate,
        (const int*)spec, (const int*)tseg, (const int*)jls,
        (const int*)running, (const int*)runatt, (const int*)order, cap,
        now, min_runtime, q, win_factor, (double*)c_rho, (double*)c_est,
        (int*)c_pos, (int*)victim, (int*)win);
    return (int)cudaGetLastError();
}

extern "C" int assess_reap(const void* a_state, const void* tseg,
                           const void* live, int cap, void* done, void* out,
                           void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    cudaError_t e = cudaMemsetAsync(done, 0, (size_t)cap * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    const int blocks = (cap + NTHREADS - 1) / NTHREADS;
    reap_mark_kernel<<<blocks, NTHREADS, 0, s>>>(
        (const int*)a_state, (const int*)tseg, (const int*)live, cap,
        (int*)done);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    reap_emit_kernel<<<blocks, NTHREADS, 0, s>>>(
        (const int*)a_state, (const int*)tseg, (const int*)live, cap,
        (const int*)done, (int*)out);
    return (int)cudaGetLastError();
}
