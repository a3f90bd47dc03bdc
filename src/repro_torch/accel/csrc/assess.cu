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
// Scenario axis (B1, B3, B4). The batched sweep stacks N perturbed copies
// of the padded columns, (N, cap) row-major, and launches each kernel once
// with gridDim.y = N: block (x, y) works on scenario y, offsetting its row,
// job, work-buffer and output pointers by y times their per-scenario
// extent.
// The per-tick path is the same launch with N = 1.
//
// Every entry point launches on the caller's stream, allocates nothing and
// returns cudaGetLastError() (0 on success). B3 keeps its per-call records
// in a work buffer that the wrapper allocates once and reuses.

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
// the order np.nansum uses for k < 8. One launch covers every job of every
// scenario (blockIdx.y); `nh` is shared by all scenarios.
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
    const size_t sc = blockIdx.y;
    rho += sc * cap;
    node += sc * cap;
    kind += sc * cap;
    jls += sc * cap;
    running += sc * cap;
    fired += sc * gridDim.x * (size_t)nb;

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
// under a microsecond of bandwidth at the simulator's sizes; latency
// bounds it: the launch, the walk of each task segment, and each job's
// selection of two order statistics.
// Design: a row pass and a job pass, two launches on the stream.
//   Row pass (late_rows_kernel): a block per LATE_ROWS rows, one thread per
//   row, so each row is read once. Each thread stages its row's columns in
//   shared memory (coalesced loads). Task segments are contiguous runs of
//   equal tseg in canonical order (each pad row is a segment of its own),
//   and the rows of a segment share one job
//   (tests/test_torch_assess_redesign.py checks both on every prep
//   output). The thread at a segment's first row walks the segment in the
//   stage, and on in device memory if it runs past the tile: best running
//   attempt (max zeta, first row wins ties), its start, the
//   has-speculative flag, the running-row count and the winning test's
//   max speculative/original rates. A segment that contributes anything
//   appends one record (job, nrun, win, candidate, rho, est, pos) to its
//   scenario's list, at a slot taken by a warp-aggregated integer atomic.
//   The list's order varies from run to run; nothing below depends on it.
//   Job pass (late_jobs_kernel): a block per job slot reads the list,
//   keeps its job's records (nrun summed and win ORed as integers) and
//   gathers its candidates into shared memory; a job with more than
//   LATE_SMEM_CANDS candidates reads them from the list in device memory
//   instead (the same code on another source). np.percentile's two order
//   statistics are selected exactly by an MSD radix select on the
//   order-preserving uint64 image of rho (8-bit digits, 256-bin shared
//   histograms, stopping once the chosen bucket holds one key), then
//   interpolated with numpy's _lerp. The victim is the slow candidate of
//   largest est, lowest position on ties. The last job block of a scenario
//   resets its counters, so the next launch on the stream finds them at 0
//   (the wrapper zeroes the buffer once, when it allocates it).
//   One launch for both passes (row blocks publishing to job blocks that
//   wait on a counter) measured as fast at N = 1 and twice as slow at
//   N = 64 (PERF.md §6): its blocks held the job pass's shared memory
//   and waited in SM slots that the row blocks needed.
// Hazards:
//   - rho is finite on every path: bprog is a max that NaN never wins, and
//     a candidate has now - start >= min_runtime; an infinite rho would
//     still order correctly (chip_smoke.adversarial_inputs decides ties);
//   - the image orders -0.0 below +0.0, which a sort and a rank count treat
//     as equal: the selected statistic may be the other zero and thresh may
//     differ in its sign bit, but thresh is only compared (rho < thresh),
//     so the victim is the same;
//   - q may be 0 or 100: loi and hii are clamped to [0, m - 1] as numpy's;
//   - job slots with no rows, up to jcap, get victim -1 and win 0;
//   - atomics touch integers only (slots, counts, flags, histograms): no
//     double is summed or compared by an atomic.
// Scenarios (blockIdx.y) share the scalars now/min_runtime/q/win_factor.
// ---------------------------------------------------------------------------
#define LATE_ROWS NTHREADS
#define LATE_SMEM_CANDS 1024
#define LATE_SCAN 4
#define LATE_WIN_BIT (1 << 29)
#define LATE_CAND_BIT (1 << 30)
#define LATE_NRUN_MASK (LATE_WIN_BIT - 1)
// A scenario's counters in the work buffer.
#define LATE_COUNT 0
#define LATE_JOBS_DONE 1
#define LATE_NCOUNTERS 2

struct LateRowsIn {          // one scenario's row columns
    const double* prog;
    const double* start;
    const double* rate;
    const int* spec;
    const int* tseg;
    const int* jls;
    const int* running;
    const int* runatt;
};

struct LateWork {            // one scenario's part of the work buffer
    double* rho;             // records: up to cap (one per segment)
    double* est;
    int2* meta;              // (job, nrun | win bit | candidate bit)
    int* pos;
    int* counters;           // LATE_NCOUNTERS
};

// The buffer: rho and est (N * cap doubles each), meta (N * cap int2),
// pos (N * cap ints), then LATE_NCOUNTERS ints per scenario.
static inline size_t late_work_bytes(int cap, int nscen) {
    const size_t n = (size_t)cap * nscen;
    return n * (2 * sizeof(double) + sizeof(int2) + sizeof(int))
           + (size_t)LATE_NCOUNTERS * nscen * sizeof(int);
}

__device__ __forceinline__ LateWork late_work(void* base, int cap,
                                              int nscen, int sc) {
    const size_t n = (size_t)cap * nscen, o = (size_t)cap * sc;
    double* rho = (double*)base;
    double* est = rho + n;
    int2* meta = (int2*)(est + n);
    int* pos = (int*)(meta + n);
    int* counters = pos + n;
    return {rho + o, est + o, meta + o, pos + o,
            counters + (size_t)LATE_NCOUNTERS * sc};
}

__device__ __forceinline__ LateRowsIn late_rows_at(LateRowsIn in, int cap,
                                                   int sc) {
    const size_t o = (size_t)cap * sc;
    in.prog += o;
    in.start += o;
    in.rate += o;
    in.spec += o;
    in.tseg += o;
    in.jls += o;
    in.running += o;
    in.runatt += o;
    return in;
}

__device__ __forceinline__ bool better(double e1, int p1, double e2, int p2) {
    return e1 > e2 || (e1 == e2 && p1 < p2);
}

// One task segment's walk: what the row pass keeps per segment.
struct SegWalk {
    double bprog = -INFINITY, bstart = 0.0, hi = -INFINITY, lo = -INFINITY;
    int bpos = -1, hspec = 0, nrun = 0, has_spec = 0, has_orig = 0;
    // bits: 1 speculative, 2 running, 4 running attempt (runatt)
    __device__ __forceinline__ void add(double prog, double start,
                                        double rate, int bits, int row) {
        const int sp = bits & 1;
        if (bits & 2) {
            ++nrun;
            if (prog > bprog) {                        // first wins ties
                bprog = prog;
                bpos = row;
                bstart = start;
            }
            hspec |= sp;
        }
        if (bits & 4) {
            if (sp) {
                hi = isnan(hi) ? hi : np_max(rate, hi);
                has_spec = 1;
            } else {
                lo = isnan(lo) ? lo : np_max(rate, lo);
                has_orig = 1;
            }
        }
    }
};

__device__ __forceinline__ int row_bits(const LateRowsIn& in, int r) {
    return (in.spec[r] != 0 ? 1 : 0) | (in.running[r] == 1 ? 2 : 0)
           | (in.runatt[r] == 1 ? 4 : 0);
}

struct LateStage {           // a row tile, staged by the row pass
    double prog[LATE_ROWS], start[LATE_ROWS], rate[LATE_ROWS];
    int tseg[LATE_ROWS], bits[LATE_ROWS];
    int prev;                // tseg of the row before the tile
};

// Row pass over rows [tile * LATE_ROWS, +LATE_ROWS) of one scenario. The
// tile's columns are staged in shared memory by coalesced loads, one row a
// thread; a segment head walks the stage, and on into device memory if its
// segment runs past the tile.
__device__ void late_row_pass(const LateRowsIn in, int cap, int tile,
                              double now, double min_runtime,
                              double win_factor, LateWork w,
                              LateStage* st) {
    const int li = threadIdx.x;
    const int base = tile * LATE_ROWS;
    const int i = base + li;
    const int n = min(LATE_ROWS, cap - base);          // rows in the tile
    if (li < n) {
        st->tseg[li] = in.tseg[i];
        st->prog[li] = in.prog[i];
        st->start[li] = in.start[i];
        st->rate[li] = in.rate[i];
        st->bits[li] = row_bits(in, i);
    }
    if (li == 0) st->prev = base > 0 ? in.tseg[base - 1] : 0;
    __syncthreads();
    int info = 0, job = 0, bpos = -1;
    double rho = 0.0, est = 0.0;
    if (li < n && (i == 0 || (li == 0 ? st->prev : st->tseg[li - 1])
                                 != st->tseg[li])) {
        const int s = st->tseg[li];
        SegWalk g;
        int r = li;
        for (; r < n && st->tseg[r] == s; ++r)
            g.add(st->prog[r], st->start[r], st->rate[r], st->bits[r],
                  base + r);
        if (r == n)
            for (int x = base + n; x < cap && in.tseg[x] == s; ++x)
                g.add(in.prog[x], in.start[x], in.rate[x], row_bits(in, x),
                      x);
        job = in.jls[i];
        bpos = g.bpos;
        const bool win = g.has_spec
                         && (!g.has_orig || g.hi > g.lo * win_factor);
        const bool cand = bpos >= 0 && !g.hspec
                          && (now - g.bstart >= min_runtime);
        if (cand) {
            rho = g.bprog / np_max(now - g.bstart, 1e-9);
            est = (1.0 - g.bprog) / np_max(rho, 1e-9);
        }
        info = g.nrun | (win ? LATE_WIN_BIT : 0)
               | (cand ? LATE_CAND_BIT : 0);
    }
    // One slot atomic per warp for the warp's records.
    const unsigned lane = threadIdx.x & 31u;
    const unsigned ballot = __ballot_sync(0xffffffffu, info != 0);
    if (ballot == 0u) return;                          // warp-uniform
    const int leader = __ffs(ballot) - 1;
    int slot = 0;
    if ((int)lane == leader)
        slot = atomicAdd(w.counters + LATE_COUNT, __popc(ballot));
    slot = __shfl_sync(0xffffffffu, slot, leader);
    if (info != 0) {
        const int c = slot + __popc(ballot & ((1u << lane) - 1u));
        w.meta[c] = make_int2(job, info);
        w.rho[c] = rho;
        w.est[c] = est;
        w.pos[c] = bpos;
    }
}

// rho's order-preserving image: unsigned order of keys = numeric order of
// the doubles (with -0.0 below +0.0), and back.
__device__ __forceinline__ unsigned long long order_key(double x) {
    const unsigned long long b = (unsigned long long)__double_as_longlong(x);
    return (b >> 63) ? ~b : (b | 0x8000000000000000ull);
}

__device__ __forceinline__ double key_value(unsigned long long k) {
    return __longlong_as_double(
        (long long)((k >> 63) ? (k & 0x7fffffffffffffffull) : ~k));
}

// A job's candidates: gathered into shared memory, or (above
// LATE_SMEM_CANDS) the scenario's whole list in device memory, where the
// job's candidates are picked out on every read.
struct CandSrc {
    const double* rho;
    const double* est;
    const int* pos;
    const int2* meta;        // the list's, for the device-memory source
    int n, job;
    __device__ __forceinline__ bool take(int c) const {
        return meta == nullptr
               || (meta[c].x == job && (meta[c].y & LATE_CAND_BIT) != 0);
    }
};

struct LateShared {          // the job pass's shared state
    unsigned int hist[2][256];                 // one pass's, the next's
    unsigned long long last[256];              // a key of each bucket
    unsigned long long prefix, found, min_gt;
    int k, cnt, n_le, m, nrows, win;
};

// The k-th smallest (0-based) image among the source's candidates: MSD
// radix select, 8 bits a pass, on integer histograms. Each pass counts
// the keys that match the digits chosen so far into one of two histogram
// buffers while the other is cleared for the next pass, and notes a key of
// each bucket: when the chosen bucket holds one key, that key is the
// answer and the search ends. Two barriers a pass.
__device__ unsigned long long radix_select(const CandSrc& src, int k,
                                           LateShared* sh) {
    const int tid = threadIdx.x;
    for (int b = tid; b < 256; b += NTHREADS) sh->hist[0][b] = 0u;
    __syncthreads();
    unsigned long long prefix = 0ull;
    for (int shift = 56, buf = 0; shift >= 0; shift -= 8, buf ^= 1) {
        unsigned int* hist = sh->hist[buf];
        const unsigned long long hi_mask =
            shift == 56 ? 0ull : ~0ull << (shift + 8);
        for (int c = tid; c < src.n; c += NTHREADS) {
            if (!src.take(c)) continue;
            const unsigned long long key = order_key(src.rho[c]);
            if ((key & hi_mask) == prefix) {
                const unsigned d = (unsigned)(key >> shift) & 255u;
                atomicAdd(&hist[d], 1u);
                sh->last[d] = key;         // read only if the sole writer
            }
        }
        __syncthreads();
        if (tid < 32) {          // warp 0: the bucket that holds rank k
            unsigned c8[8], tot = 0u;
            for (int b = 0; b < 8; ++b) {
                c8[b] = hist[tid * 8 + b];
                tot += c8[b];
            }
            unsigned incl = tot;
            for (int o = 1; o < 32; o <<= 1) {
                const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
                if (tid >= o) incl += v;
            }
            unsigned run = incl - tot;
            const unsigned kk = (unsigned)k;
            if (run <= kk && kk < incl) {
                for (int b = 0; b < 8; ++b) {
                    if (kk < run + c8[b]) {
                        const int d = tid * 8 + b;
                        sh->prefix = prefix
                                     | ((unsigned long long)d << shift);
                        sh->k = (int)(kk - run);
                        sh->cnt = (int)c8[b];
                        sh->found = sh->last[d];
                        break;
                    }
                    run += c8[b];
                }
            }
        } else {                 // the others clear the next pass's buffer
            for (int b = tid - 32; b < 256; b += NTHREADS - 32)
                sh->hist[buf ^ 1][b] = 0u;
        }
        __syncthreads();
        prefix = sh->prefix;
        k = sh->k;
        if (sh->cnt == 1) return sh->found;            // block-uniform
    }
    return prefix;
}

// The image at rank a's rank + 1 given image a (the rank-k image): a again
// if more than k + 1 images are <= a, else the least image above a.
__device__ unsigned long long next_key(const CandSrc& src,
                                       unsigned long long a, int rank,
                                       LateShared* sh) {
    const int tid = threadIdx.x;
    if (tid == 0) {
        sh->n_le = 0;
        sh->min_gt = ~0ull;
    }
    __syncthreads();
    int le = 0;
    unsigned long long gt = ~0ull;
    for (int c = tid; c < src.n; c += NTHREADS) {
        if (!src.take(c)) continue;
        const unsigned long long key = order_key(src.rho[c]);
        if (key <= a) ++le;
        else if (key < gt) gt = key;
    }
    if (le) atomicAdd(&sh->n_le, le);
    if (gt != ~0ull) atomicMin(&sh->min_gt, gt);
    __syncthreads();
    return rank < sh->n_le ? a : sh->min_gt;
}

// Job pass for job slot j of one scenario; victim/win offset to it.
__device__ void late_job_pass(int j, const LateWork w,
                              const int* __restrict__ order, double q,
                              int* victim, int* win, LateShared* sh,
                              double* c_rho, double* c_est, int* c_pos,
                              double* r_est, int* r_pos) {
    const int tid = threadIdx.x;
    if (tid == 0) {
        sh->m = 0;
        sh->nrows = 0;
        sh->win = 0;
    }
    __syncthreads();
    const int count = w.counters[LATE_COUNT];
    int nrows = 0, wn = 0;
    // LATE_SCAN records a thread in flight: their loads issue together.
    for (int c0 = tid; c0 < count; c0 += LATE_SCAN * NTHREADS) {
        int2 mt[LATE_SCAN];
#pragma unroll
        for (int u = 0; u < LATE_SCAN; ++u) {
            const int c = c0 + u * NTHREADS;
            mt[u] = c < count ? w.meta[c] : make_int2(-1, 0);
        }
#pragma unroll
        for (int u = 0; u < LATE_SCAN; ++u) {
            if (mt[u].x != j) continue;
            const int c = c0 + u * NTHREADS;
            nrows += mt[u].y & LATE_NRUN_MASK;
            wn |= (mt[u].y & LATE_WIN_BIT) != 0;
            if (mt[u].y & LATE_CAND_BIT) {
                const int s = atomicAdd(&sh->m, 1);
                if (s < LATE_SMEM_CANDS) {
                    c_rho[s] = w.rho[c];
                    c_est[s] = w.est[c];
                    c_pos[s] = w.pos[c];
                }
            }
        }
    }
    if (nrows) atomicAdd(&sh->nrows, nrows);
    if (wn) atomicOr(&sh->win, 1);
    __syncthreads();
    const int m = sh->m;
    if (tid == 0) win[j] = sh->win;
    if (sh->nrows < 2 || m < 2) {                      // block-uniform
        if (tid == 0) victim[j] = -1;
        return;
    }
    const CandSrc src = m <= LATE_SMEM_CANDS
        ? CandSrc{c_rho, c_est, c_pos, nullptr, m, j}
        : CandSrc{w.rho, w.est, w.pos, w.meta, count, j};

    // np.percentile(rho, q), 'linear': virtual index (m-1)*q/100.
    const double v = (double)(m - 1) * (q / 100.0);
    const double flo = floor(v);
    const double gamma = v - flo;
    int loi = (int)flo;
    loi = loi < 0 ? 0 : (loi > m - 1 ? m - 1 : loi);
    const int hii = loi + 1 > m - 1 ? m - 1 : loi + 1;
    const unsigned long long ka = radix_select(src, loi, sh);
    const unsigned long long kb = hii == loi ? ka : next_key(src, ka, hii, sh);
    const double a = key_value(ka), b = key_value(kb);
    const double diff = b - a;
    const double thresh = gamma >= 0.5 ? b - diff * (1.0 - gamma)
                                       : a + diff * gamma;

    // Victim: max est among slow candidates, lowest position on ties.
    double best_e = -INFINITY;
    int best_p = INT32_MAX;
    for (int c = tid; c < src.n; c += NTHREADS) {
        if (!src.take(c)) continue;
        const double e = src.est[c];
        const int p = src.pos[c];
        if (src.rho[c] < thresh && better(e, p, best_e, best_p)) {
            best_e = e;
            best_p = p;
        }
    }
    r_est[tid] = best_e;
    r_pos[tid] = best_p;
    __syncthreads();
    for (int s = NTHREADS / 2; s > 0; s >>= 1) {
        if (tid < s && better(r_est[tid + s], r_pos[tid + s],
                              r_est[tid], r_pos[tid])) {
            r_est[tid] = r_est[tid + s];
            r_pos[tid] = r_pos[tid + s];
        }
        __syncthreads();
    }
    if (tid == 0)
        victim[j] = r_pos[0] == INT32_MAX ? -1 : order[r_pos[0]];
}

// End of a job block: the last of the scenario's jcap job blocks resets
// its counters for the next launch on the stream (every block has read
// the record count by then).
__device__ __forceinline__ void late_job_finish(const LateWork w, int jcap) {
    __syncthreads();
    if (threadIdx.x == 0) {
        __threadfence();
        if (atomicAdd(w.counters + LATE_JOBS_DONE, 1) == jcap - 1) {
            w.counters[LATE_COUNT] = 0;
            w.counters[LATE_JOBS_DONE] = 0;
        }
    }
}

__global__ void __launch_bounds__(NTHREADS)
late_rows_kernel(LateRowsIn in, int cap, double now, double min_runtime,
                 double win_factor, void* work) {
    __shared__ LateStage stage;
    const int sc = blockIdx.y;
    late_row_pass(late_rows_at(in, cap, sc), cap, blockIdx.x, now,
                  min_runtime, win_factor,
                  late_work(work, cap, gridDim.y, sc), &stage);
}

__global__ void __launch_bounds__(NTHREADS)
late_jobs_kernel(const int* __restrict__ order, int cap, int jcap, double q,
                 void* work, int* victim, int* win) {
    __shared__ LateShared sh;
    __shared__ double c_rho[LATE_SMEM_CANDS], c_est[LATE_SMEM_CANDS];
    __shared__ int c_pos[LATE_SMEM_CANDS];
    __shared__ double r_est[NTHREADS];
    __shared__ int r_pos[NTHREADS];
    const int sc = blockIdx.y;
    const LateWork w = late_work(work, cap, gridDim.y, sc);
    late_job_pass(blockIdx.x, w, order + (size_t)sc * cap, q,
                  victim + (size_t)sc * jcap, win + (size_t)sc * jcap, &sh,
                  c_rho, c_est, c_pos, r_est, r_pos);
    late_job_finish(w, jcap);
}

// ---------------------------------------------------------------------------
// B4 — sibling reap rows.
// Replaces _reap_kernel (src/repro/accel/pallas_backend.py:191), called
// from _pallas_reap (:318).
// Bound on the card: 12 bytes per row read, 4 written; launch latency
// bounds it.
// Design: one launch, one thread per row, a block per REAP_TILE rows, no
// scratch in device memory. Task segments are contiguous runs of equal
// tseg (see B3). Each warp ballots the rows that start a segment; a
// prefix count of those heads over the block numbers the tile's segments
// (0 is the segment carried in from the tile before), and each row whose
// attempt completed sets its segment's flag in shared memory (every store
// writes 1, so their order does not matter). The first and last segment
// of a tile may cross its edges: thread 0 walks left, and the tile's last
// row walks right, in global memory until the run ends or a completed
// attempt is found. Each live running row then reads its own segment's
// flag. Rows whose tseg lies outside [0, cap) are never marked and never
// emitted. Scenario y of the grid offsets rows and output by y * cap.
// ---------------------------------------------------------------------------
#define REAP_TILE 1024

__device__ __forceinline__ bool reap_done(const int* __restrict__ a_state,
                                          const int* __restrict__ tseg,
                                          const int* __restrict__ live,
                                          int r, int cap) {
    const int s = tseg[r];
    return live[r] == 1 && a_state[r] == 1 && s >= 0 && s < cap;
}

__global__ void __launch_bounds__(REAP_TILE)
reap_kernel(const int* __restrict__ a_state, const int* __restrict__ tseg,
            const int* __restrict__ live, int cap, int* __restrict__ out) {
    __shared__ int seg_done[REAP_TILE + 1];
    __shared__ int warp_base[REAP_TILE / 32];
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int base = blockIdx.x * REAP_TILE;
    const int i = base + tid;
    const size_t off = blockIdx.y * (size_t)cap;
    a_state += off;
    tseg += off;
    live += off;
    out += off;
    const bool in = i < cap;
    const int s = in ? tseg[i] : 0;
    const int st = in ? a_state[i] : 0;
    const bool lv = in && live[i] == 1;
    const bool valid = s >= 0 && s < cap;
    const bool head = in && (i == 0 || tseg[i - 1] != s);
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    seg_done[tid] = 0;
    if (tid == 0) seg_done[REAP_TILE] = 0;
    if (lane == 0) warp_base[warp] = __popc(heads);
    __syncthreads();
    if (warp == 0) {          // exclusive prefix of the warps' head counts
        const int c = warp_base[lane];
        int incl = c;
        for (int o = 1; o < 32; o <<= 1) {
            const int v = __shfl_up_sync(0xffffffffu, incl, o);
            if (lane >= o) incl += v;
        }
        warp_base[lane] = incl - c;
    }
    __syncthreads();
    // This row's segment within the tile: the heads at or before it.
    const int id = warp_base[warp]
                   + __popc(heads & (0xffffffffu >> (31 - lane)));
    if (lv && st == 1 && valid) seg_done[id] = 1;
    const int end = min(base + REAP_TILE, cap);       // past the tile
    if (tid == 0 && !head) {                           // id 0, from the left
        for (int r = base - 1; r >= 0 && tseg[r] == s; --r)
            if (reap_done(a_state, tseg, live, r, cap)) {
                seg_done[0] = 1;
                break;
            }
    }
    if (i == end - 1 && end < cap && tseg[end] == s) { // into the next tile
        for (int r = end; r < cap && tseg[r] == s; ++r)
            if (reap_done(a_state, tseg, live, r, cap)) {
                seg_done[id] = 1;
                break;
            }
    }
    __syncthreads();
    if (in) out[i] = (lv && st == 0 && valid && seg_done[id]) ? 1 : 0;
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
                              int n, int k, int jcap, int nscen, void* fired,
                              void* stream) {
    const size_t smem = assess_spatial_smem(n);
    if (smem > kDefaultSmem) {
        cudaError_t e = cudaFuncSetAttribute(
            spatial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    spatial_kernel<<<dim3(jcap, nscen), NTHREADS, smem,
                     (cudaStream_t)stream>>>(
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

extern "C" size_t assess_late_work_bytes(int cap, int nscen) {
    return late_work_bytes(cap, nscen);
}

// The wrappers' copies of these are checked when the library loads.
extern "C" int assess_late_rows() { return LATE_ROWS; }
extern "C" int assess_late_smem_cands() { return LATE_SMEM_CANDS; }
extern "C" int assess_reap_tile() { return REAP_TILE; }

// `work` holds assess_late_work_bytes(cap, nscen) bytes, zeroed before its
// first launch and used by one stream at a time; each call leaves its
// counters at 0 again. Two launches: the row pass, then the job pass.
extern "C" int assess_late(const void* prog, const void* start,
                           const void* rate, const void* spec,
                           const void* tseg, const void* jls,
                           const void* running, const void* runatt,
                           const void* order, int cap, int jcap, int nscen,
                           double now, double min_runtime, double q,
                           double win_factor, void* work, void* victim,
                           void* win, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const LateRowsIn in = {(const double*)prog, (const double*)start,
                           (const double*)rate, (const int*)spec,
                           (const int*)tseg, (const int*)jls,
                           (const int*)running, (const int*)runatt};
    const int ntiles = (cap + LATE_ROWS - 1) / LATE_ROWS;
    late_rows_kernel<<<dim3(ntiles, nscen), NTHREADS, 0, s>>>(
        in, cap, now, min_runtime, win_factor, work);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    late_jobs_kernel<<<dim3(jcap, nscen), NTHREADS, 0, s>>>(
        (const int*)order, cap, jcap, q, work, (int*)victim, (int*)win);
    return (int)cudaGetLastError();
}

extern "C" int assess_reap(const void* a_state, const void* tseg,
                           const void* live, int cap, int nscen, void* out,
                           void* stream) {
    reap_kernel<<<dim3((cap + REAP_TILE - 1) / REAP_TILE, nscen), REAP_TILE,
                  0, (cudaStream_t)stream>>>(
        (const int*)a_state, (const int*)tseg, (const int*)live, cap,
        (int*)out);
    return (int)cudaGetLastError();
}
