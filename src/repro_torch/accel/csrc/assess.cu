// Assessment kernels of the speculation loop, hand-written for Hopper
// (sm_90a), with a plain C interface for ctypes.
//
// Build (repro_torch/accel/kernels.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
//        -shared -Xcompiler -fPIC -o libassess.so assess.cu
//
// Exactness contract: every result equals the numpy reference backend bit
// for bit, not within a tolerance.
//   - Each float64 bucket is summed as ONE chain of adds, visiting rows
//     in canonical order: the association order of np.bincount. One
//     thread adds at a time (B1 and B2 hand the chain from lane to lane
//     of one warp, between slices, behind __syncwarp). No atomics touch a
//     double.
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
// returns cudaGetLastError() (0 on success). B1, B2 and B3 keep their
// per-call records in work buffers that the wrapper allocates once and
// reuses.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define NTHREADS 256
#define NWARPS (NTHREADS / 32)

// np.maximum(x, c) for a constant c: NaN propagates from x.
__device__ __forceinline__ double np_max(double x, double c) {
    return (isnan(x) || x > c) ? x : c;
}

// In-place exclusive prefix sum of a[0, len) over the block; every thread
// calls it. Each thread sums a contiguous span, the warps scan the span
// sums by shuffles, and warp_tot (NWARPS ints) carries the warp totals.
__device__ void block_exclusive_scan(int* a, int len, int* warp_tot) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int per = (len + NTHREADS - 1) / NTHREADS;
    const int lo = min(tid * per, len), hi = min(lo + per, len);
    int sum = 0;
    for (int x = lo; x < hi; ++x) sum += a[x];
    int incl = sum;
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += y;
    }
    if (lane == 31) warp_tot[warp] = incl;
    __syncthreads();
    int run = incl - sum;
    for (int w = 0; w < warp; ++w) run += warp_tot[w];
    for (int x = lo; x < hi; ++x) {
        const int c = a[x];
        a[x] = run;
        run += c;
    }
    __syncthreads();         // a and warp_tot are read by the next step
}

// ---------------------------------------------------------------------------
// B1 — Eq. 1 spatial pass, and B2 — Eq. 2-3 zeta sums: the glance.
// B1 replaces _spatial_kernel (src/repro/accel/pallas_backend.py:51), called
// from _pallas_spatial (:223); B2 replaces _temporal_kernel (:85), called
// from _pallas_temporal (:245).
// Bound on the card: B1 reads ~24 bytes per row and writes 2n bytes per
// job, B2 ~28 bytes per row and 16n bytes per job; at the simulator's sizes
// (a few thousand rows, 1000 nodes) that is under a microsecond of
// bandwidth. Latency bounds both: two launches, a row tile's barriers, and
// each group's ordered sums.
// Both sum float64 values into buckets (group, node), where a group is a
// (job, phase) for B1 (g = 2 * job + phase, so B1's (jcap, 2, n) output is
// (G, n)) and a job for B2; every bucket's sum is one chain of adds in
// canonical row order, from 0.0, as np.bincount's. Rows of a job need
// not be contiguous. Two launches on the stream, no atomics:
//   Row pass (*_rows_kernel): a block per GLANCE_ROWS rows, one thread a
//   row, so each row is read once (coalesced). A used row (the kernel's
//   mask, its group and node in range) becomes a record (node, value(s)).
//   The tile's records are binned by group, stably: each warp matches its
//   lanes by group (__match_any_sync), and the warps, in row order, take
//   their ranks from a shared count per group; an exclusive scan of the
//   counts gives each group's offset in the tile's region of the record
//   list, and the G + 1 offsets go to the tile's row of a table.
//   Group pass (*_jobs_kernel): a block per group reads its segment's
//   offset and length in every tile (one column of the table), scans the
//   lengths, and gathers its m records in row order, GLANCE_CHUNK at a
//   time, into shared memory (a binary search over the tile prefix maps
//   each record to its tile). So its work grows with its own rows, not
//   with cap. Warp 0 then walks the chunk 32 records at a time: lanes
//   holding one node match, and the lowest of them adds its peers' values
//   to the node's sum in lane (= row) order, so every bucket's sum is one
//   left-to-right chain. A group with no record writes its empty output
//   (all false; NaN) and returns.
// The bucket table of a group is n sums (B2: 2n) and n counts. It lives
// in shared memory beside a fixed stage where both fit a block (B1 to
// about 18,800 nodes, B2 to about 13,000); above that the table moves to
// device memory, one table per (scenario, group) block after the records
// and offset tables of the work buffer, and only the stage stays in
// shared memory. The table's reads and writes are the same in both
// places (warp 0 alone adds, behind __syncwarp; the block reads after a
// barrier, which orders device memory as it does shared), so every
// bucket's chain of adds and every result is the same bits.
// B1 then takes P = sum / count per node (NaN where empty) and, for each
// node with a P, the neighbourhood mean and sigma as left-to-right sums
// over k, the order np.nansum uses for k < 8. Scenario y of the grid
// (B1's sweep) offsets rows, records, table and output by y times their
// per-scenario extent; `nh` is shared by all scenarios.
// No scratch per call: the records and the table live in a work buffer the
// wrapper allocates once per (device, stream, size) and reuses. Each call
// rewrites every table entry and every record it reads, so nothing is reset
// or zeroed between calls.
// ---------------------------------------------------------------------------
#define GLANCE_ROWS NTHREADS
#define GLANCE_CHUNK 512

// One scenario's part of the work buffer: the records, in tile regions of
// GLANCE_ROWS (each tile's records first, grouped), and the table of each
// tile's G + 1 group offsets.
template <int NV>
struct GlanceWork {
    double* val[NV];
    int* node;
    int* tab;
};

__host__ __device__ __forceinline__ int glance_tiles(int cap) {
    return (cap + GLANCE_ROWS - 1) / GLANCE_ROWS;
}

// The buffer: NV value columns (N * ntiles * GLANCE_ROWS doubles each), the
// node column (as many ints), then N tables of ntiles * (G + 1) ints.
template <int NV>
static inline size_t glance_work_bytes(int cap, int G, int nscen) {
    const size_t ntiles = glance_tiles(cap);
    const size_t recs = ntiles * GLANCE_ROWS * nscen;
    return recs * (NV * sizeof(double) + sizeof(int))
           + ntiles * (G + 1) * nscen * sizeof(int);
}

template <int NV>
__device__ __forceinline__ GlanceWork<NV> glance_work(void* base, int cap,
                                                      int G, int nscen,
                                                      int sc) {
    const size_t ntiles = glance_tiles(cap);
    const size_t recs = ntiles * GLANCE_ROWS;
    const size_t all = recs * nscen;
    GlanceWork<NV> w;
    double* v = (double*)base;
    for (int k = 0; k < NV; ++k) w.val[k] = v + k * all + sc * recs;
    int* node = (int*)(v + NV * all);
    w.node = node + sc * recs;
    w.tab = node + all + sc * ntiles * (G + 1);
    return w;
}

struct SpatialRowsIn {       // B1's row columns
    const double* rho;
    const int* node;
    const int* kind;
    const int* jls;
    const int* running;
    __device__ __forceinline__ SpatialRowsIn at(int cap, int sc) const {
        const size_t o = (size_t)cap * sc;
        return {rho + o, node + o, kind + o, jls + o, running + o};
    }
    // Row i's group (-1: not used), node and value.
    __device__ __forceinline__ int group(int i, int n, int G, int* v,
                                         double* val) const {
        if (running[i] != 1) return -1;
        const int ph = kind[i], nd = node[i], j = jls[i];
        if (ph < 0 || ph > 1 || nd < 0 || nd >= n || j < 0
            || 2 * j + ph >= G)
            return -1;
        *v = nd;
        val[0] = rho[i];
        return 2 * j + ph;
    }
};

struct TemporalRowsIn {      // B2's row columns
    const double* prog;
    const double* tprog;
    const int* node;
    const int* jls;
    const int* alive;
    __device__ __forceinline__ TemporalRowsIn at(int cap, int sc) const {
        const size_t o = (size_t)cap * sc;
        return {prog + o, tprog + o, node + o, jls + o, alive + o};
    }
    __device__ __forceinline__ int group(int i, int n, int G, int* v,
                                         double* val) const {
        if (alive[i] != 1) return -1;
        const int nd = node[i], j = jls[i];
        if (nd < 0 || nd >= n || j < 0 || j >= G) return -1;
        *v = nd;
        val[0] = prog[i];
        val[1] = tprog[i];
        return j;
    }
};

// Row pass over tile blockIdx.x of one scenario. s_cnt holds G + 1 ints,
// warp_tot NWARPS.
template <int NV, class In>
__device__ void glance_row_pass(const In in, int cap, int n, int G,
                                GlanceWork<NV> w, int* s_cnt,
                                int* warp_tot) {
    const int tid = threadIdx.x;
    const int lane = tid & 31, warp = tid >> 5;
    const int t = blockIdx.x;
    const int i = t * GLANCE_ROWS + tid;
    int g = -1, v = 0;
    double val[NV] = {};
    if (i < cap) g = in.group(i, n, G, &v, val);
    for (int x = tid; x <= G; x += NTHREADS) s_cnt[x] = 0;
    __syncthreads();
    // The row's rank among the tile's rows of its group: the warps before
    // it (in turn, in row order), then the lanes before it in its warp.
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const int leader = __ffs(peers) - 1;
    int before = 0;
    for (int k = 0; k < NWARPS; ++k) {
        if (warp == k && g >= 0 && lane == leader) {
            before = s_cnt[g];
            s_cnt[g] = before + __popc(peers);
        }
        __syncthreads();
    }
    before = __shfl_sync(0xffffffffu, before, leader)
             + __popc(peers & ((1u << lane) - 1u));
    block_exclusive_scan(s_cnt, G + 1, warp_tot);   // s_cnt[G]: the total
    int* tab = w.tab + (size_t)t * (G + 1);
    for (int x = tid; x <= G; x += NTHREADS) tab[x] = s_cnt[x];
    if (g >= 0) {
        const size_t slot = (size_t)t * GLANCE_ROWS + s_cnt[g] + before;
        w.node[slot] = v;
        for (int k = 0; k < NV; ++k) w.val[k][slot] = val[k];
    }
}

// The shared state of a group block: the bucket table (NV * n sums and n
// counts, int for B1, a flag byte for B2), the stage and the tile prefix.
template <int NV, typename C>
struct GlanceShared {
    double* acc;             // NV * n
    double* st_val;          // NV * GLANCE_CHUNK
    int* st_node;            // GLANCE_CHUNK
    int* pre;                // ntiles + 1: the group's records before tile t
    int* sbase;              // ntiles: where its segment of tile t starts
    int* warp_tot;           // NWARPS
    C* cnt;                  // n
};

// Largest dynamic shared memory a block may take on Hopper (227 KB).
#define GLANCE_MAX_SMEM 232448

// The stage, tile prefix and scan space of a group block.
static inline size_t glance_stage_smem(int NV, int cap) {
    return (size_t)NV * GLANCE_CHUNK * sizeof(double)
           + (size_t)(GLANCE_CHUNK + 2 * glance_tiles(cap) + 1 + NWARPS)
             * sizeof(int);
}

// One group's bucket table: NV * n sums and n counts, in 8-byte words.
template <int NV, typename C>
__host__ __device__ __forceinline__ size_t glance_table_words(int n) {
    return ((size_t)NV * n * sizeof(double) + (size_t)n * sizeof(C) + 7) / 8;
}

template <int NV, typename C>
static inline bool glance_table_in_smem(int n, int cap) {
    return glance_stage_smem(NV, cap) + glance_table_words<NV, C>(n) * 8
           <= GLANCE_MAX_SMEM;
}

// The group pass's dynamic shared memory: stage and table where both fit,
// else the stage alone.
template <int NV, typename C>
static inline size_t glance_jobs_smem(int n, int cap) {
    if (!glance_table_in_smem<NV, C>(n, cap))
        return glance_stage_smem(NV, cap);
    return (size_t)NV * (n + GLANCE_CHUNK) * sizeof(double)
           + (size_t)(GLANCE_CHUNK + 2 * glance_tiles(cap) + 1 + NWARPS)
             * sizeof(int)
           + (size_t)n * sizeof(C);
}

// Bytes of the device-memory tables of G groups in each of nscen
// scenarios (0 where the table fits in shared memory), and where they
// start in the work buffer: after the records and offset tables, at a
// 16-byte boundary.
template <int NV, typename C>
static inline size_t glance_table_bytes(int n, int cap, int G, int nscen) {
    if (glance_table_in_smem<NV, C>(n, cap)) return 0;
    return glance_table_words<NV, C>(n) * 8 * (size_t)G * nscen + 16;
}

static inline size_t glance_table_offset(size_t work_bytes) {
    return (work_bytes + 15) / 16 * 16;
}

// `table`: this block's table in device memory, or null to keep it in
// shared memory before the stage.
template <int NV, typename C>
__device__ __forceinline__ GlanceShared<NV, C> glance_shared(void* smem,
                                                             int n,
                                                             int ntiles,
                                                             double* table) {
    GlanceShared<NV, C> s;
    if (table) {
        s.acc = table;
        s.st_val = (double*)smem;
    } else {
        s.acc = (double*)smem;
        s.st_val = s.acc + NV * n;
    }
    s.st_node = (int*)(s.st_val + NV * GLANCE_CHUNK);
    s.pre = s.st_node + GLANCE_CHUNK;
    s.sbase = s.pre + ntiles + 1;
    s.warp_tot = s.sbase + ntiles;
    s.cnt = table ? (C*)(table + NV * n) : (C*)(s.warp_tot + NWARPS);
    return s;
}

// Block (g, sc)'s table among the device-memory tables, or null.
template <int NV, typename C>
__device__ __forceinline__ double* glance_block_table(double* tables, int n,
                                                      int G, int sc, int g) {
    if (!tables) return nullptr;
    return tables + ((size_t)sc * G + g) * glance_table_words<NV, C>(n);
}

// Warp 0's walk of a staged chunk of len records, in row order: the lanes
// of one node match, and the lowest adds its peers' values in lane order.
template <int NV, typename C>
__device__ void glance_accumulate(const GlanceShared<NV, C>& s, int len,
                                  int n) {
    const int lane = threadIdx.x & 31;
    for (int e0 = 0; e0 < len; e0 += 32) {
        const int e = e0 + lane;
        const int v = e < len ? s.st_node[e] : -1 - lane;   // unmatched
        const unsigned peers = __match_any_sync(0xffffffffu, v);
        if (e < len && lane == __ffs(peers) - 1) {
            double a[NV];
            for (int k = 0; k < NV; ++k) a[k] = s.acc[k * n + v];
            for (unsigned p = peers; p; p &= p - 1u) {
                const int l = e0 + __ffs(p) - 1;
                for (int k = 0; k < NV; ++k)
                    a[k] = a[k] + s.st_val[k * GLANCE_CHUNK + l];
            }
            for (int k = 0; k < NV; ++k) s.acc[k * n + v] = a[k];
            s.cnt[v] = sizeof(C) == 1 ? (C)1 : (C)(s.cnt[v] + __popc(peers));
        }
        __syncwarp();        // the next slice's leader may be another lane
    }
}

// Group pass for group blockIdx.x of one scenario: the bucket table of its
// records. Returns the record count m; with m = 0 the table is untouched.
template <int NV, typename C>
__device__ int glance_group_pass(const GlanceWork<NV> w, int G, int ntiles,
                                 int n, const GlanceShared<NV, C>& s) {
    const int tid = threadIdx.x;
    const int g = blockIdx.x;
    for (int t = tid; t < ntiles; t += NTHREADS) {
        const int* row = w.tab + (size_t)t * (G + 1);
        const int a = row[g];
        s.pre[t] = row[g + 1] - a;
        s.sbase[t] = t * GLANCE_ROWS + a;
    }
    if (tid == 0) s.pre[ntiles] = 0;
    __syncthreads();
    block_exclusive_scan(s.pre, ntiles + 1, s.warp_tot);
    const int m = s.pre[ntiles];
    if (m == 0) return 0;                              // block-uniform
    for (int v = tid; v < n; v += NTHREADS) {
        for (int k = 0; k < NV; ++k) s.acc[k * n + v] = 0.0;
        s.cnt[v] = 0;
    }
    for (int c0 = 0; c0 < m; c0 += GLANCE_CHUNK) {
        const int len = min(GLANCE_CHUNK, m - c0);
        for (int e = tid; e < len; e += NTHREADS) {
            const int k = c0 + e;
            int lo = 0, hi = ntiles;                   // pre[lo] <= k < pre[hi]
            while (hi - lo > 1) {
                const int mid = (lo + hi) >> 1;
                if (s.pre[mid] <= k) lo = mid;
                else hi = mid;
            }
            const size_t slot = (size_t)s.sbase[lo] + (k - s.pre[lo]);
            s.st_node[e] = w.node[slot];
            for (int q = 0; q < NV; ++q)
                s.st_val[q * GLANCE_CHUNK + e] = w.val[q][slot];
        }
        __syncthreads();
        if (tid < 32) glance_accumulate(s, len, n);
        __syncthreads();
    }
    return m;
}

// Eq. 1 for a node with P = Pv (not NaN) among the group's P: the
// neighbourhood's valid count, mean and sigma, left-to-right over k.
__device__ __forceinline__ bool eq1_hit(const double* P, const int* row,
                                        int k, double Pv) {
    int cnt = 0;
    double s = 0.0;
    for (int kk = 0; kk < k; ++kk) {
        const double x = P[row[kk]];
        const bool valid = !isnan(x);
        cnt += valid ? 1 : 0;
        const double xv = valid ? x : 0.0;
        s = (kk == 0) ? xv : s + xv;
    }
    const double denom = (double)(cnt > 1 ? cnt : 1);
    const double mean = s / denom;
    double vs = 0.0;
    for (int kk = 0; kk < k; ++kk) {
        const double x = P[row[kk]];
        const double d = x - mean;
        const double sq = isnan(x) ? 0.0 : d * d;
        vs = (kk == 0) ? sq : vs + sq;
    }
    const double sd = sqrt(vs / denom);
    return cnt >= 2 && (Pv < mean - sd);
}

__global__ void __launch_bounds__(NTHREADS)
spatial_rows_kernel(SpatialRowsIn in, int cap, int n, int G, void* work) {
    extern __shared__ int s_rows[];                    // G + 1, NWARPS
    const int sc = blockIdx.y;
    glance_row_pass<1>(in.at(cap, sc), cap, n, G,
                       glance_work<1>(work, cap, G, gridDim.y, sc), s_rows,
                       s_rows + G + 1);
}

__global__ void __launch_bounds__(NTHREADS)
spatial_jobs_kernel(const int* __restrict__ nh, int cap, int n, int k,
                    int G, void* work, double* tables,
                    unsigned char* __restrict__ fired) {
    extern __shared__ double s_jobs[];
    const int sc = blockIdx.y, g = blockIdx.x, tid = threadIdx.x;
    const int ntiles = glance_tiles(cap);
    const GlanceShared<1, int> s = glance_shared<1, int>(
        s_jobs, n, ntiles, glance_block_table<1, int>(tables, n, G, sc, g));
    const int m = glance_group_pass(
        glance_work<1>(work, cap, G, gridDim.y, sc), G, ntiles, n, s);
    unsigned char* out = fired + ((size_t)sc * G + g) * n;
    if (m == 0) {                                      // block-uniform
        for (int v = tid; v < n; v += NTHREADS) out[v] = 0;
        return;
    }
    // P = mean rho per node, NaN where the bucket is empty.
    for (int v = tid; v < n; v += NTHREADS)
        s.acc[v] = s.cnt[v] > 0 ? s.acc[v] / (double)s.cnt[v] : (double)NAN;
    __syncthreads();
    for (int v = tid; v < n; v += NTHREADS) {
        const double P = s.acc[v];
        out[v] = !isnan(P) && eq1_hit(s.acc, nh + (size_t)v * k, k, P);
    }
}

__global__ void __launch_bounds__(NTHREADS)
temporal_rows_kernel(TemporalRowsIn in, int cap, int n, int G, void* work) {
    extern __shared__ int s_rows[];
    glance_row_pass<2>(in, cap, n, G, glance_work<2>(work, cap, G, 1, 0),
                       s_rows, s_rows + G + 1);
}

__global__ void __launch_bounds__(NTHREADS)
temporal_jobs_kernel(int cap, int n, int G, void* work, double* tables,
                     double* __restrict__ zn, double* __restrict__ zp) {
    extern __shared__ double s_jobs[];
    const int g = blockIdx.x, tid = threadIdx.x;
    const int ntiles = glance_tiles(cap);
    const GlanceShared<2, unsigned char> s = glance_shared<2, unsigned char>(
        s_jobs, n, ntiles,
        glance_block_table<2, unsigned char>(tables, n, G, 0, g));
    const int m = glance_group_pass(glance_work<2>(work, cap, G, 1, 0), G,
                                    ntiles, n, s);
    zn += (size_t)g * n;
    zp += (size_t)g * n;
    for (int v = tid; v < n; v += NTHREADS) {         // NaN: no attempt
        const bool have = m > 0 && s.cnt[v];
        zn[v] = have ? s.acc[v] : (double)NAN;
        zp[v] = have ? s.acc[n + v] : (double)NAN;
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

static inline size_t glance_rows_smem(int G) {
    return (size_t)(G + 1 + NWARPS) * sizeof(int);
}

// Shared memory the larger of a glance kernel's two launches takes.
extern "C" size_t assess_spatial_smem(int n, int jcap, int cap) {
    const size_t jobs = glance_jobs_smem<1, int>(n, cap);
    const size_t rows = glance_rows_smem(2 * jcap);
    return jobs > rows ? jobs : rows;
}

extern "C" size_t assess_temporal_smem(int n, int jcap, int cap) {
    const size_t jobs = glance_jobs_smem<2, unsigned char>(n, cap);
    const size_t rows = glance_rows_smem(jcap);
    return jobs > rows ? jobs : rows;
}

extern "C" size_t assess_spatial_work_bytes(int cap, int jcap, int nscen) {
    return glance_work_bytes<1>(cap, 2 * jcap, nscen);
}

extern "C" size_t assess_temporal_work_bytes(int cap, int jcap) {
    return glance_work_bytes<2>(cap, jcap, 1);
}

// Bytes the work buffer needs beyond assess_*_work_bytes for the group
// tables in device memory: 0 where a group's table fits in shared memory.
extern "C" size_t assess_spatial_table_bytes(int n, int jcap, int cap,
                                             int nscen) {
    return glance_table_bytes<1, int>(n, cap, 2 * jcap, nscen);
}

extern "C" size_t assess_temporal_table_bytes(int n, int jcap, int cap) {
    return glance_table_bytes<2, unsigned char>(n, cap, jcap, 1);
}

// Raise a kernel's dynamic shared memory limit where it needs more than
// the default.
static cudaError_t allow_smem(const void* kernel, size_t smem) {
    if (smem <= kDefaultSmem) return cudaSuccess;
    return cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// `work` holds assess_spatial_work_bytes(cap, jcap, nscen) +
// assess_spatial_table_bytes(n, jcap, cap, nscen) bytes, used by one
// stream at a time; no part of it needs to be set before a call. Two
// launches: the row pass, then the group pass (a block per (job, phase)).
extern "C" int assess_spatial(const void* rho, const void* node,
                              const void* kind, const void* jls,
                              const void* running, const void* nh, int cap,
                              int n, int k, int jcap, int nscen, void* work,
                              void* fired, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int G = 2 * jcap;
    const size_t rows_smem = glance_rows_smem(G);
    const size_t jobs_smem = glance_jobs_smem<1, int>(n, cap);
    cudaError_t e = allow_smem((const void*)spatial_rows_kernel, rows_smem);
    if (e == cudaSuccess)
        e = allow_smem((const void*)spatial_jobs_kernel, jobs_smem);
    if (e != cudaSuccess) return (int)e;
    const SpatialRowsIn in = {(const double*)rho, (const int*)node,
                              (const int*)kind, (const int*)jls,
                              (const int*)running};
    spatial_rows_kernel<<<dim3(glance_tiles(cap), nscen), NTHREADS,
                          rows_smem, s>>>(in, cap, n, G, work);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    double* tables = nullptr;
    if (!glance_table_in_smem<1, int>(n, cap))
        tables = (double*)((char*)work + glance_table_offset(
            glance_work_bytes<1>(cap, G, nscen)));
    spatial_jobs_kernel<<<dim3(G, nscen), NTHREADS, jobs_smem, s>>>(
        (const int*)nh, cap, n, k, G, work, tables, (unsigned char*)fired);
    return (int)cudaGetLastError();
}

// `work` holds assess_temporal_work_bytes(cap, jcap) +
// assess_temporal_table_bytes(n, jcap, cap) bytes, as above.
extern "C" int assess_temporal(const void* prog, const void* tprog,
                               const void* node, const void* jls,
                               const void* alive, int cap, int n, int jcap,
                               void* work, void* zn, void* zp,
                               void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const size_t rows_smem = glance_rows_smem(jcap);
    const size_t jobs_smem = glance_jobs_smem<2, unsigned char>(n, cap);
    cudaError_t e = allow_smem((const void*)temporal_rows_kernel, rows_smem);
    if (e == cudaSuccess)
        e = allow_smem((const void*)temporal_jobs_kernel, jobs_smem);
    if (e != cudaSuccess) return (int)e;
    const TemporalRowsIn in = {(const double*)prog, (const double*)tprog,
                               (const int*)node, (const int*)jls,
                               (const int*)alive};
    temporal_rows_kernel<<<glance_tiles(cap), NTHREADS, rows_smem, s>>>(
        in, cap, n, jcap, work);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    double* tables = nullptr;
    if (!glance_table_in_smem<2, unsigned char>(n, cap))
        tables = (double*)((char*)work + glance_table_offset(
            glance_work_bytes<2>(cap, jcap, 1)));
    temporal_jobs_kernel<<<jcap, NTHREADS, jobs_smem, s>>>(
        cap, n, jcap, work, tables, (double*)zn, (double*)zp);
    return (int)cudaGetLastError();
}

extern "C" size_t assess_late_work_bytes(int cap, int nscen) {
    return late_work_bytes(cap, nscen);
}

// The wrappers' copies of these are checked when the library loads.
extern "C" int assess_glance_rows() { return GLANCE_ROWS; }
extern "C" int assess_glance_chunk() { return GLANCE_CHUNK; }
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
