// Kernels 13a-13d: the MEM v1 machines, which serve MEMs on an index past
// the MEM v2 table's cap.
//
// 13a replaces movi_tpu/engine/fused_mem.py _pos2rba_device (the BWT row
// -> (run, all_p[run]) table), 13b _mem_scan (BML) and 13c _all_mem_scan
// (all-MEMs, with _extend_bidir), both with the resume loop of their
// engines (fused_mem.py _resume_compacted).  13d builds the row -> run
// directory that takes the place of _resolve's searchsorted where the
// index has no pos2rba (past POS2RUN_MAX_N rows, so on every index the v1
// machines serve past 2^28 positions).
//
// 13a and 13d are bound by their bytes: 13a reads n_arr and all_p once and
// writes 8 B per BWT row, 13d reads all_p once and writes 4 B per bucket.
// One thread per run writes the rows (13a) or the buckets (13d) whose
// first row falls in its run: each input is read once, coalesced, and no
// row needs a search.  A run far longer than its warp's others leaves
// that warp's other threads idle; each table is built once per index.
//
// 13b and 13c are bound by the dependent round trips of a tick: a lane's
// ticks form one chain (each tick's rows depend on the previous tick's
// intervals), the one-step search records and skip rows of a real index
// are far past the 50 MB L2, and a batch of long reads is a few warps with
// no other work to hide their latency.  One thread per read lane holds the
// machine (phase, two cursors and the two intervals: twelve registers) and
// loops until its lane is done; a done lane's tick changes nothing, so
// this equals the TPU's lockstep scan of 4W+64 tick quanta with lanes
// compacted between them, which exist for XLA's static shapes only.  Each
// tick follows the JAX tick's order and loads only the rows its phase
// uses.  A successful bidirectional extension (BML's BACK, every
// all-MEMs step) is four round trips plus the bucket's extra halvings:
//   1. the backward step's two search records (search.cuh bs_step), the
//      two skip rows and all_p[o.rs]; the last three depend only on the
//      old intervals, so they issue with the records, before the step is
//      known to be non-empty (a failed step still changes nothing);
//   2. the two all_p rows of the new interval's count;
//   3. the companion interval's two repositions: one pos2rba row each
//      where that table exists, else the directory pair of each row's
//      bucket (compact.cuh find_run_dir2, the two interleaved);
//   4. all_p[dir[k]] with the first halving of the bucket's span, then
//      one round trip per further halving (most buckets hold one or two
//      run starts).
// The directory takes the place of a search of all of all_p (23
// dependent halvings a reposition at r = 5 M), and the skip rows ride
// with the records instead of costing a round trip of their own.  Each
// tick has one step site: 13c picks the interval, companion and char by
// phase (RIGHT: rc, f, comp(seq[s+ml]); LEFT: f, rc, seq[e-ml]) and 13b
// those of BACK, FWD or NEXT, so lanes of a warp in different phases
// share one chain of loads instead of running each phase's chain in
// turn; only BACK goes on past the step.  On an
// emission the two all_p rows of its count.  The char at a tick's
// position is an indexed load from the lane's int8 slots, and an emission
// a plain add into the lane's rows of ends and counts (the TPU's one-hot
// selects and emits are not needed).  The tick budget and the state go in
// and out; a lane that comes in at phase ENTRY first gets its start state
// from its slots (BML: INIT or DONE by the read's length; all-MEMs:
// init_bidirectional at the first char, the JAX engine's jitted
// make_state).  Each lane reports the ticks it ran, the table bytes its
// ticks need (the 20 B of skip rows and all_p[o.rs] that a failed step
// loads early are not counted) and its successful bidirectional
// extensions.  The read length
// counts every slot inside the read, '#' included (the JAX machines drop
// each '#', ROADMAP §3.9); an all-MEMs emission whose forward interval is
// the canonical empty one counts 0, as the oracle does (ROADMAP §3.10).

#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"
#include "search.cuh"

namespace {

using movi::clampi;
using movi::Interval;

constexpr int INIT = 0, BACK = 1, FWD = 2, NEXT = 3, DONE = 4;
constexpr int AM_RIGHT = 0, AM_LEFT = 1, AM_DONE = 2;
constexpr int ENTRY = -1;  // the start state is still to be built
constexpr int NREG = 12;

struct Mem1Tables {
    const int4* __restrict__ rec_all;   // search records [2*sigma*r]
    const int* __restrict__ all_p;      // [r+1]
    const int2* __restrict__ skip_rec;  // (P, U) [sigma*r]
    const int2* __restrict__ pos2rba;   // (run, all_p[run]) [n], or null
    movi::compact::RunDir dir;          // used where pos2rba is null
    int r, sigma, n;
};

__global__ void pos2rba_kernel(const int* __restrict__ n_arr,
                               const int* __restrict__ all_p, int r, int n,
                               int2* __restrict__ out) {
    const int run = blockIdx.x * blockDim.x + threadIdx.x;
    if (run >= r) return;
    const int start = all_p[run];
    const int stop = min(start + n_arr[run], n);
    const int2 v = make_int2(run, start);
    for (int row = max(start, 0); row < stop; ++row) out[row] = v;
}

// The first bucket whose first row k << b is at or past row x >= 0.
__device__ __forceinline__ int first_bucket_at(int x, int b) {
    return x > 0 ? ((x - 1) >> b) + 1 : 0;
}

// dir[k] = the run holding row k << b, for the buckets whose first row
// falls in this thread's run; the last run also writes dir[K] = r.
__global__ void run_dir_kernel(const int* __restrict__ all_p, int r, int K,
                               int b, int* __restrict__ dir) {
    const int run = blockIdx.x * blockDim.x + threadIdx.x;
    if (run >= r) return;
    const int k0 = first_bucket_at(all_p[run], b);
    const int k1 = min(first_bucket_at(all_p[run + 1], b), K);
    for (int k = k0; k < k1; ++k) dir[k] = run;
    if (run == r - 1) dir[K] = r;
}

__device__ __forceinline__ void load_init(const int4* __restrict__ g,
                                          int4* s, int sigma) {
    for (int i = threadIdx.x; i < sigma + 1; i += blockDim.x) s[i] = g[i];
    __syncthreads();
}

// m: the lane's positions inside its read (slot != -2).
__device__ __forceinline__ int read_len(const int8_t* row, int W) {
    int m = 0;
    for (int j = 0; j < W; ++j) m += row[j] != -2 ? 1 : 0;
    return m;
}

// The search char of extend_right for a read char: its complement; an
// unknown char other than '#' (-1) complements to 'A', '#' (-3) to none.
__device__ __forceinline__ int comp_char(int c, int sigma) {
    return c >= 0 ? sigma - 1 - c : (c == -1 ? 0 : -1);
}

// (run, offset) of the absolute rows xs and xe (fused_mem.py _resolve_mi):
// one pos2rba row each, else the directory search.
__device__ __forceinline__ void resolve2(const Mem1Tables& T, int xs, int xe,
                                         Interval& out, int& bytes) {
    if (T.pos2rba != nullptr) {
        const int2 a = T.pos2rba[clampi(xs, 0, T.n - 1)];
        const int2 b = T.pos2rba[clampi(xe, 0, T.n - 1)];
        out = Interval{a.x, xs - a.y, b.x, xe - b.y};
        bytes += 16;
    } else {
        int bs, ps, be, pe, h = 0;
        movi::compact::find_run_dir2(T.all_p, T.dir, xs, xe, bs, ps, be, pe,
                                     h);
        out = Interval{bs, xs - ps, be, xe - pe};
        // each row: its directory pair, all_p[dir[k]] and its halvings
        bytes += 2 * (8 + 4) + 4 * h;
    }
}

// One backward step of s with a legal char a (search.cuh bs_step) and,
// with bidir, the rest of extend_bidirectional (fused_mem.py
// _extend_bidir): advance o past the rows of s whose complemented char
// precedes comp(a) (the skip rows at t = comp(a)).  The skip rows and
// all_p[o.rs] are loaded with the step's records.  Returns whether the
// step found anything; only then are s (and, with bidir, o) updated.
__device__ __forceinline__ bool step(const Mem1Tables& T, int a, bool bidir,
                                     Interval& s, Interval& o, int& bytes,
                                     int& ext) {
    int2 ss = make_int2(0, 0), se = make_int2(0, 0);
    int o_start = 0;
    if (bidir) {
        const int64_t base =
            (int64_t)clampi(T.sigma - 1 - a, 0, T.sigma - 1) * T.r;
        ss = T.skip_rec[base + clampi(s.rs, 0, T.r - 1)];
        se = T.skip_rec[base + clampi(s.re, 0, T.r - 1)];
        o_start = __ldg(T.all_p + clampi(o.rs, 0, T.r));
    }
    Interval nxt;
    const bool empty = movi::bs_step(T.rec_all, T.r, T.sigma, s, a, nxt);
    bytes += 32;
    if (empty) return false;
    if (bidir) {
        // int32 arithmetic wrapping as in the JAX engine (no value here
        // reaches 2^31 on an index the wrapper takes)
        const uint32_t skip =
            (uint32_t)se.x + (uint32_t)se.y * (uint32_t)(s.oe + 1)
            - (uint32_t)ss.x - (uint32_t)ss.y * (uint32_t)s.os;
        const uint32_t cnt =
            (uint32_t)movi::interval_count(T.all_p, T.r, nxt, 1);
        const uint32_t start = (uint32_t)o_start + (uint32_t)o.os + skip;
        // the skip rows and all_p[o.rs] (loaded early, needed only here)
        // and the count's two all_p rows
        bytes += 16 + 4 + 8;
        resolve2(T, (int)start, (int)(start + cnt - 1u), o, bytes);
        ++ext;
    }
    s = nxt;
    return true;
}

__global__ void mem1_kernel(Mem1Tables T, const int4* __restrict__ init_g,
                            const int8_t* __restrict__ alphas, int W,
                            int lanes, int L, long long ticks,
                            const int* __restrict__ st_in,
                            int* __restrict__ st_out, int* __restrict__ ends,
                            int* __restrict__ counts, int* __restrict__ work) {
    extern __shared__ int4 init_s[];  // sigma + 1 rows
    load_init(init_g, init_s, T.sigma);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    int phase = reg[0], pos = reg[1], jc = reg[2], end = reg[3];
    Interval f{reg[4], reg[5], reg[6], reg[7]};
    Interval rc{reg[8], reg[9], reg[10], reg[11]};
    const int8_t* row = alphas + (int64_t)lane * W;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int sigma = T.sigma;
    if (phase == ENTRY) {  // the window at 0, or done for a short read
        phase = m >= L ? INIT : DONE;
        pos = jc = end = 0;
        f = rc = Interval{0, 0, 0, 0};
    }

    long long t = 0;
    int bytes = 0, ext = 0;  // table bytes needed, bidirectional extensions
    for (; t < ticks && phase != DONE; ++t) {
        // ---- INIT: anchor the window, init bidirectional; an anchored
        // lane steps in the same tick (falls into BACK)
        if (phase == INIT) {
            if (pos + L > m) {
                phase = DONE;
            } else {
                const int c0 = row[clampi(pos + L - 1, 0, W - 1)];
                if (c0 >= 0) {
                    f = movi::init_interval(init_s, c0);
                    rc = movi::init_interval(init_s, sigma - 1 - c0);
                    jc = 0;
                    phase = BACK;
                } else {
                    // an illegal window-end char: re-anchor past it
                    pos = pos + L - 1;
                }
            }
        }
        // ---- the tick's one step: BACK extend_left with seq[pos+L-2-jc]
        // (fw steps, rc repositioned), FWD a plain step of comp(seq[jc])
        // on rc, NEXT a plain step of seq[end-1-jc] on fw (the scan is
        // bounded by jc <= end - pos - 2)
        const bool back = phase == BACK, fwd = phase == FWD;
        int a = -1;
        if (back) {
            a = row[clampi(pos + L - 2 - jc, 0, W - 1)];
        } else if (fwd) {
            if (jc < m) a = comp_char(row[clampi(jc, 0, W - 1)], sigma);
        } else if (phase == NEXT && jc <= end - pos - 2) {
            a = row[clampi(end - 1 - jc, 0, W - 1)];
        }
        Interval s = fwd ? rc : f, o = rc;
        const bool ok = a >= 0 && step(T, a, back, s, o, bytes, ext);
        if (back) {
            // a failure at jc re-anchors at pos+L-1-jc
            if (ok) {
                f = s;
                rc = o;
                ++jc;
                if (jc >= L - 1) {  // the window matched: FWD from pos+L
                    phase = FWD;
                    jc = pos + L;
                }
            } else {
                pos = pos + L - 1 - jc;
                phase = INIT;
            }
        } else if (fwd) {
            // emit on failure
            if (ok) {
                rc = s;
                ++jc;
            } else {
                const int at = clampi(pos, 0, W - 1);
                erow[at] += jc;
                crow[at] += movi::interval_count(T.all_p, T.r, rc, 1);
                bytes += 8;
                end = jc;
                if (jc >= m) {
                    phase = DONE;
                } else {
                    // NEXT: fw = init(seq[end]), jc = 0; an illegal char
                    // there re-anchors at end
                    const int c_end = row[clampi(end, 0, W - 1)];
                    f = movi::init_interval(init_s, c_end);
                    jc = 0;
                    if (c_end < 0) {
                        pos = end;
                        phase = INIT;
                    } else {
                        phase = NEXT;
                    }
                }
            }
        } else if (phase == NEXT) {
            // backward-scan from the MEM end to the next candidate
            if (ok) {
                f = s;
                ++jc;
            } else {
                pos = end - jc;
                phase = INIT;
            }
        }
    }
    const int fin[NREG] = {phase, pos, jc, end, f.rs, f.os, f.re, f.oe,
                           rc.rs, rc.os, rc.re, rc.oe};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = bytes;
    work[2 * lanes + lane] = ext;
}

// init_bidirectional at c: fw from c (the canonical empty interval (1, 0,
// 0, 0) when illegal), rc from its complement.
__device__ __forceinline__ void init_pair(const int4* init_s, int sigma,
                                          int c, Interval& fw, Interval& rc) {
    const Interval empty{1, 0, 0, 0};
    fw = c >= 0 ? movi::init_interval(init_s, c) : empty;
    const int cr = comp_char(c, sigma);
    rc = cr >= 0 ? movi::init_interval(init_s, cr) : empty;
}

__global__ void all_mem1_kernel(Mem1Tables T, const int4* __restrict__ init_g,
                                const int8_t* __restrict__ alphas, int W,
                                int lanes, long long ticks,
                                const int* __restrict__ st_in,
                                int* __restrict__ st_out,
                                int* __restrict__ ends,
                                int* __restrict__ counts,
                                int* __restrict__ work) {
    extern __shared__ int4 init_s[];
    load_init(init_g, init_s, T.sigma);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    int phase = reg[0], s = reg[1], ml = reg[2], e = reg[3];
    Interval f{reg[4], reg[5], reg[6], reg[7]};
    Interval rc{reg[8], reg[9], reg[10], reg[11]};
    const int8_t* row = alphas + (int64_t)lane * W;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int sigma = T.sigma;
    if (phase == ENTRY) {  // init_bidirectional at the first char, ml = 1
        phase = m > 0 ? AM_RIGHT : AM_DONE;
        s = e = 0;
        ml = 1;
        init_pair(init_s, sigma, row[0], f, rc);
    }

    long long t = 0;
    int bytes = 0, ext = 0;
    for (; t < ticks && phase != AM_DONE; ++t) {
        const bool right = phase == AM_RIGHT;
        // the tick's one extension: RIGHT extend_right(seq[s+ml]) =
        // extend_bidirectional on rc with the complemented char, f
        // repositioned; LEFT extend_left(seq[e-ml]) on fw, rc repositioned
        int a = -1;
        if (right) {
            if (s + ml < m) a = comp_char(row[clampi(s + ml, 0, W - 1)], sigma);
        } else if (e - ml >= 0) {
            a = row[clampi(e - ml, 0, W - 1)];
        }
        Interval x = right ? rc : f, y = right ? f : rc;
        if (a >= 0 && step(T, a, true, x, y, bytes, ext)) {
            rc = right ? x : y;
            f = right ? y : x;
            ++ml;
        } else if (right) {
            // emit (s, s+ml, count(fw)) at s, then re-anchor at e = s+ml
            // and left-extend (or stop at the read's end)
            const int cnt = movi::interval_count(T.all_p, T.r, f, 1);
            bytes += 8;
            const int at = clampi(s, 0, W - 1);
            erow[at] += s + ml;
            crow[at] += cnt > 0 ? cnt : 0;
            e = s + ml;
            if (e >= m) {
                phase = AM_DONE;
            } else {
                init_pair(init_s, sigma, row[clampi(e, 0, W - 1)], f, rc);
                ml = 1;
                phase = AM_LEFT;
            }
        } else {
            // LEFT termination: the next MEM starts at e - ml + 1
            s = e - ml + 1;
            phase = AM_RIGHT;
        }
    }
    const int fin[NREG] = {phase, s, ml, e, f.rs, f.os, f.re, f.oe,
                           rc.rs, rc.os, rc.re, rc.oe};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = bytes;
    work[2 * lanes + lane] = ext;
}

Mem1Tables tables(const void* rec_all, const void* all_p,
                  const void* skip_rec, const void* pos2rba,
                  const void* run_dir, int dir_shift, int r, int sigma,
                  int n) {
    const int K = ((n - 1) >> dir_shift) + 1;
    return Mem1Tables{(const int4*)rec_all, (const int*)all_p,
                      (const int2*)skip_rec, (const int2*)pos2rba,
                      movi::compact::RunDir{(const int*)run_dir, K,
                                            dir_shift},
                      r, sigma, n};
}

}  // namespace

// Kernel 13a.  n_arr int32 [r], all_p int32 [r+1]; out int32 [n, 2].
extern "C" int movi_pos2rba_build(const void* n_arr, const void* all_p,
                                  int r, int n, void* out, void* stream) {
    const int block = 256;
    const int grid = (r + block - 1) / block;
    if (grid > 0) {
        pos2rba_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int*)n_arr, (const int*)all_p, r, n, (int2*)out);
    }
    return (int)cudaGetLastError();
}

// Kernel 13d.  all_p int32 [r+1] (all_p[r] = n); out int32 [K+1] with K =
// ((n-1) >> b) + 1.
extern "C" int movi_run_dir_build(const void* all_p, int r, int K, int b,
                                  void* out, void* stream) {
    const int block = 256;
    const int grid = (r + block - 1) / block;
    if (grid > 0) {
        run_dir_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int*)all_p, r, K, b, (int*)out);
    }
    return (int)cudaGetLastError();
}

// Kernel 13b.  rec_all int32 [2*sigma*r, 4], init_rec int32 [sigma+1, 4],
// all_p int32 [r+1], skip_rec int32 [sigma*r, 2], pos2rba int32 [n, 2] or
// NULL, run_dir int32 [K+1] with K = ((n-1) >> dir_shift) + 1 (read where
// pos2rba is NULL); alphas int8 [lanes, W] read-order slots; st_in/st_out
// int32 [12, lanes] (a lane at phase ENTRY -1 starts from its slots); ends
// and counts int32 [lanes, W], added to in place; work int32 [3, lanes]
// gets each lane's ticks, bytes and bidirectional extensions.
extern "C" int movi_mem1_scan(const void* rec_all, const void* init_rec,
                              const void* all_p, const void* skip_rec,
                              const void* pos2rba, const void* run_dir,
                              int dir_shift, int r, int sigma, int n,
                              const void* alphas, int W, int lanes, int L,
                              long long ticks, const void* st_in,
                              void* st_out, void* ends, void* counts,
                              void* work, void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        mem1_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                      (cudaStream_t)stream>>>(
            tables(rec_all, all_p, skip_rec, pos2rba, run_dir, dir_shift, r,
                   sigma, n),
            (const int4*)init_rec, (const int8_t*)alphas, W, lanes, L, ticks,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work);
    }
    return (int)cudaGetLastError();
}

// Kernel 13c.  The tables and buffers of kernel 13b.
extern "C" int movi_all_mem1_scan(const void* rec_all, const void* init_rec,
                                  const void* all_p, const void* skip_rec,
                                  const void* pos2rba, const void* run_dir,
                                  int dir_shift, int r, int sigma, int n,
                                  const void* alphas, int W, int lanes,
                                  long long ticks, const void* st_in,
                                  void* st_out, void* ends, void* counts,
                                  void* work, void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        all_mem1_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                          (cudaStream_t)stream>>>(
            tables(rec_all, all_p, skip_rec, pos2rba, run_dir, dir_shift, r,
                   sigma, n),
            (const int4*)init_rec, (const int8_t*)alphas, W, lanes, ticks,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work);
    }
    return (int)cudaGetLastError();
}
