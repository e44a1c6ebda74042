// Kernels 13a-13c: the MEM v1 machines, which serve MEMs on an index past
// the MEM v2 table's cap.
//
// 13a replaces movi_tpu/engine/fused_mem.py _pos2rba_device (the BWT row
// -> (run, all_p[run]) table), 13b _mem_scan (BML) and 13c _all_mem_scan
// (all-MEMs, with _extend_bidir), both with the resume loop of their
// engines (fused_mem.py _resume_compacted).
//
// 13a is bound by its bytes: it reads n_arr and all_p once and writes
// 8 B per BWT row.  One thread per run writes that run's rows: each input
// is read once, coalesced, and no row needs a search (one thread per row
// would search all_p for its run, ~log2(r) dependent loads a row).  A
// run far longer than its warp's others leaves that warp's other threads
// idle; the table is built once per index.
//
// 13b and 13c are bound by the latency of dependent loads: a lane's ticks
// form one chain (each tick's rows depend on the previous tick's
// intervals), and the one-step search records of a real index are far
// past the 50 MB L2.  One thread per read lane holds the machine (phase,
// two cursors and the two intervals: twelve registers) and loops until
// its lane is done; a done lane's tick changes nothing, so this equals the
// TPU's lockstep scan of 4W+64 tick quanta with lanes compacted between
// them, which exist for XLA's static shapes only.  Each tick is the JAX
// tick as straight-line code in the JAX order, and loads only the rows its
// phase uses: a backward step's two search records (search.cuh bs_step);
// on a successful bidirectional extension (BML's BACK, every all-MEMs
// step) the two skip rows, three all_p rows and the two repositions of
// the companion interval: one pos2rba row each where that table exists,
// else a branch-free binary search over all_p each (compact.cuh
// find_run2, the two interleaved); on an emission the two all_p rows of
// its count.  The char at a tick's position is an indexed load from the
// lane's int8 slots, and an emission a plain add into the lane's rows of
// ends and counts (the TPU's one-hot selects and emits are not needed).
// The tick budget and the state go in and out; a lane that comes in at
// phase ENTRY first gets its start state from its slots (BML: INIT or
// DONE by the read's length; all-MEMs: init_bidirectional at the first
// char, the JAX engine's jitted make_state).  Each lane reports the
// ticks it ran and the table bytes it loaded.  The read length counts
// every slot inside the read, '#' included (the JAX machines drop each
// '#', ROADMAP §3.9); an all-MEMs emission whose forward interval is the
// canonical empty one counts 0, as the oracle does (ROADMAP §3.10).

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

// (run, offset) of the absolute rows xs and xe (fused_mem.py _resolve_mi).
__device__ __forceinline__ void resolve2(const Mem1Tables& T, int xs, int xe,
                                         int find_loads, Interval& out,
                                         int& bytes) {
    if (T.pos2rba != nullptr) {
        const int2 a = T.pos2rba[clampi(xs, 0, T.n - 1)];
        const int2 b = T.pos2rba[clampi(xe, 0, T.n - 1)];
        out = Interval{a.x, xs - a.y, b.x, xe - b.y};
        bytes += 16;
    } else {
        int bs, be;
        movi::compact::find_run2(T.all_p, T.r, xs, xe, bs, be);
        out = Interval{bs, xs - __ldg(T.all_p + bs), be,
                       xe - __ldg(T.all_p + be)};
        bytes += 2 * 4 * find_loads;
    }
}

// One extend_bidirectional (fused_mem.py _extend_bidir) with a legal char
// a: backward-step s with a, and advance o past the rows of s whose
// complemented char precedes comp(a) (the skip rows at t = comp(a)).
// Returns whether the step found anything; only then are s and o updated.
__device__ __forceinline__ bool extend_bidir(const Mem1Tables& T, int a,
                                             int find_loads, Interval& s,
                                             Interval& o, int& bytes) {
    Interval nxt;
    const bool empty = movi::bs_step(T.rec_all, T.r, T.sigma, s, a, nxt);
    bytes += 32;
    if (empty) return false;
    const int64_t base = (int64_t)clampi(T.sigma - 1 - a, 0, T.sigma - 1) * T.r;
    const int2 ss = T.skip_rec[base + clampi(s.rs, 0, T.r - 1)];
    const int2 se = T.skip_rec[base + clampi(s.re, 0, T.r - 1)];
    // int32 arithmetic wrapping as in the JAX engine (no value here
    // reaches 2^31 on an index the wrapper takes)
    const uint32_t skip = (uint32_t)se.x + (uint32_t)se.y * (uint32_t)(s.oe + 1)
                          - (uint32_t)ss.x - (uint32_t)ss.y * (uint32_t)s.os;
    const uint32_t cnt = (uint32_t)movi::interval_count(T.all_p, T.r, nxt, 1);
    const uint32_t start =
        (uint32_t)__ldg(T.all_p + clampi(o.rs, 0, T.r)) + (uint32_t)o.os + skip;
    bytes += 16 + 12;
    resolve2(T, (int)start, (int)(start + cnt - 1u), find_loads, o, bytes);
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
    const int find_loads = movi::compact::find_run_loads(T.r);
    const int sigma = T.sigma;
    if (phase == ENTRY) {  // the window at 0, or done for a short read
        phase = m >= L ? INIT : DONE;
        pos = jc = end = 0;
        f = rc = Interval{0, 0, 0, 0};
    }

    long long t = 0;
    int bytes = 0;  // table bytes loaded
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
        if (phase == BACK) {
            // extend_left with seq[pos+L-2-jc]; a failure at jc
            // re-anchors at pos+L-1-jc
            const int a = row[clampi(pos + L - 2 - jc, 0, W - 1)];
            if (a >= 0 && extend_bidir(T, a, find_loads, f, rc, bytes)) {
                ++jc;
                if (jc >= L - 1) {  // the window matched: FWD from pos+L
                    phase = FWD;
                    jc = pos + L;
                }
            } else {
                pos = pos + L - 1 - jc;
                phase = INIT;
            }
        } else if (phase == FWD) {
            // a plain step of comp(seq[jc]) on rc; emit on failure
            const int a =
                jc < m ? comp_char(row[clampi(jc, 0, W - 1)], sigma) : -1;
            Interval nxt;
            bool empty = true;
            if (a >= 0) {
                empty = movi::bs_step(T.rec_all, T.r, sigma, rc, a, nxt);
                bytes += 32;
            }
            if (!empty) {
                rc = nxt;
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
            // backward-scan from the MEM end to the next candidate; the
            // scan is bounded by jc <= end - pos - 2
            const int a = jc <= end - pos - 2
                              ? row[clampi(end - 1 - jc, 0, W - 1)]
                              : -1;
            Interval nxt;
            bool empty = true;
            if (a >= 0) {
                empty = movi::bs_step(T.rec_all, T.r, sigma, f, a, nxt);
                bytes += 32;
            }
            if (!empty) {
                f = nxt;
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
    const int find_loads = movi::compact::find_run_loads(T.r);
    const int sigma = T.sigma;
    if (phase == ENTRY) {  // init_bidirectional at the first char, ml = 1
        phase = m > 0 ? AM_RIGHT : AM_DONE;
        s = e = 0;
        ml = 1;
        init_pair(init_s, sigma, row[0], f, rc);
    }

    long long t = 0;
    int bytes = 0;
    for (; t < ticks && phase != AM_DONE; ++t) {
        const bool right = phase == AM_RIGHT;
        // RIGHT: extend_right(seq[s+ml]) = extend_bidirectional on rc with
        // the complemented char; LEFT: extend_left(seq[e-ml]) on fw
        int a = -1;
        if (right) {
            if (s + ml < m) a = comp_char(row[clampi(s + ml, 0, W - 1)], sigma);
        } else if (e - ml >= 0) {
            a = row[clampi(e - ml, 0, W - 1)];
        }
        if (a >= 0 && (right ? extend_bidir(T, a, find_loads, rc, f, bytes)
                             : extend_bidir(T, a, find_loads, f, rc, bytes))) {
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
}

Mem1Tables tables(const void* rec_all, const void* all_p,
                  const void* skip_rec, const void* pos2rba, int r,
                  int sigma, int n) {
    return Mem1Tables{(const int4*)rec_all, (const int*)all_p,
                      (const int2*)skip_rec, (const int2*)pos2rba, r, sigma,
                      n};
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

// Kernel 13b.  rec_all int32 [2*sigma*r, 4], init_rec int32 [sigma+1, 4],
// all_p int32 [r+1], skip_rec int32 [sigma*r, 2], pos2rba int32 [n, 2] or
// NULL (the binary search); alphas int8 [lanes, W] read-order slots;
// st_in/st_out int32 [12, lanes] (a lane at phase ENTRY -1 starts from
// its slots); ends and counts int32 [lanes, W], added to in place; work
// int32 [2, lanes] gets each lane's ticks and bytes.
extern "C" int movi_mem1_scan(const void* rec_all, const void* init_rec,
                              const void* all_p, const void* skip_rec,
                              const void* pos2rba, int r, int sigma, int n,
                              const void* alphas, int W, int lanes, int L,
                              long long ticks, const void* st_in,
                              void* st_out, void* ends, void* counts,
                              void* work, void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        mem1_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                      (cudaStream_t)stream>>>(
            tables(rec_all, all_p, skip_rec, pos2rba, r, sigma, n),
            (const int4*)init_rec, (const int8_t*)alphas, W, lanes, L, ticks,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work);
    }
    return (int)cudaGetLastError();
}

// Kernel 13c.  The tables and buffers of kernel 13b.
extern "C" int movi_all_mem1_scan(const void* rec_all, const void* init_rec,
                                  const void* all_p, const void* skip_rec,
                                  const void* pos2rba, int r, int sigma,
                                  int n, const void* alphas, int W,
                                  int lanes, long long ticks,
                                  const void* st_in, void* st_out,
                                  void* ends, void* counts, void* work,
                                  void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        all_mem1_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                          (cudaStream_t)stream>>>(
            tables(rec_all, all_p, skip_rec, pos2rba, r, sigma, n),
            (const int4*)init_rec, (const int8_t*)alphas, W, lanes, ticks,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work);
    }
    return (int)cudaGetLastError();
}
