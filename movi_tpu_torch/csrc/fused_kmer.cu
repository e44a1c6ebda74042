// Kernels 9a, 9b and 10a: k-mer membership, exact k-mer counts on the
// one-step search records, and the membership machine's batch prep.
//
// 9a replaces movi_tpu/engine/fused_kmer.py _kmer_scan (with the resume
// loop of FusedKmerEngine, fused_mem.py _resume_compacted); 9b replaces
// _kmer_count_scan; 10a replaces movi_tpu/engine/fused_mem2.py _prep_alc.
//
// Bound on this card: the latency of the dependent record loads.  A
// membership lane's ticks form one chain (each tick's rows depend on the
// previous tick's interval and cursor), and a count lane's k-1 steps
// another; the one-step search table of a real index (640 MB at five
// million runs, plus 16 MB of ftab rows at fk = 10) is past the 50 MB L2.
// Design:
//  - 9a: one thread per read lane holds the whole tick machine (phase,
//    pos, cur, pc, pok, pinit and the interval) in registers and loops
//    until its lane is done.  A done lane's tick changes nothing, so this
//    equals the TPU's lockstep scan of 2W+64-tick quanta with lanes
//    compacted between them, which exist only for XLA's static shapes.  A
//    tick uses either a step's two rows (bs_step's addressing) or one
//    ftab anchor row at 2*sigma*r + code, or nothing (anchor decisions,
//    probe restarts); the char and fk-mer code at the tick's position are
//    indexed loads from the lane's row and the emission an add into the
//    lane's output row (the TPU's one-hot selects and emits are not
//    needed).  The loop is software-pipelined over ticks, so that a tick
//    waits on nothing but its own rows: every position the next tick can
//    read follows from the registers, the char and code, and one bit (did
//    the step or ftab row come back empty).  While the rows are in
//    flight, the tick computes the next registers for both outcomes and
//    loads both chars and codes; when the rows arrive, the bit picks the
//    outcome, and the next tick is planned from the char and code in
//    registers and issues its rows (a step's, or its ftab row) before
//    anything else.  The emission is a reduction (atomicAdd into the
//    lane's own row) that no load waits on.  The tick budget and the
//    state go in and out, so a run split in two equals one pass; each
//    lane reports the ticks it ran, the rows it loaded and the ticks that
//    loaded a step's rows.
//  - 9b: one thread per k-mer reads its k chars from the read-order int8
//    slots by (lane, start) (an int32 [k, nk] window matrix would be 13x
//    the bytes at k = 31), inits
//    from the last char and takes up to k-1 steps, stopping at the
//    first empty one (its result is fixed then).  Its bound is the rate
//    of random row gathers from a table past the L2, so a step loads one
//    row where one is enough (count_step): once the interval lies in one
//    run (rs == re), which most deep steps do, the up row is the down row
//    or changes no answer.
//  - 10a: one thread per (lane, position) widens the slot and, with fk,
//    writes the fk-mer code ending there (-1 where a char is illegal or
//    p < fk-1): elementwise, bound by its bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "search.cuh"

namespace {

using movi::Interval;

constexpr int ANCHOR = 0, EXTEND = 1, DONE = 2, PROBE = 3;
constexpr int NREG = 10;  // phase pos cur pc pok pinit rs os re oe

// A membership lane's registers apart from its interval.
struct KRegs {
    int phase, pos, cur, pc, pok, pinit;
};

// The position a tick reads its char (and fk-mer code) at: the anchor at
// pos, a probe init at pc, a probe step at pc-1, a stretch step at cur-1.
__device__ __forceinline__ int kmer_pos(const KRegs& q, int W) {
    const bool pi = q.phase == PROBE && q.pinit == 1;
    return movi::clampi(
        q.phase == ANCHOR ? q.pos
                          : (q.phase == PROBE ? (pi ? q.pc : q.pc - 1)
                                              : q.cur - 1),
        0, W - 1);
}

// What a tick decides before its rows arrive, from its registers, its char
// and its fk-mer code (-1 without ftab rows): the anchor decisions, and
// which rows it reads.
struct KPlan {
    KRegs q;      // after the anchor decisions (pos1, cur1, pc1, ...)
    int c, code;
    int a_gate;   // the step's char, or -1: no step rows
    int64_t down, up;  // the step char's row bases
    bool ftl;     // reads the ftab row of code
    bool init;    // the interval becomes init(c): a plain anchor/probe init
    bool anchored, pi, extending, probing, can_step, can_pstep;
};

__device__ __forceinline__ KPlan kmer_plan(const KRegs& q, int c, int code,
                                           int k, int step, int r,
                                           int sigma) {
    KPlan P;
    P.c = c;
    P.code = code;
    const bool in_anchor = q.phase == ANCHOR;
    P.extending = q.phase == EXTEND;
    P.probing = q.phase == PROBE;
    P.pi = P.probing && q.pinit == 1;
    // anchoring lanes: decide, or start a probe
    const int pos1 = (in_anchor && c < 0) ? q.pos - 1 : q.pos;
    const bool legal = in_anchor && c >= 0 && pos1 >= k - 1;
    const bool eligible =
        step >= 1 && legal && pos1 >= k - 1 + step && q.pok == 0;
    P.anchored = legal && !eligible;
    P.q.pos = pos1;
    P.q.pc = eligible ? pos1 - step : q.pc;
    P.q.pinit = eligible ? 1 : q.pinit;
    int phase1 = eligible ? PROBE : (P.anchored ? EXTEND : q.phase);
    if (phase1 == ANCHOR && pos1 < k - 1) phase1 = DONE;
    P.q.phase = phase1;
    P.q.pok = P.anchored ? 0 : q.pok;
    P.q.cur = P.anchored ? pos1 : q.cur;
    // the tick's rows: a step's two, one ftab anchor row, or none
    P.can_step = P.extending && P.q.cur > 0;
    P.can_pstep = P.probing && !P.pi && P.q.pc > 0;
    P.a_gate = (P.can_step || P.can_pstep) ? c : -1;
    const int64_t a_s = P.a_gate > 0 ? P.a_gate : 0;
    P.down = a_s * r;
    P.up = (sigma + a_s) * r;
    const bool code_ok = code >= 0;
    P.ftl = (P.anchored || P.pi) && code_ok;
    P.init = (P.anchored || (P.pi && c >= 0)) && !code_ok;
    return P;
}

// The rest of the tick, given the one bit its rows decide: e is the ftab
// row's emptiness on an ftab tick, the step's on a step tick, and true on
// a tick without rows.  Returns the next registers; a stretch's emission
// (at, val) has val > 0.
__device__ __forceinline__ KRegs kmer_finish(const KPlan& P, bool e, int k,
                                             int step, int fk, int W,
                                             int& at, int& val) {
    KRegs n = P.q;
    // an ftab hit jumps the cursor; a miss advances the anchor
    const bool hit = P.ftl && !e, miss = P.ftl && e;
    if (P.anchored && hit) n.cur = P.q.pos - fk + 1;
    if (P.anchored && miss) {
        n.pos -= 1;
        n.phase = n.pos >= k - 1 ? ANCHOR : DONE;
    }
    if (P.pi && hit) n.pc -= fk - 1;
    if (P.pi && (hit || P.init)) n.pinit = 0;
    const bool pi_fail = (P.pi && P.c < 0) || (P.pi && miss);
    // commit the step
    const bool step_ok = P.can_step && !e;
    const bool pstep_ok = P.can_pstep && !e;
    if (step_ok) n.cur -= 1;
    if (pstep_ok) n.pc -= 1;
    // probe termination (the look-ahead's backward search loop)
    const int plen = (n.pos - step) - n.pc;
    const bool probe_end =
        (P.probing && !P.pi &&
         (!P.can_pstep || e || (pstep_ok && plen > k - step))) ||
        pi_fail;
    const bool passed = n.pos - n.pc >= k - 1;
    if (probe_end && passed) n.pok = 1;
    if (probe_end) {
        if (!passed) n.pos -= step + 1;
        n.phase = (!passed && n.pos < k - 1) ? DONE : ANCHOR;
    }
    // a stretch ends at a failed step or at position 0
    at = 0;
    val = 0;
    if (P.extending && !step_ok) {
        const int matched = n.pos - n.cur;
        const bool emit = matched >= k - 1;
        if (emit) {
            at = movi::clampi(n.cur, 0, W - 1);
            val = matched - k + 2;
        }
        // the new anchor: cur + k - 2 after a success, pos - 1 else
        n.pos = emit ? n.cur + k - 2 : n.pos - 1;
        n.phase = n.pos >= k - 1 ? ANCHOR : DONE;
    }
    return n;
}

__device__ __forceinline__ bool ftab_empty(int4 f) {
    return !(f.x < f.z || (f.x == f.z && f.y <= f.w));
}

__global__ void kmer_member_kernel(
    const int4* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ alc, int W, int alc_w, int lanes, int r,
    int sigma, int fk, int k, long long ticks, int use_ftab,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ out, int* __restrict__ work) {
    extern __shared__ int4 init_rec[];  // sigma + 1 rows
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    KRegs q{reg[0], reg[1], reg[2], reg[3], reg[4], reg[5]};
    Interval iv{reg[6], reg[7], reg[8], reg[9]};
    const int* row = alc + (int64_t)lane * alc_w;
    const int* codes = row + W;
    int* orow = out + (int64_t)lane * W;
    const int step = k / 3;
    const int4* ftab = rec_all + 2 * (int64_t)sigma * r;
    // 0 (the wrapper takes ticks >= 0), but not to the compiler: a row's
    // word no decode reads is and-ed with it and kept, so that its
    // register stays live until the row lands (an instruction that
    // reused it would wait on the whole in-flight load)
    const int keep = (int)(ticks >> 63);

    // The first tick's char, code and rows; from then on each tick loads
    // the next tick's chars and codes while its own rows are in flight,
    // and issues the next tick's rows as soon as they are addressed.
    int p = kmer_pos(q, W);
    KPlan P = kmer_plan(q, row[p], use_ftab ? codes[p] : -1, k, step, r,
                        sigma);
    const int4 zero{0, 0, 0, 0};
    int4 frow = P.ftl ? ftab[P.code] : zero;
    movi::StepRows sr{zero, zero};
    if (P.a_gate >= 0) sr = movi::step_rows(rec_all, P.down, P.up, r, iv);

    long long t = 0;
    int rows = 0;   // 16 B record rows loaded
    int steps = 0;  // ticks that loaded a step's rows
    while (t < ticks && q.phase != DONE) {
        // 1. while this tick's rows are in flight: the next registers for
        //    both outcomes, and their chars and codes
        int at0, val0, at1, val1;
        const KRegs q0 = kmer_finish(P, false, k, step, fk, W, at0, val0);
        const KRegs q1 = kmer_finish(P, true, k, step, fk, W, at1, val1);
        const int p0 = kmer_pos(q0, W), p1 = kmer_pos(q1, W);
        const int c0 = row[p0], c1 = row[p1];
        const int code0 = use_ftab ? codes[p0] : -1;
        const int code1 = use_ftab ? codes[p1] : -1;
        const Interval ini = movi::init_interval(init_rec, P.c);

        // 2. the rows' one bit picks the outcome
        Interval nxt{0, 0, 0, 0};
        bool e = true;
        if (P.ftl) {
            e = ftab_empty(frow);
            rows += 1;
        } else if (P.a_gate >= 0) {
            e = movi::step_decode(sr, r, iv, P.a_gate, nxt);
            rows += 2;
            steps += 1 + (sr.rd.w & keep);
        }
        if (P.ftl && !e) {
            iv = movi::interval_of(frow);
        } else if (P.init) {
            iv = ini;
        } else if ((P.can_step || P.can_pstep) && !e) {
            iv = nxt;
        }
        q = e ? q1 : q0;
        ++t;

        // 3. the next tick's plan from its char and code, already in
        //    registers, and its rows: the chain's only loads that wait on
        //    this tick's rows
        P = kmer_plan(q, e ? c1 : c0, e ? code1 : code0, k, step, r, sigma);
        if (P.a_gate >= 0) {
            sr = movi::step_rows(rec_all, P.down, P.up, r, iv);
        } else if (P.ftl) {
            frow = ftab[P.code];
        }
        // the emission adds into the lane's own row: a reduction that no
        // load waits on
        const int val = e ? val1 : val0;
        if (val > 0) atomicAdd(orow + (e ? at1 : at0), val);
    }
    const int fin[NREG] = {q.phase, q.pos, q.cur, q.pc, q.pok, q.pinit,
                           iv.rs, iv.os, iv.re, iv.oe};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
    work[2 * lanes + lane] = steps;
}

// A step of kernel 9b.  A record is a function of its destination run
// only, and the next-run tables are inclusive, so where rs == re the up
// row of (a, re) is the down row of (a, rs) when run rs holds a, and when
// it does not, rd.x > re makes the step empty whatever the up row holds.
// There the down row alone is loaded and step_decode reads both ends
// (emptiness and the os1/oe1 rules) from it; elsewhere both rows are
// issued together, as bs_rows does.  The up load is predicated, not
// branched around, so a warp issues both kinds of lanes' rows at once.
__device__ __forceinline__ bool count_step(const int4* __restrict__ rec_all,
                                           int r, int sigma,
                                           const Interval& cur, int a,
                                           Interval& nxt) {
    const int64_t a_s = a > 0 ? a : 0;
    const bool one = cur.rs == cur.re;
    const int4 rd = rec_all[a_s * r + movi::clampi(cur.rs, 0, r - 1)];
    int4 ru = make_int4(0, 0, 0, 0);
    if (!one) {
        ru = rec_all[(sigma + a_s) * r + movi::clampi(cur.re, 0, r - 1)];
    }
    return movi::step_decode(movi::StepRows{rd, one ? rd : ru}, r, cur, a,
                             nxt);
}

__global__ void kmer_count_kernel(
    const int4* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ all_p, const int8_t* __restrict__ slots, int W,
    const int* __restrict__ lane_of, const int* __restrict__ start_of,
    int nk, int r, int sigma, int k, uint8_t* __restrict__ found_out,
    int* __restrict__ cnt_out) {
    extern __shared__ int4 init_rec[];  // sigma + 1 rows
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nk) return;
    const int8_t* w = slots + (int64_t)lane_of[i] * W + start_of[i];
    bool dead = false;
    for (int j = 0; j < k; ++j) dead |= w[j] < 0;
    Interval iv = movi::init_interval(init_rec, w[k - 1]);
    // extend with kmer[k-2] ... kmer[0]; a dead lane's result is fixed
    for (int j = k - 2; j >= 0 && !dead; --j) {
        Interval nxt;
        if (count_step(rec_all, r, sigma, iv, w[j], nxt)) {
            dead = true;
        } else {
            iv = nxt;
        }
    }
    found_out[i] = dead ? 0 : 1;
    cnt_out[i] = movi::interval_count(all_p, r, iv, dead ? 0 : 1);
}

__global__ void prep_alc_kernel(const int8_t* __restrict__ slots, int lanes,
                                int W, int fk, int* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)lanes * W) return;
    const int64_t lane = i / W;
    const int p = (int)(i - lane * W);
    const int8_t* row = slots + lane * W;
    int* orow = out + lane * (fk ? 2 * (int64_t)W : W);
    orow[p] = row[p];
    if (fk) {
        int code = 0;
        bool ok = p >= fk - 1;
        for (int j = 0; j < fk; ++j) {
            const int q = p - (fk - 1 - j);
            const int a = q >= 0 ? row[q] : -1;
            code = code * 4 + (a > 0 ? a : 0);
            ok = ok && a >= 0;
        }
        orow[W + p] = ok ? code : -1;
    }
}

}  // namespace

// Kernel 9a.  alc is int32 [lanes, alc_w]: the read-order slots, followed
// with use_ftab by the fk-mer codes (alc_w = 2W).  st_in/st_out are int32
// [10, lanes]; out is int32 [lanes, W], added to in place; work int32
// [3, lanes] gets each lane's ticks, the record rows it used and its step
// ticks.
extern "C" int movi_kmer_member_scan(
    const void* rec_all, const void* init_rec, const void* alc, int W,
    int alc_w, int lanes, int r, int sigma, int fk, int k, long long ticks,
    int use_ftab, const void* st_in, void* st_out, void* out, void* work,
    void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        kmer_member_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                             (cudaStream_t)stream>>>(
            (const int4*)rec_all, (const int4*)init_rec, (const int*)alc, W,
            alc_w, lanes, r, sigma, fk, k, ticks, use_ftab,
            (const int*)st_in, (int*)st_out, (int*)out, (int*)work);
    }
    return (int)cudaGetLastError();
}

// Kernel 9b.  slots int8 [lanes, W]; the k-mer i starts at
// (lane_of[i], start_of[i]) with start_of[i] <= W - k.
extern "C" int movi_kmer_count_scan(const void* rec_all, const void* init_rec,
                                    const void* all_p, const void* slots,
                                    int W, const void* lane_of,
                                    const void* start_of, int nk, int r,
                                    int sigma, int k, void* found,
                                    void* cnt, void* stream) {
    const int block = 256;
    const int grid = (nk + block - 1) / block;
    if (grid > 0) {
        kmer_count_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                            (cudaStream_t)stream>>>(
            (const int4*)rec_all, (const int4*)init_rec, (const int*)all_p,
            (const int8_t*)slots, W, (const int*)lane_of,
            (const int*)start_of, nk, r, sigma, k, (uint8_t*)found,
            (int*)cnt);
    }
    return (int)cudaGetLastError();
}

// Kernel 10a.  slots int8 [lanes, W] -> out int32 [lanes, W] (fk = 0) or
// [lanes, 2W].
extern "C" int movi_prep_alc(const void* slots, int lanes, int W, int fk,
                             void* out, void* stream) {
    const int block = 256;
    const long long n = (long long)lanes * W;
    const long long grid = (n + block - 1) / block;
    if (grid > 0) {
        prep_alc_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const int8_t*)slots, lanes, W, fk, (int*)out);
    }
    return (int)cudaGetLastError();
}
