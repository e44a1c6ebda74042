// Kernels 10b and 10c: the MEM tick machines on the MEM v2 table.
//
// 10b replaces movi_tpu/engine/fused_mem2.py _mem2_scan (BML, with ftab
// anchors) and 10c replaces _all_mem2_scan (all-MEMs, entry state
// _init_pair6), both with the resume loop of their engines
// (fused_mem.py _resume_compacted).
//
// Bound on this card: the latency of the dependent row loads.  A lane's
// ticks form one chain (each tick's rows depend on the previous tick's
// interval and cursor), and the table of a real index (1.5 GB at five
// million runs) is far past the 50 MB L2.
// Design: one thread per read lane holds the machine (phase, cursors and
// both intervals, sixteen registers) and loops until its lane is done.  A
// done lane's tick changes nothing, so this equals the TPU's lockstep
// scan of 2W+84 (4W+64) tick quanta with lanes compacted between them,
// which exist for XLA's static shapes only.  Each tick is the JAX tick,
// and uses only the rows it needs: a step's two 32 B rows (as two int4
// each), a RESOLVE's two pos2rba rows, one ftab row for an anchored BML
// INIT, or none.  The char at the tick's position is an indexed load from
// the lane's row of slots, and an emission an add into the lane's row of
// ends and counts (the TPU's one-hot selects and emits are not needed).
// The tick budget and the state go in and out, so a run split in two
// equals one pass; each lane reports the ticks it ran, the rows it loaded
// and the ticks that loaded a step's rows (the chain no reordering
// shortens: each step's rows are addressed by the interval the last one
// decoded).  A lane that comes in at phase ENTRY first gets its start
// state from its slots (BML: INIT or DONE by the read's length; all-MEMs:
// init_bidirectional at the first char, the JAX engine's jitted
// make_state).
// Both machines are software-pipelined over their ticks, so that a tick
// waits on nothing but its own rows: every position the next tick can read
// follows from the registers, the chars and one bit (did the step succeed;
// 10b: or is the ftab row valid), so while the rows are in flight the tick
// loads the chars of both outcomes (10b: an INIT tick's second char or
// fk-mer code too); 10c also plans both next ticks, 10b plans the one the
// bit picks (the select of two plans cost it more).  When the rows arrive,
// the bit picks the outcome and the next tick's rows (a step's, a RESOLVE
// or RES tick's pos2rba rows, an ftab row) are issued before anything else;
// the emissions are reductions (atomicAdd into the lane's own rows) that
// no load waits on, and a re-anchor takes the tick's own char.  A batch
// with few lanes is spread over the card's SMs (spread.cuh; 10b).

#include <cuda_runtime.h>

#include <cstdint>

#include "mem2.cuh"
#include "spread.cuh"

namespace {

using movi::clampi;
using movi::Iv6;
using movi::Step2;

constexpr int INIT = 0, BACK = 1, RESOLVE = 2, FWD = 3, NEXT = 4, DONE = 5,
              BSCAN = 6;
constexpr int AM2_RIGHT = 0, AM2_LEFT = 1, AM2_RES = 2, AM2_DONE = 3;
constexpr int ENTRY = -1;  // the start state is still to be built
constexpr int NREG = 16;

__device__ __forceinline__ void load_init6(const int* __restrict__ g,
                                           int* s, int sigma) {
    for (int i = threadIdx.x; i < (sigma + 1) * 6; i += blockDim.x)
        s[i] = g[i];
    __syncthreads();
}

// m: the lane's positions inside its read (slot != -2: a '#' is -3 and
// inside the read, where the JAX machines' slot > -2 drops it).
__device__ __forceinline__ int read_len(const int* row, int W) {
    int m = 0;
    for (int j = 0; j < W; ++j) m += row[j] != -2 ? 1 : 0;
    return m;
}

// A BML lane's registers apart from its two intervals.
struct BmlRegs {
    int phase, pos, jc, end;
};

// The two alc indices a tick reads: its char and, on an INIT tick, the
// second one it needs (with ftab the fk-mer code at the window's end, else
// the char the anchored window steps on in the same tick).  A RESOLVE tick
// reads none; it holds the char of the FWD tick after it, at jc.
__device__ __forceinline__ int2 bml_pos(const BmlRegs& q, int W, int L,
                                        int use_ftab) {
    int p;
    if (q.phase == INIT || q.phase == DONE) {
        p = q.pos + L - 1;
    } else if (q.phase == BACK || q.phase == BSCAN) {
        p = q.pos + L - 2 - q.jc;
    } else if (q.phase == NEXT) {
        p = q.end - 1 - q.jc;
    } else {  // FWD, RESOLVE
        p = q.jc;
    }
    const int a = clampi(p, 0, W - 1);
    return make_int2(a, use_ftab ? W + a : clampi(q.pos + L - 2, 0, W - 1));
}

// What a tick decides before its rows arrive, from its registers and the
// chars at bml_pos: its INIT part (which loads no row) applied to the
// registers, and the rows the rest of it loads.
struct BmlPlan {
    BmlRegs q;         // the registers after the INIT part
    int c;             // the char at the tick's first index
    int a;             // the step's char (FWD: the complement), or -1
    int code;          // an anchored ftab INIT's fk-mer code, or -1
    int64_t down, up;  // the step's row bases
    bool back, bscan, fwd, next, resolve;
    bool ftab;         // an anchored INIT with ftab: its row decides
    bool anchor;       // an anchored INIT without ftab: steps as BACK
    bool stepping;     // loads a step's two rows
    bool exhausted;    // a NEXT tick past its candidates
};

__device__ __forceinline__ BmlPlan bml_plan(const BmlRegs& q, int c, int cb,
                                            int m, int L, int use_ftab, int r,
                                            int sigma) {
    BmlPlan P;
    P.q = q;
    P.c = c;
    P.code = -1;
    P.ftab = P.anchor = false;
    if (q.phase == INIT) {
        if (q.pos + L > m) {
            P.q.phase = DONE;
        } else if (c < 0) {
            P.q.pos = q.pos + L - 1;  // re-anchor past the illegal char
        } else if (use_ftab) {
            P.ftab = true;
            P.code = cb;
        } else {
            P.anchor = true;
            P.q.phase = BACK;
            P.q.jc = 0;
        }
    }
    const int ph = P.q.phase;
    P.back = ph == BACK;
    P.bscan = ph == BSCAN;
    P.fwd = ph == FWD;
    P.next = ph == NEXT;
    P.resolve = ph == RESOLVE;
    const int craw = P.anchor ? cb : c;
    int a = P.fwd ? (craw >= 0 ? sigma - 1 - craw : (craw == -1 ? 0 : -1))
                  : craw;
    if (P.fwd && q.jc >= m) a = -1;
    const bool active = P.back || P.bscan || P.fwd || P.next;
    P.a = active ? a : -1;
    P.stepping = P.a >= 0;
    P.exhausted = P.next && q.jc > q.end - q.pos - 2;
    const int64_t a_s = P.a > 0 ? P.a : 0;
    P.down = a_s * r;
    P.up = (sigma + a_s) * r;
    return P;
}

// The registers after a tick, given its one bit: the step's rows came
// back non-empty, or the ftab row is valid.  A tick without that bit (no
// rows, or RESOLVE) takes ok = false.
__device__ __forceinline__ BmlRegs bml_next(const BmlPlan& P, bool ok, int m,
                                            int L, int fk) {
    BmlRegs n = P.q;
    const BmlRegs& q = P.q;
    if (P.ftab) {
        // a row covering the whole window skips BACK
        if (ok) {
            n.phase = fk >= L ? RESOLVE : BACK;
            n.jc = fk >= L ? q.pos + L : fk - 1;
        } else {
            n.phase = BSCAN;
            n.jc = 0;
        }
    } else if (P.back || P.bscan) {
        if (!ok) {
            n.phase = INIT;
            n.pos = q.pos + L - 1 - q.jc;
        } else if (q.jc + 1 >= L - 1) {
            // BACK resolves; a completed BSCAN emits nothing and
            // re-anchors one right
            n.jc = P.back ? q.pos + L : q.jc + 1;
            n.phase = P.back ? RESOLVE : INIT;
            n.pos = P.back ? q.pos : q.pos + 1;
        } else {
            n.jc = q.jc + 1;
        }
    } else if (P.resolve) {
        n.phase = FWD;
    } else if (P.fwd) {
        if (ok) {
            n.jc = q.jc + 1;
        } else {
            // emit, then the backward scan from end = jc (or a re-anchor
            // there past an illegal char; done at the read's end)
            n.end = q.jc;
            if (q.jc >= m) {
                n.phase = DONE;
            } else {
                n.jc = 0;
                n.phase = P.c < 0 ? INIT : NEXT;
                if (P.c < 0) n.pos = q.jc;
            }
        }
    } else if (P.next) {
        if (ok && !P.exhausted) {
            n.jc = q.jc + 1;
        } else {
            n.phase = INIT;
            n.pos = q.end - q.jc;
        }
    }
    return n;
}

__global__ void mem2_kernel(
    const int* __restrict__ rec_all, const int* __restrict__ init6_g,
    const int* __restrict__ alc, int W, int alc_w, int lanes, int r,
    int sigma, int n, int fk, int L, long long ticks, int use_ftab,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ ends, int* __restrict__ counts,
    int* __restrict__ work, int lpw) {
    extern __shared__ int init6[];  // (sigma + 1) rows of six words
    load_init6(init6_g, init6, sigma);
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    BmlRegs q{reg[0], reg[1], reg[2], reg[3]};
    Iv6 f{reg[4], reg[5], reg[6], reg[7], reg[8], reg[9]};
    Iv6 rc{reg[10], reg[11], reg[12], reg[13], reg[14], reg[15]};
    const int* row = alc + (int64_t)lane * alc_w;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int* p2r = rec_all + 2 * (int64_t)sigma * r * 8;
    const int* ftab = p2r + (int64_t)n * 8;
    // 0 (the wrapper takes ticks >= 0), but not to the compiler: the
    // interval a step reads and its rows' unused words are and-ed with it
    // and kept past the decode, so that neither row's load may reuse their
    // registers (which would order the second row's load after the first
    // row's arrival) nor an instruction reuse a row's register in flight
    const int keep = (int)(ticks >> 63);
    if (q.phase == ENTRY) {  // the window at 0, or done for a short read
        q = BmlRegs{m >= L ? INIT : DONE, 0, 0, 0};
        f = Iv6{0, 0, 0, 0, 0, 0};
        rc = Iv6{0, 0, 0, 0, 0, 0};
    }

    // The first tick's chars and rows; from then on each tick loads the
    // next tick's chars while its own rows are in flight, and issues the
    // next tick's rows as soon as they are addressed.
    int2 ix = bml_pos(q, W, L, use_ftab);
    BmlPlan P = bml_plan(q, row[ix.x], q.phase == INIT ? row[ix.y] : 0, m, L,
                         use_ftab, r, sigma);
    Iv6 siv{};  // the interval the step reads (rs, os, re, oe)
    movi::StepRows8 sr{};
    movi::Row8 frow{};
    int2 res_s = make_int2(0, 0), res_e = make_int2(0, 0);
    // issue a planned tick's rows: a step's two rows, a RESOLVE's two
    // pos2rba rows of rc's abs ends, or an ftab anchor row
    auto issue = [&](const BmlPlan& p) {
        if (p.stepping) {
            siv = p.anchor ? movi::init6(init6, p.c) : (p.fwd ? rc : f);
            sr = movi::step_rows8(rec_all, p.down, p.up, r, siv.rs, siv.re);
        } else if (p.resolve) {
            res_s = movi::load_p2r(p2r, clampi(rc.as, 0, n - 1));
            res_e = movi::load_p2r(
                p2r, clampi(rc.as + (f.ae - f.as), 0, n - 1));
        } else if (p.code >= 0) {
            frow = movi::load_row8(ftab, p.code);
        }
    };
    issue(P);

    long long t = 0;
    int rows = 0;   // 32 B rows loaded
    int steps = 0;  // ticks that loaded a step's rows
    while (t < ticks && q.phase != DONE) {
        // 1. while this tick's rows are in flight: both outcomes'
        //    registers and chars; the init interval of the tick's char (a
        //    failed FWD's NEXT, an ftab miss); the emission
        const BmlRegs q0 = bml_next(P, true, m, L, fk);
        const BmlRegs q1 = bml_next(P, false, m, L, fk);
        const int2 ix0 = bml_pos(q0, W, L, use_ftab);
        const int2 ix1 = bml_pos(q1, W, L, use_ftab);
        const int ca0 = row[ix0.x], ca1 = row[ix1.x];
        const int cb0 = q0.phase == INIT ? row[ix0.y] : 0;
        const int cb1 = q1.phase == INIT ? row[ix1.y] : 0;
        const Iv6 ini = movi::init6(init6, P.c);
        const int at = clampi(P.q.pos, 0, W - 1);
        const int e_end = P.q.jc;
        const int e_cnt = rc.ae - rc.as + 1;

        // 2. the rows decide the bit; the registers take the outcome
        bool ok = false;
        if (P.anchor) {  // init bidirectional at c0, then BACK's step
            f = ini;
            rc.as = movi::init6(init6, sigma - 1 - P.c).as;
        }
        if (P.stepping) {
            const Step2 st = movi::decode_step(sr.lo, sr.hi, r, P.a, siv.rs,
                                               siv.os, siv.re, siv.oe);
            ok = !st.empty;
            rows += 2;
            steps += 1 + ((sr.lo.w[3] | sr.lo.w[7] | sr.hi.w[7] | siv.rs |
                           siv.os | siv.re | siv.oe) & keep);
            if (ok && (P.back || P.bscan)) {
                if (P.back) rc.as = rc.as + st.skip;
                f = st.nxt;
            } else if (ok && P.fwd) {
                rc = st.nxt;
            } else if (ok && P.next && !P.exhausted) {
                f.rs = st.nxt.rs; f.os = st.nxt.os;
                f.re = st.nxt.re; f.oe = st.nxt.oe;
            }
        } else if (P.resolve) {  // rc abs -> (run, offset)
            rc.ae = rc.as + (f.ae - f.as);
            rc.rs = res_s.x; rc.os = rc.as - res_s.y;
            rc.re = res_e.x; rc.oe = rc.ae - res_e.y;
            rows += 2;
        } else if (P.ftab) {
            ok = P.code >= 0 && frow.w[7] == 1;
            rows += P.code >= 0 ? 1 : 0;
            if (ok) {
                f = Iv6{frow.w[0], frow.w[1], frow.w[2], frow.w[3],
                        frow.w[4], frow.w[4] + frow.w[5] - 1};
                rc.as = frow.w[6];
            }
        }
        // a failed FWD inits fw at the char it read; an ftab miss at c0
        if ((P.fwd && !ok && P.q.jc < m) || (P.ftab && !ok)) {
            f.rs = ini.rs; f.os = ini.os; f.re = ini.re; f.oe = ini.oe;
        }
        const bool emit = P.fwd && !ok;
        q = ok ? q0 : q1;
        P = bml_plan(q, ok ? ca0 : ca1, ok ? cb0 : cb1, m, L, use_ftab, r,
                     sigma);
        ++t;

        // 3. the next tick's rows, planned from its chars in registers and
        //    addressed now: the chain's only loads that wait on this
        //    tick's rows
        issue(P);
        // emit (jc, count(rc)) at pos: reductions into the lane's own
        // rows that no load waits on
        if (emit) {
            atomicAdd(erow + at, e_end);
            atomicAdd(crow + at, e_cnt);
        }
    }
    const int fin[NREG] = {q.phase, q.pos, q.jc, q.end, f.rs, f.os, f.re,
                           f.oe, f.as, f.ae, rc.rs, rc.os, rc.re, rc.oe,
                           rc.as, rc.ae};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
    work[2 * lanes + lane] = steps;
}

// init_bidirectional at c: fw from c (the canonical empty interval, abs
// form (p1, 0), when illegal), rc from its complement (an unknown char
// other than '#' complements to 'A').
__device__ __forceinline__ void init_pair6(const int* init6, int sigma,
                                           int p1, int c, Iv6& fw, Iv6& rc) {
    const Iv6 empty{1, 0, 0, 0, p1, 0};
    fw = c >= 0 ? movi::init6(init6, c) : empty;
    const int cr = c >= 0 ? sigma - 1 - c : (c == -1 ? 0 : -1);
    rc = cr >= 0 ? movi::init6(init6, cr) : empty;
}

// An all-MEMs lane's registers apart from its two intervals.
struct AmRegs {
    int phase, s, ml, e;
};

// The position of the char a tick reads: RIGHT at s+ml, LEFT at e-ml.  A
// RES tick reads none; it holds the char of the RIGHT tick after it, at
// s+ml too.
__device__ __forceinline__ int am_pos(const AmRegs& q, int W) {
    return clampi(q.phase == AM2_LEFT ? q.e - q.ml : q.s + q.ml, 0, W - 1);
}

// What a tick decides before its rows arrive, from its registers and char.
struct AmPlan {
    int a;             // the step's char (RIGHT: the complement), or -1
    int64_t down, up;  // its row bases
    bool right, left, res;
    bool stepping;     // loads the step's rows: RIGHT or LEFT with a >= 0
};

__device__ __forceinline__ AmPlan am_plan(const AmRegs& q, int c, int m,
                                          int r, int sigma) {
    AmPlan P;
    P.right = q.phase == AM2_RIGHT;
    P.left = q.phase == AM2_LEFT;
    P.res = q.phase == AM2_RES;
    const int a_right =
        c >= 0 ? sigma - 1 - c : (c == -1 ? 0 : -1);
    P.a = P.right ? (q.s + q.ml < m ? a_right : -1)
                  : ((P.left && q.e - q.ml >= 0) ? c : -1);
    const int64_t a_s = P.a > 0 ? P.a : 0;
    P.down = a_s * r;
    P.up = (sigma + a_s) * r;
    P.stepping = (P.right || P.left) && P.a >= 0;
    return P;
}

// Issue a tick's rows: a step's two rows of the stepped side's interval,
// or a RES tick's two pos2rba rows of rc's abs ends.
__device__ __forceinline__ void issue_rows(const int* __restrict__ rec_all,
                                           const int* __restrict__ p2r, int r,
                                           int n, const AmPlan& P,
                                           const Iv6& f, const Iv6& rc,
                                           movi::StepRows8& sr, int2& res_s,
                                           int2& res_e) {
    if (P.stepping) {
        sr = movi::step_rows8(rec_all, P.down, P.up, r,
                              P.right ? rc.rs : f.rs,
                              P.right ? rc.re : f.re);
    } else if (P.res) {
        res_s = movi::load_p2r(p2r, clampi(rc.as, 0, n - 1));
        res_e = movi::load_p2r(p2r, clampi(rc.ae, 0, n - 1));
    }
}

// The registers after a tick whose step succeeded (ok) or not; a RES
// tick's are the same either way.
__device__ __forceinline__ AmRegs am_next(const AmRegs& q, const AmPlan& P,
                                         bool ok, int m) {
    if (P.res) return AmRegs{AM2_RIGHT, q.s, q.ml, q.e};
    if (ok) return AmRegs{q.phase, q.s, q.ml + 1, q.e};
    if (P.left) return AmRegs{AM2_RES, q.e - q.ml + 1, q.ml, q.e};
    // RIGHT fails: emit, then re-anchor at e = s+ml (done at the read's end)
    const int e2 = q.s + q.ml;
    return e2 >= m ? AmRegs{AM2_DONE, q.s, q.ml, e2}
                   : AmRegs{AM2_LEFT, q.s, 1, e2};
}

__global__ void all_mem2_kernel(
    const int* __restrict__ rec_all, const int* __restrict__ init6_g,
    const int* __restrict__ alc, int W, int lanes, int r, int sigma, int n,
    int p1, long long ticks, const int* __restrict__ st_in,
    int* __restrict__ st_out, int* __restrict__ ends,
    int* __restrict__ counts, int* __restrict__ work) {
    extern __shared__ int init6[];
    load_init6(init6_g, init6, sigma);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    AmRegs q{reg[0], reg[1], reg[2], reg[3]};
    Iv6 f{reg[4], reg[5], reg[6], reg[7], reg[8], reg[9]};
    Iv6 rc{reg[10], reg[11], reg[12], reg[13], reg[14], reg[15]};
    const int* row = alc + (int64_t)lane * W;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int* p2r = rec_all + 2 * (int64_t)sigma * r * 8;
    // 0 (the wrapper takes ticks >= 0), but not to the compiler: the row
    // words no decode reads are and-ed with it and kept, so that their
    // registers stay live until the rows land (an instruction that reused
    // one would wait on the whole in-flight load)
    const int keep = (int)(ticks >> 63);
    if (q.phase == ENTRY) {  // init_bidirectional at the first char, ml = 1
        q = AmRegs{m > 0 ? AM2_RIGHT : AM2_DONE, 0, 1, 0};
        init_pair6(init6, sigma, p1, row[0], f, rc);
    }

    // The first tick's char and rows; from then on each tick loads the
    // next tick's chars while its own rows are in flight, and issues the
    // next tick's rows as soon as they are addressed.  RES uses the CARRIED
    // rae: after an illegal-char re-anchor the fw side is the canonical
    // empty interval, so the count sync does not hold.
    int c = row[am_pos(q, W)];
    AmPlan P = am_plan(q, c, m, r, sigma);
    movi::StepRows8 sr{};
    int2 res_s = make_int2(0, 0), res_e = make_int2(0, 0);
    issue_rows(rec_all, p2r, r, n, P, f, rc, sr, res_s, res_e);

    long long t = 0;
    int rows = 0;   // 32 B rows loaded
    int steps = 0;  // ticks that loaded a step's rows
    while (t < ticks && q.phase != AM2_DONE) {
        // 1. while this tick's rows are in flight: both outcomes'
        //    registers, chars and plans, the re-anchor's intervals
        const AmRegs q0 = am_next(q, P, true, m);
        const AmRegs q1 = am_next(q, P, false, m);
        const int c0 = P.res ? c : row[am_pos(q0, W)];
        const int c1 = P.res ? c : row[am_pos(q1, W)];
        const AmPlan P0 = am_plan(q0, c0, m, r, sigma);
        const AmPlan P1 = am_plan(q1, c1, m, r, sigma);
        Iv6 f_init, rc_init;  // init_bidirectional at e = s+ml: this char
        init_pair6(init6, sigma, p1, c, f_init, rc_init);
        const int at = clampi(q.s, 0, W - 1);
        const int cnt = f.ae - f.as + 1;
        const int ends_add = q.s + q.ml;

        // 2. the rows decide ok; the stepped side takes the decode, the
        //    companion advances in abs
        bool ok = false;
        if (P.stepping) {
            const Iv6 iv = P.right ? rc : f;
            const Step2 st = movi::decode_step(sr.lo, sr.hi, r, P.a, iv.rs,
                                               iv.os, iv.re, iv.oe);
            ok = !st.empty;
            rows += 2;
            steps += 1 + ((sr.lo.w[3] | sr.lo.w[7] | sr.hi.w[7]) & keep);
            if (ok && P.right) {
                f.as = f.as + st.skip;
                f.ae = f.as + (st.nxt.ae - st.nxt.as);
                rc = st.nxt;
            } else if (ok) {
                rc.as = rc.as + st.skip;
                rc.ae = rc.as + (st.nxt.ae - st.nxt.as);
                f = st.nxt;
            }
        } else if (P.res) {
            rc.rs = res_s.x;
            rc.os = rc.as - res_s.y;
            rc.re = res_e.x;
            rc.oe = rc.ae - res_e.y;
            rows += 2;
        }
        const bool emit = P.right && !ok;
        if (emit && q1.phase == AM2_LEFT) {  // re-anchor at e = s+ml
            f = f_init;
            rc = rc_init;
        }
        q = ok ? q0 : q1;
        P = ok ? P0 : P1;
        c = ok ? c0 : c1;
        ++t;

        // 3. the next tick's rows, addressed now: the chain's only loads
        //    that wait on this tick's rows
        issue_rows(rec_all, p2r, r, n, P, f, rc, sr, res_s, res_e);
        // emit (s, s+ml, count(fw)) at s: reductions into the lane's own
        // rows that no load waits on; the count clamps to 0 while the fw
        // side is the canonical empty interval (fas > fae)
        if (emit) {
            atomicAdd(erow + at, ends_add);
            atomicAdd(crow + at, cnt > 0 ? cnt : 0);
        }
    }
    const int fin[NREG] = {q.phase, q.s, q.ml, q.e, f.rs, f.os, f.re, f.oe,
                           f.as, f.ae, rc.rs, rc.os, rc.re, rc.oe, rc.as,
                           rc.ae};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
    work[2 * lanes + lane] = steps;
}

}  // namespace

// Kernel 10b.  alc int32 [lanes, alc_w]: the read-order slots, followed
// with use_ftab by the fk-mer codes (alc_w = 2W).  st_in/st_out int32
// [16, lanes]; ends and counts int32 [lanes, W], added to in place; work
// int32 [3, lanes] gets each lane's ticks, 32 B rows and step ticks.
extern "C" int movi_mem2_scan(const void* rec_all, const void* init6,
                              const void* alc, int W, int alc_w, int lanes,
                              int r, int sigma, int n, int fk, int L,
                              long long ticks, int use_ftab,
                              const void* st_in, void* st_out, void* ends,
                              void* counts, void* work, void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 128, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        mem2_kernel<<<s.grid, s.block, (size_t)(sigma + 1) * 6 * sizeof(int),
                      (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int*)init6, (const int*)alc, W,
            alc_w, lanes, r, sigma, n, fk, L, ticks, use_ftab,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work, s.lpw);
    }
    return (int)cudaGetLastError();
}

// Kernel 10c.  alc int32 [lanes, W]; the rest as kernel 10b.
extern "C" int movi_all_mem2_scan(const void* rec_all, const void* init6,
                                  const void* alc, int W, int lanes, int r,
                                  int sigma, int n, int p1, long long ticks,
                                  const void* st_in, void* st_out,
                                  void* ends, void* counts, void* work,
                                  void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        all_mem2_kernel<<<grid, block, (size_t)(sigma + 1) * 6 * sizeof(int),
                          (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int*)init6, (const int*)alc, W,
            lanes, r, sigma, n, p1, ticks, (const int*)st_in, (int*)st_out,
            (int*)ends, (int*)counts, (int*)work);
    }
    return (int)cudaGetLastError();
}
