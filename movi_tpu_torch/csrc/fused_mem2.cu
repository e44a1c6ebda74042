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
// which exist for XLA's static shapes only.  Each tick is the JAX tick as
// straight-line code in the JAX order, and loads only the rows it uses: a
// step's two 32 B rows (as two int4 each), a RESOLVE's two pos2rba rows,
// one ftab row for an anchored BML INIT, or none.  The char at the tick's
// position is an indexed load from the lane's row of slots, and an
// emission a plain add into the lane's row of ends and counts (the TPU's
// one-hot selects and emits are not needed).  The tick budget and the
// state go in and out, so a run split in two equals one pass; each lane
// reports the ticks it ran and the rows it loaded.  A lane that comes in
// at phase ENTRY first gets its start state from its slots (BML: INIT or
// DONE by the read's length; all-MEMs: init_bidirectional at the first
// char, the JAX engine's jitted make_state).

#include <cuda_runtime.h>

#include <cstdint>

#include "mem2.cuh"

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

__global__ void mem2_kernel(
    const int* __restrict__ rec_all, const int* __restrict__ init6_g,
    const int* __restrict__ alc, int W, int alc_w, int lanes, int r,
    int sigma, int n, int fk, int L, long long ticks, int use_ftab,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ ends, int* __restrict__ counts,
    int* __restrict__ work) {
    extern __shared__ int init6[];  // (sigma + 1) rows of six words
    load_init6(init6_g, init6, sigma);
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    int phase = reg[0], pos = reg[1], jc = reg[2], end = reg[3];
    int frs = reg[4], fos = reg[5], fre = reg[6], foe = reg[7],
        fas = reg[8], fae = reg[9];
    int rrs = reg[10], ros = reg[11], rre = reg[12], roe = reg[13],
        ras = reg[14], rae = reg[15];
    const int* row = alc + (int64_t)lane * alc_w;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int64_t p2r = 2 * (int64_t)sigma * r;
    const int64_t ftb = p2r + n;
    if (phase == ENTRY) {  // the window at 0, or done for a short read
        phase = m >= L ? INIT : DONE;
        pos = jc = end = 0;
        frs = fos = fre = foe = fas = fae = 0;
        rrs = ros = rre = roe = ras = rae = 0;
    }

    long long t = 0;
    int rows = 0;  // 32 B rows loaded
    for (; t < ticks && phase != DONE; ++t) {
        // ---- INIT: anchor the window, init bidirectional
        const bool is_init = phase == INIT;
        const bool past_end = pos + L > m;
        const int c0 = row[clampi(pos + L - 1, 0, W - 1)];
        const bool do_init = is_init && !past_end && c0 >= 0;
        const bool init_illegal = is_init && !past_end && c0 < 0;
        const Iv6 i_f = movi::init6(init6, c0);
        int code0 = -1;
        if (!use_ftab) {
            // anchored lanes step in the same tick (fall into BACK)
            if (do_init) {
                frs = i_f.rs; fos = i_f.os; fre = i_f.re; foe = i_f.oe;
                fas = i_f.as; fae = i_f.ae;
                ras = movi::init6(init6, sigma - 1 - c0).as;
                jc = 0;
                phase = BACK;
            }
        } else {
            code0 = row[W + clampi(pos + L - 1, 0, W - 1)];
        }
        if (is_init && past_end) phase = DONE;
        if (init_illegal) pos = pos + L - 1;

        // ---- the tick's rows, phase-keyed
        const bool in_back = phase == BACK;
        const bool in_resolve = phase == RESOLVE;
        const bool in_fwd = phase == FWD;
        const bool in_next = phase == NEXT;
        const bool in_bscan = use_ftab && phase == BSCAN;
        const bool backish = in_back || in_bscan;
        const int p_step =
            backish ? pos + L - 2 - jc : (in_fwd ? jc : end - 1 - jc);
        const int c_raw = row[clampi(p_step, 0, W - 1)];
        const int c_fwd =
            c_raw >= 0 ? sigma - 1 - c_raw : (c_raw == -1 ? 0 : -1);
        int a = in_fwd ? c_fwd : c_raw;
        if (in_fwd && jc >= m) a = -1;
        const int iv_rs = in_fwd ? rrs : frs;
        const int iv_os = in_fwd ? ros : fos;
        const int iv_re = in_fwd ? rre : fre;
        const int iv_oe = in_fwd ? roe : foe;
        const int rae_want = ras + (fae - fas);  // rc end = start + count - 1
        const bool active = backish || in_fwd || in_next;
        Step2 st;
        st.empty = true;
        st.skip = 0;
        st.nxt = Iv6{0, 0, 0, 0, 0, 0};
        int2 res_s = make_int2(0, 0), res_e = make_int2(0, 0);
        movi::Row8 frow{{0, 0, 0, 0, 0, 0, 0, 0}};
        if (active && a >= 0) {
            st = movi::mem2_step(rec_all, r, sigma, a, iv_rs, iv_os, iv_re,
                                 iv_oe);
            rows += 2;
        } else if (in_resolve) {
            res_s = movi::load_p2r(rec_all, p2r + clampi(ras, 0, n - 1));
            res_e = movi::load_p2r(rec_all, p2r + clampi(rae_want, 0, n - 1));
            rows += 2;
        } else if (do_init && code0 >= 0) {  // use_ftab
            frow = movi::load_row8(rec_all, ftb + code0);
            rows += 1;
        }
        const bool ok = active && !st.empty;

        // ---- BACK/BSCAN: extend_left; rc in abs only
        const bool back_ok = backish && ok;
        int frs2 = frs, fos2 = fos, fre2 = fre, foe2 = foe, fas2 = fas,
            fae2 = fae;
        if (back_ok) {
            frs2 = st.nxt.rs; fos2 = st.nxt.os; fre2 = st.nxt.re;
            foe2 = st.nxt.oe; fas2 = st.nxt.as; fae2 = st.nxt.ae;
        }
        int ras2 = (in_back && ok) ? ras + st.skip : ras;
        const bool back_fail = backish && !ok;
        int pos2 = back_fail ? pos + L - 1 - jc : pos;
        int phase2 = back_fail ? INIT : phase;
        int jc2 = back_ok ? jc + 1 : jc;
        if (in_back && ok && jc2 >= L - 1) {
            phase2 = RESOLVE;
            jc2 = pos + L;
        }
        if (in_bscan && ok && jc2 >= L - 1) {
            // a completed BSCAN emits nothing and re-anchors one right
            phase2 = INIT;
            pos2 = pos + 1;
        }

        // ---- RESOLVE: rc abs -> (run, offset)
        int rrs2 = rrs, ros2 = ros, rre2 = rre, roe2 = roe, rae2 = rae;
        if (in_resolve) {
            rrs2 = res_s.x; ros2 = ras - res_s.y;
            rre2 = res_e.x; roe2 = rae_want - res_e.y;
            rae2 = rae_want;
            phase2 = FWD;
        }

        // ---- FWD: plain steps on rc; emit on failure
        if (in_fwd && ok) {
            rrs2 = st.nxt.rs; ros2 = st.nxt.os; rre2 = st.nxt.re;
            roe2 = st.nxt.oe; ras2 = st.nxt.as; rae2 = st.nxt.ae;
            jc2 = jc + 1;
        }
        const bool fwd_fail = in_fwd && !ok;
        int end2 = end;
        bool next_init_illegal = false;
        if (fwd_fail) {
            const int at = clampi(pos, 0, W - 1);
            erow[at] += jc;
            crow[at] += rae - ras + 1;
            end2 = jc;
            if (jc >= m) {
                phase2 = DONE;
            } else {
                // NEXT init: fw = init(seq[end]) (the char just read)
                phase2 = NEXT;
                const Iv6 nx = movi::init6(init6, c_raw);
                frs2 = nx.rs; fos2 = nx.os; fre2 = nx.re; foe2 = nx.oe;
                jc2 = 0;
                next_init_illegal = c_raw < 0;
            }
        }

        // ---- NEXT: backward-scan to the next candidate
        const bool exhausted = in_next && jc > end - pos - 2;
        const bool next_fail =
            (in_next && !ok && !exhausted) || next_init_illegal;
        if (in_next && ok && !exhausted) {
            frs2 = st.nxt.rs; fos2 = st.nxt.os; fre2 = st.nxt.re;
            foe2 = st.nxt.oe;
            jc2 = jc + 1;
        }
        const bool stop = next_fail || exhausted;
        if (stop && in_next) pos2 = end - jc;
        if (next_init_illegal) pos2 = end2;
        if (stop || next_init_illegal) phase2 = INIT;

        // ---- ftab INIT landing
        if (use_ftab && do_init) {
            if (code0 >= 0 && frow.w[7] == 1) {
                frs2 = frow.w[0]; fos2 = frow.w[1]; fre2 = frow.w[2];
                foe2 = frow.w[3]; fas2 = frow.w[4];
                fae2 = frow.w[4] + frow.w[5] - 1;
                ras2 = frow.w[6];
                // a row covering the whole window skips BACK
                jc2 = fk >= L ? pos + L : fk - 1;
                phase2 = fk >= L ? RESOLVE : BACK;
            } else {
                frs2 = i_f.rs; fos2 = i_f.os; fre2 = i_f.re; foe2 = i_f.oe;
                jc2 = 0;
                phase2 = BSCAN;
            }
        }

        phase = phase2; pos = pos2; jc = jc2; end = end2;
        frs = frs2; fos = fos2; fre = fre2; foe = foe2; fas = fas2;
        fae = fae2;
        rrs = rrs2; ros = ros2; rre = rre2; roe = roe2; ras = ras2;
        rae = rae2;
    }
    const int fin[NREG] = {phase, pos, jc, end, frs, fos, fre, foe, fas,
                           fae, rrs, ros, rre, roe, ras, rae};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
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
    int phase = reg[0], s = reg[1], ml = reg[2], e = reg[3];
    Iv6 f{reg[4], reg[5], reg[6], reg[7], reg[8], reg[9]};
    Iv6 rc{reg[10], reg[11], reg[12], reg[13], reg[14], reg[15]};
    const int* row = alc + (int64_t)lane * W;
    int* erow = ends + (int64_t)lane * W;
    int* crow = counts + (int64_t)lane * W;
    const int m = read_len(row, W);
    const int64_t p2r = 2 * (int64_t)sigma * r;
    if (phase == ENTRY) {  // init_bidirectional at the first char, ml = 1
        phase = m > 0 ? AM2_RIGHT : AM2_DONE;
        s = e = 0;
        ml = 1;
        init_pair6(init6, sigma, p1, row[0], f, rc);
    }

    long long t = 0;
    int rows = 0;
    for (; t < ticks && phase != AM2_DONE; ++t) {
        const bool in_right = phase == AM2_RIGHT;
        const bool in_left = phase == AM2_LEFT;
        const bool in_res = phase == AM2_RES;
        // one char: RIGHT at s+ml, LEFT at e-ml
        const int c_raw = row[clampi(in_right ? s + ml : e - ml, 0, W - 1)];
        const int a_right =
            c_raw >= 0 ? sigma - 1 - c_raw : (c_raw == -1 ? 0 : -1);
        const int a = in_right ? (s + ml < m ? a_right : -1)
                               : ((in_left && e - ml >= 0) ? c_raw : -1);
        const Iv6& iv = in_right ? rc : f;
        const bool stepping = in_right || in_left;
        Step2 st;
        st.empty = true;
        st.skip = 0;
        st.nxt = Iv6{0, 0, 0, 0, 0, 0};
        int2 res_s = make_int2(0, 0), res_e = make_int2(0, 0);
        if (stepping && a >= 0) {
            st = movi::mem2_step(rec_all, r, sigma, a, iv.rs, iv.os, iv.re,
                                 iv.oe);
            rows += 2;
        } else if (in_res) {
            // RES uses the CARRIED rae: after an illegal-char re-anchor the
            // fw side is the canonical empty interval, so the count sync
            // does not hold
            res_s = movi::load_p2r(rec_all, p2r + clampi(rc.as, 0, n - 1));
            res_e = movi::load_p2r(rec_all, p2r + clampi(rc.ae, 0, n - 1));
            rows += 2;
        }
        const bool ok = stepping && !st.empty;
        const bool right_ok = in_right && ok;
        const bool left_ok = in_left && ok;
        // the stepped side takes the decode; the companion advances in abs
        Iv6 f2 = f, rc2 = rc;
        if (right_ok) {
            rc2 = st.nxt;
            f2.as = f.as + st.skip;
            f2.ae = f.as + st.skip + (st.nxt.ae - st.nxt.as);
        }
        if (left_ok) {
            f2 = st.nxt;
            rc2.as = rc.as + st.skip;
            rc2.ae = rc2.as + (st.nxt.ae - st.nxt.as);
        }
        int ml2 = (right_ok || left_ok) ? ml + 1 : ml;
        int phase2 = phase, s2 = s, e2 = e;
        if (in_right && !ok) {
            // emit (s, s+ml, count(fw)) at s; the count clamps to 0 while
            // the fw side is the canonical empty interval (fas > fae)
            const int at = clampi(s, 0, W - 1);
            const int cnt = f.ae - f.as + 1;
            erow[at] += s + ml;
            crow[at] += cnt > 0 ? cnt : 0;
            e2 = s + ml;
            if (s + ml >= m) {
                phase2 = AM2_DONE;
            } else {
                // re-anchor: init at e, ml = 1, left-extend
                init_pair6(init6, sigma, p1, row[clampi(e2, 0, W - 1)], f2,
                           rc2);
                ml2 = 1;
                phase2 = AM2_LEFT;
            }
        }
        if (in_left && !ok) {
            // s = e - ml + 1, resolve rc, back to RIGHT
            s2 = e - ml + 1;
            phase2 = AM2_RES;
        }
        if (in_res) {
            rc2.rs = res_s.x; rc2.os = rc.as - res_s.y;
            rc2.re = res_e.x; rc2.oe = rc.ae - res_e.y;
            phase2 = AM2_RIGHT;
        }
        phase = phase2; s = s2; ml = ml2; e = e2; f = f2; rc = rc2;
    }
    const int fin[NREG] = {phase, s, ml, e, f.rs, f.os, f.re, f.oe, f.as,
                           f.ae, rc.rs, rc.os, rc.re, rc.oe, rc.as, rc.ae};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
}

}  // namespace

// Kernel 10b.  alc int32 [lanes, alc_w]: the read-order slots, followed
// with use_ftab by the fk-mer codes (alc_w = 2W).  st_in/st_out int32
// [16, lanes]; ends and counts int32 [lanes, W], added to in place; work
// int32 [2, lanes] gets each lane's ticks and 32 B rows.
extern "C" int movi_mem2_scan(const void* rec_all, const void* init6,
                              const void* alc, int W, int alc_w, int lanes,
                              int r, int sigma, int n, int fk, int L,
                              long long ticks, int use_ftab,
                              const void* st_in, void* st_out, void* ends,
                              void* counts, void* work, void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        mem2_kernel<<<grid, block, (size_t)(sigma + 1) * 6 * sizeof(int),
                      (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int*)init6, (const int*)alc, W,
            alc_w, lanes, r, sigma, n, fk, L, ticks, use_ftab,
            (const int*)st_in, (int*)st_out, (int*)ends, (int*)counts,
            (int*)work);
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
