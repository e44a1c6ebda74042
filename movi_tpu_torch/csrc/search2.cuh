// The paired backward-search step (two composed steps per record and
// direction), shared by the paired count and ZML scans (and, later, the
// paired k-mer counts).
//
// Paired search records (movi_tpu/engine/fused_search2.py): six int32
// words per (run, a1, a2) and direction; "down" rows [0, r*sigma^2) for
// the interval start, "up" rows [r*sigma^2, 2*r*sigma^2) for the end:
//   w0: A1 (0-24) | u1 (25) | u2_lo (26) | u2_hi (27)
//   w1: A2_lo (0-24)            w2: A2_hi (0-24)
//   w3: B1 (0-11) | C1 (12-23)  w4/w5: B2/C2 for the lo/hi branch
// No field reaches bit 31.  A 24 B row is only 8 B-aligned, so it is read
// as three 8 B loads; row offsets are 64-bit (2*r*sigma^2 rows of 6 words
// pass 2^31 words at r near 2^25).
#pragma once

#include <cstdint>

#include "search.cuh"

namespace movi {

constexpr int S2_GUARD = 0xFFF;
constexpr int A_MASK = 0x1FFFFFF;

struct Rec6 {
    int w[6];
};

__device__ __forceinline__ Rec6 load_rec6(const int* __restrict__ rec_all,
                                          int64_t row) {
    const int2* p = reinterpret_cast<const int2*>(rec_all + row * 6);
    const int2 a = p[0], b = p[1], c = p[2];
    return Rec6{{a.x, a.y, b.x, b.y, c.x, c.y}};
}

// off0 = B + u*off_in; ff = off0 >= C; (run, off) = (A + ff, off0 - ff*C)
__device__ __forceinline__ int micro(int A, int B, int C, int u, int off_in,
                                     int& run, int& off) {
    const int off0 = B + u * off_in;
    const int ff = off0 >= C ? 1 : 0;
    run = A + ff;
    off = off0 - ff * C;
    return ff;
}

// Two composed micro-steps of one direction: the mid-pair state (m) and
// the final one (f).
__device__ __forceinline__ void decode_dir(const Rec6& rec, int off_in,
                                           int& m_run, int& m_off,
                                           int& f_run, int& f_off) {
    const int w0 = rec.w[0];
    const int w3 = rec.w[3];
    const int ff1 = micro(w0 & A_MASK, w3 & S2_GUARD, (w3 >> 12) & S2_GUARD,
                          (w0 >> 25) & 1, off_in, m_run, m_off);
    const int A2 = (ff1 ? rec.w[2] : rec.w[1]) & A_MASK;
    const int wbc = ff1 ? rec.w[5] : rec.w[4];
    const int u2 = ff1 ? (w0 >> 27) & 1 : (w0 >> 26) & 1;
    micro(A2, wbc & S2_GUARD, (wbc >> 12) & S2_GUARD, u2, m_off, f_run,
          f_off);
}

__device__ __forceinline__ bool crossed(const Interval& v) {
    return v.rs > v.re || (v.rs == v.re && v.os > v.oe);
}

// The two rows of a pair step from cur for the pair a12: the down row of
// (rs, a12) and the up row of (re, a12), independent of each other.
struct PairRows {
    Rec6 rd, ru;
};

__device__ __forceinline__ PairRows bs2_rows(const int* __restrict__ rec_all,
                                             int r, int S2,
                                             const Interval& cur, int a12) {
    const int a = clampi(a12, 0, S2 - 1);
    return PairRows{
        load_rec6(rec_all, (int64_t)clampi(cur.rs, 0, r - 1) * S2 + a),
        load_rec6(rec_all, ((int64_t)r + clampi(cur.re, 0, r - 1)) * S2 + a)};
}

// The pair step's result from its rows: the mid and final intervals and
// their emptiness (e2 is meaningful only where !e1; callers gate it).
__device__ __forceinline__ void bs2_decode(const PairRows& rows,
                                           const Interval& cur, bool l1,
                                           bool l2, Interval& mid,
                                           Interval& fin, bool& e1,
                                           bool& e2) {
    decode_dir(rows.rd, cur.os, mid.rs, mid.os, fin.rs, fin.os);
    decode_dir(rows.ru, cur.oe, mid.re, mid.oe, fin.re, fin.oe);
    e1 = !l1 || crossed(mid);
    e2 = !l2 || crossed(fin);
}

// fused2_bs_step: two backward_search_steps for chars (a1, a2) packed as
// a12 = a1*sigma + a2, with legality l1, l2: bs2_rows, then bs2_decode.
// The down and up rows are both in flight before either is used.
__device__ __forceinline__ void bs2_step(const int* __restrict__ rec_all,
                                         int r, int S2, const Interval& cur,
                                         int a12, bool l1, bool l2,
                                         Interval& mid, Interval& fin,
                                         bool& e1, bool& e2) {
    bs2_decode(bs2_rows(rec_all, r, S2, cur, a12), cur, l1, l2, mid, fin, e1,
               e2);
}

// A pair code (a1+2)*8 + (a2+2) unpacked: a2, the packed pair a12 and
// both chars' legality.
struct PairCode {
    int a2, a12;
    bool l1, l2;
};

__device__ __forceinline__ PairCode pair_code(int v, int sigma) {
    const int a1 = (v >> 3) - 2;
    const int a2 = (v & 7) - 2;
    return PairCode{a2, (a1 > 0 ? a1 : 0) * sigma + (a2 > 0 ? a2 : 0),
                    a1 >= 0, a2 >= 0};
}

}  // namespace movi
