// The MEM v2 combined table's rows and step, shared by the MEM machines
// (csrc/fused_mem2.cu) and the bidirectional k-mer counts
// (csrc/fused_kmer2.cu).
//
// Table (movi_tpu/engine/fused_mem2.py build_fused_mem2_index): eight
// int32 words per row, 32 B, read as two int4.
//   rows [0, sigma*r): "down" record of (char a, run), key a*r + run;
//   rows [sigma*r, 2*sigma*r): "up" record, key sigma*r + a*r + run:
//     w0 dest (the nearest run with char a; r when none), w1 its LF id,
//     w2 cum1 (0-15; 0xFFFF when id is the last run) | LF offset << 16,
//     w3 dest's length n, w4 all_p[id], w5 P_t[run], w6 U_t[run] at
//     t = comp(a) (the bidirectional skip weights);
//   rows [2*sigma*r, 2*sigma*r + n): pos2rba, w0 run, w1 all_p[run];
//   rows [2*sigma*r + n, .. + 4^fk): ftab anchors (rs, os, re, oe, abs_s,
//     count, rc_abs_s, valid).
// The offset field can reach bit 31 of w2, so w2 is decoded as uint32.
// Row numbers are 64-bit.
#pragma once

#include <cstdint>

#include "records.cuh"

namespace movi {

struct Row8 {
    int w[8];
};

__device__ __forceinline__ Row8 load_row8(const int* __restrict__ rec_all,
                                          int64_t row) {
    const int4* p = reinterpret_cast<const int4*>(rec_all + row * 8);
    const int4 a = p[0], b = p[1];
    return Row8{{a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w}};
}

// A pos2rba row's (run, all_p[run]): the first 8 B of its 32 B row.
__device__ __forceinline__ int2 load_p2r(const int* __restrict__ rec_all,
                                         int64_t row) {
    return *reinterpret_cast<const int2*>(rec_all + row * 8);
}

// An interval with both endpoints' absolute BWT positions.
struct Iv6 {
    int rs, os, re, oe, as, ae;
};

// init(a) with abs coordinates from init_rec6 (sigma+1 rows of six
// words); illegal chars read row 1, as the JAX engines do.
__device__ __forceinline__ Iv6 init6(const int* init_rec6, int a) {
    const int* p = init_rec6 + ((a > 0 ? a : 0) + 1) * 6;
    return Iv6{p[0], p[1], p[2], p[3], p[4], p[5]};
}

// LF + bounded fast-forward from a wide record: (run', off', abs').
__device__ __forceinline__ void decode_lf(const Row8& rec, int off_in,
                                          int& run, int& off, int& abs) {
    const uint32_t w2 = (uint32_t)rec.w[2];
    const int off0 = (int)(w2 >> 16) + off_in;
    const int cum1 = (int)(w2 & 0xFFFFu);
    const int ff = off0 >= cum1 ? 1 : 0;
    run = rec.w[1] + ff;
    off = off0 - ff * cum1;
    abs = rec.w[4] + off0;
}

// One backward_search_step's result.  skip is the companion interval's
// advance over the PRE-step interval (int32 arithmetic wrapping as in
// JAX; it cannot wrap for n < 2^31).
struct Step2 {
    Iv6 nxt;
    int skip;
    bool empty;
};

// Decode a step for char a from the rows of (a, rs) and (a, re).
__device__ __forceinline__ Step2 decode_step(const Row8& lo, const Row8& hi,
                                             int r, int a, int rs, int os,
                                             int re, int oe) {
    Step2 s;
    const int drs = lo.w[0];
    const int dre = hi.w[0];
    s.empty = a < 0 || drs >= r || drs > re;
    const int os1 = drs != rs ? 0 : os;
    const int oe1 = dre != re ? hi.w[3] - 1 : oe;
    decode_lf(lo, os1, s.nxt.rs, s.nxt.os, s.nxt.as);
    decode_lf(hi, oe1, s.nxt.re, s.nxt.oe, s.nxt.ae);
    s.skip = (int)((uint32_t)hi.w[5] + (uint32_t)hi.w[6] * (uint32_t)(oe + 1)
                   - (uint32_t)lo.w[5] - (uint32_t)lo.w[6] * (uint32_t)os);
    return s;
}

// The two rows a step reads: the down row of (a, rs) and the up row of
// (a, re); down and up are the char's row bases a_s*r and (sigma + a_s)*r.
// Both loads are issued before either is used.
struct StepRows8 {
    Row8 lo, hi;
};

__device__ __forceinline__ StepRows8 step_rows8(
    const int* __restrict__ rec_all, int64_t down, int64_t up, int r, int rs,
    int re) {
    return StepRows8{load_row8(rec_all, down + clampi(rs, 0, r - 1)),
                     load_row8(rec_all, up + clampi(re, 0, r - 1))};
}

// mem2_step: step_rows8 for char a >= 0, then decode_step.
__device__ __forceinline__ Step2 mem2_step(const int* __restrict__ rec_all,
                                           int r, int sigma, int a, int rs,
                                           int os, int re, int oe) {
    const int64_t a_s = a > 0 ? a : 0;
    const StepRows8 sr =
        step_rows8(rec_all, a_s * r, (sigma + a_s) * r, r, rs, re);
    return decode_step(sr.lo, sr.hi, r, a, rs, os, re, oe);
}

// mem2_resolve: (run, offset) of an absolute BWT row via pos2rba.
__device__ __forceinline__ void mem2_resolve(const int* __restrict__ rec_all,
                                             int64_t p2r, int n, int abs,
                                             int& run, int& off) {
    const int2 v = load_p2r(rec_all, p2r + clampi(abs, 0, n - 1));
    run = v.x;
    off = abs - v.y;
}

}  // namespace movi
