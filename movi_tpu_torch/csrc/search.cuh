// The one-step backward-search step on the search records, shared by the
// count and ZML scans and the k-mer machines.
//
// Search records (movi_tpu/engine/fused_search.py): int4 per (char, run),
// "down" rows [0, sigma*r) for the interval start, "up" rows
// [sigma*r, 2*sigma*r) for the interval end:
//   x: the nearest run with that char (r when there is none)
//   y: its LF destination run id
//   z: cum1 (0-15; 0xFFFF when that destination is the last run)
//      | its LF offset << 16
//   w: its length n
// init_rec[a+1] = (first_run, first_offset, last_run, last_offset).
#pragma once

#include <cstdint>

#include "records.cuh"

namespace movi {

struct Interval {
    int rs, os, re, oe;
};

__device__ __forceinline__ Interval interval_of(int4 v) {
    return Interval{v.x, v.y, v.z, v.w};
}

// initialize_backward_search from a table of sigma+1 rows (illegal chars
// read row 1, as the JAX engines do).
__device__ __forceinline__ Interval init_interval(const int4* init_rec,
                                                  int a) {
    return interval_of(init_rec[(a > 0 ? a : 0) + 1]);
}

// LF + bounded fast-forward from a search record and an in-dest offset.
__device__ __forceinline__ void lf_from_rec(int4 rec, int offset, int& run,
                                            int& off) {
    const int off0 = (int)((uint32_t)rec.z >> 16) + offset;
    const int cum1 = rec.z & 0xFFFF;
    const int ff = off0 >= cum1 ? 1 : 0;
    run = rec.y + ff;
    off = off0 - ff * cum1;
}

// The two rows a step reads: the "down" row of (char, rs) and the "up" row
// of (char, re).  down and up are the char's row bases, a_s*r and
// (sigma + a_s)*r; the two loads are independent and both are issued
// before either is used.
struct StepRows {
    int4 rd, ru;
};

__device__ __forceinline__ StepRows step_rows(const int4* __restrict__ rec_all,
                                              int64_t down, int64_t up, int r,
                                              const Interval& cur) {
    return StepRows{rec_all[down + clampi(cur.rs, 0, r - 1)],
                    rec_all[up + clampi(cur.re, 0, r - 1)]};
}

// The step's result from its rows: the next interval for char a, and
// whether it is empty.
__device__ __forceinline__ bool step_decode(const StepRows& rows, int r,
                                            const Interval& cur, int a,
                                            Interval& nxt) {
    const int4 rd = rows.rd, ru = rows.ru;
    const bool empty = a < 0 || rd.x >= r || rd.x > cur.re;
    const int os1 = rd.x != cur.rs ? 0 : cur.os;
    const int oe1 = ru.x != cur.re ? ru.w - 1 : cur.oe;
    lf_from_rec(rd, os1, nxt.rs, nxt.os);
    lf_from_rec(ru, oe1, nxt.re, nxt.oe);
    return empty;
}

// The two rows of a step from cur for char a (an illegal char reads
// char 0's rows, which step_decode ignores).
__device__ __forceinline__ StepRows bs_rows(const int4* __restrict__ rec_all,
                                            int r, int sigma,
                                            const Interval& cur, int a) {
    const int64_t a_s = a > 0 ? a : 0;
    return step_rows(rec_all, a_s * r, (sigma + a_s) * r, r, cur);
}

// backward_search_step (fused_bs_step): bs_rows, then step_decode.
__device__ __forceinline__ bool bs_step(const int4* __restrict__ rec_all,
                                        int r, int sigma, const Interval& cur,
                                        int a, Interval& nxt) {
    return step_decode(bs_rows(rec_all, r, sigma, cur, a), r, cur, a, nxt);
}

// Occurrences of the matched suffix: all_p[re] + oe - all_p[rs] - os + 1
// (int32 wraparound as in the JAX engines), 0 when nothing matched.
__device__ __forceinline__ int interval_count(const int* __restrict__ all_p,
                                              int r, const Interval& v,
                                              int matched) {
    if (matched <= 0) return 0;
    const uint32_t s = (uint32_t)all_p[clampi(v.rs, 0, r)] + (uint32_t)v.os;
    const uint32_t e = (uint32_t)all_p[clampi(v.re, 0, r)] + (uint32_t)v.oe;
    return (int)(e - s + 1u);
}

// Scan state rows in the [6, lanes] state tensors.
constexpr int ST_RS = 0, ST_OS = 1, ST_RE = 2, ST_OE = 3, ST_X = 4,
              ST_Y = 5;

}  // namespace movi
