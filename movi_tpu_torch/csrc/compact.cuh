// LF with the unbounded fast-forward and the backward-search interval
// update on the compact run tables (movi_tpu_torch/engine/device_index.py),
// shared by the compact PML, count and ZML scans; the run search through
// the row -> run directory (find_run_dir2) serves the MEM v1 machines
// (csrc/fused_mem.cu).
//
// Tables: n, lf_abs, c_search int32 [r]; all_p int32 [r+1] (all_p[r] = n,
// the text length); ch_up_s/ch_down_s int32 [sigma, r] (r: none).
#pragma once

#include <cstdint>

namespace movi {
namespace compact {

// The run holding absolute row x: the last i in [0, r] with all_p[i] <= x
// (searchsorted(all_p, x, side="right") - 1 for 0 <= x), by a branch-free
// binary search over all_p (a fixed number of dependent loads for a given
// r).
__device__ __forceinline__ int find_run(const int* __restrict__ all_p, int r,
                                        int x) {
    int base = 0;
    // all_p[base] <= x throughout, and the answer stays in [base,
    // base+len)
    for (int len = r + 1; len > 1; len -= len >> 1)
        if (__ldg(all_p + base + (len >> 1)) <= x) base += len >> 1;
    return base;
}

// find_run of two rows, the two searches interleaved so that both chains
// of loads are in flight at once.
__device__ __forceinline__ void find_run2(const int* __restrict__ all_p,
                                          int r, int xs, int xe, int& bs,
                                          int& be) {
    bs = 0;
    be = 0;
    for (int len = r + 1; len > 1; len -= len >> 1) {
        const int half = len >> 1;
        const int vs = __ldg(all_p + bs + half);
        const int ve = __ldg(all_p + be + half);
        if (vs <= xs) bs += half;
        if (ve <= xe) be += half;
    }
}

// The row -> run directory (csrc/fused_mem.cu, kernel 13d): dir[k] =
// find_run(k << b) for k < K = ((n-1) >> b) + 1, and dir[K] = r.  The run
// holding row x lies in [dir[k], dir[k+1]] for k = x >> b (clamped to
// [0, K-1]), and the runs starting in a bucket of 2^b rows number at most
// 2^b, so a branch-free search of that span takes ceil(log2(dir[k+1] -
// dir[k] + 1)) <= b + 1 halvings: the same for every row of the bucket.
// On the all_p of non-empty runs (all_p[0] = 0, strictly increasing, as
// every move index has) the result is find_run's for every int32 x: run 0
// for x < 0 and run r for x >= n.
struct RunDir {
    const int* __restrict__ dir;  // [K+1]
    int K, b;
};

__device__ __forceinline__ int dir_bucket(const RunDir& d, int x) {
    const int k = x >> d.b;
    return k < 0 ? 0 : (k > d.K - 1 ? d.K - 1 : k);
}

// find_run of two rows xs and xe through the directory, the two searches
// interleaved so that their loads issue together: bs = find_run(xs), ps =
// all_p[bs] (be, pe for xe).  One dependent load of each row's directory
// pair, then all_p[dir[k]] issued with the first halving and carried
// through the search (a halving that moves takes the row it compared), so
// no load follows the last halving; a search that is done loads nothing
// more.  h counts the halvings of both.
__device__ __forceinline__ void find_run_dir2(const int* __restrict__ all_p,
                                              const RunDir& d, int xs,
                                              int xe, int& bs, int& ps,
                                              int& be, int& pe, int& h) {
    const int ks = dir_bucket(d, xs);
    const int ke = dir_bucket(d, xe);
    bs = __ldg(d.dir + ks);
    be = __ldg(d.dir + ke);
    int ls = __ldg(d.dir + ks + 1) - bs + 1;
    int le = __ldg(d.dir + ke + 1) - be + 1;
    ps = __ldg(all_p + bs);
    pe = __ldg(all_p + be);
    while (ls > 1 || le > 1) {
        const int hs = ls >> 1, he = le >> 1;  // 0 once a search is done
        const int vs = hs > 0 ? __ldg(all_p + bs + hs) : ps;
        const int ve = he > 0 ? __ldg(all_p + be + he) : pe;
        h += (hs > 0 ? 1 : 0) + (he > 0 ? 1 : 0);
        if (vs <= xs) {
            bs += hs;
            ps = vs;
        }
        if (ve <= xe) {
            be += he;
            pe = ve;
        }
        ls -= hs;
        le -= he;
    }
}

// LF_move + fast_forward for one (run, offset): the absolute destination
// lf_abs[idx] + off, mapped back to (run, offset) by find_run.
__device__ __forceinline__ void lf(const int* __restrict__ lf_abs,
                                   const int* __restrict__ all_p, int r,
                                   int& idx, int& off) {
    const int x = __ldg(lf_abs + idx) + off;
    idx = find_run(all_p, r, x);
    off = x - __ldg(all_p + idx);
}

// LF on both ends of an interval (find_run2).
__device__ __forceinline__ void lf2(const int* __restrict__ lf_abs,
                                    const int* __restrict__ all_p, int r,
                                    int& rs, int& os, int& re, int& oe) {
    const int xs = __ldg(lf_abs + rs) + os;
    const int xe = __ldg(lf_abs + re) + oe;
    find_run2(all_p, r, xs, xe, rs, re);
    os = xs - __ldg(all_p + rs);
    oe = xe - __ldg(all_p + re);
}

struct Tables {
    const int* __restrict__ n;
    const int* __restrict__ lf_abs;
    const int* __restrict__ all_p;
    const int* __restrict__ c_search;
    const int* __restrict__ ch_up_s;
    const int* __restrict__ ch_down_s;
    int r, sigma;
};

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

// backward_search_step (movi_tpu/engine/search.py _bs_step over
// _interval_update), clamped where the JAX engine clamps: the interval
// (rs, os, re, oe) moves to the next one for char a, and the result says
// whether it is empty (an illegal char is empty; its interval is then
// unspecified but deterministic).
__device__ __forceinline__ bool bs_step(const Tables& T, int a, int& rs,
                                        int& os, int& re, int& oe) {
    const int r = T.r;
    const int64_t last = (int64_t)T.sigma * r - 1;
    const int64_t a_flat = (int64_t)(a > 0 ? a : 0) * r;
    const int a_s = a > 0 ? a : 0;
    const int re_safe = mini(re, r - 1);
    // the two ends' chars are independent loads
    const int cs = __ldg(T.c_search + rs);
    const int ce = __ldg(T.c_search + re_safe);
    int rs1 = rs, os1 = os;
    if (cs != a_s) {
        const int64_t at = a_flat + rs;
        rs1 = __ldg(T.ch_down_s + (at < last ? at : last));
        os1 = 0;
    }
    int re1 = re_safe, oe1 = oe;
    if (ce != a_s) {
        const int64_t at = a_flat + re_safe;
        re1 = mini(__ldg(T.ch_up_s + (at < last ? at : last)), r - 1);
        oe1 = __ldg(T.n + re1) - 1;
    }
    const bool empty = a < 0 || rs1 >= r || rs1 > re;
    rs1 = mini(rs1, r - 1);
    lf2(T.lf_abs, T.all_p, r, rs1, os1, re1, oe1);
    rs = rs1;
    os = os1;
    re = re1;
    oe = oe1;
    return empty;
}

}  // namespace compact
}  // namespace movi
