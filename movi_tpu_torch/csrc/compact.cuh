// LF with the unbounded fast-forward and the backward-search interval
// update on the compact run tables (movi_tpu_torch/engine/device_index.py),
// shared by the compact PML, count and ZML scans (csrc/compact_pml.cu,
// csrc/compact_search.cu), and the run search through the row -> run
// directory that every LF of those scans and the MEM v1 machines'
// repositions (csrc/fused_mem.cu) go through.
//
// Tables: n, lf_abs, c_search int32 [r]; all_p int32 [r+1] (all_p[r] = n,
// the text length); ch_up_s/ch_down_s int32 [sigma, r] (r: none); the
// directory dir int32 [K+1] (kernel 13d, csrc/fused_mem.cu).
#pragma once

#include <cstdint>

namespace movi {
namespace compact {

// The row -> run directory (csrc/fused_mem.cu, kernel 13d): dir[k] =
// find_run(k << b) for k < K = ((n-1) >> b) + 1, and dir[K] = r, where
// find_run(x), the run holding absolute row x, is the last i in [0, r]
// with all_p[i] <= x (searchsorted(all_p, x, side="right") - 1 for 0 <=
// x), and 0 for x < 0.  The run holding row x lies in [dir[k], dir[k+1]]
// for k = x >> b (clamped to [0, K-1]), and the runs starting in a bucket
// of 2^b rows number at most 2^b, so a branch-free search of that span
// takes ceil(log2(dir[k+1] - dir[k] + 1)) <= b + 1 halvings: the same for
// every row of the bucket.  On the all_p of non-empty runs (all_p[0] = 0,
// strictly increasing, as every move index has) the result is find_run's
// for every int32 x: run 0 for x < 0 and run r for x >= n.
struct RunDir {
    const int* __restrict__ dir;  // [K+1]
    int K, b;
};

__device__ __forceinline__ int dir_bucket(const RunDir& d, int x) {
    const int k = x >> d.b;
    return k < 0 ? 0 : (k > d.K - 1 ? d.K - 1 : k);
}

// find_run of row x through the directory: run = find_run(x), start =
// all_p[run].  One dependent load of the bucket's directory pair, then
// all_p[dir[k]] issued with the first halving and carried through the
// search (a halving that moves takes the row it compared), so no load
// follows the last halving.  h counts the halvings.
__device__ __forceinline__ void find_run_dir(const int* __restrict__ all_p,
                                             const RunDir& d, int x,
                                             int& run, int& start, int& h) {
    const int k = dir_bucket(d, x);
    run = __ldg(d.dir + k);
    int len = __ldg(d.dir + k + 1) - run + 1;
    start = __ldg(all_p + run);
    while (len > 1) {
        const int half = len >> 1;
        const int v = __ldg(all_p + run + half);
        h += 1;
        if (v <= x) {
            run += half;
            start = v;
        }
        len -= half;
    }
}

// find_run_dir of two rows xs and xe, the two searches interleaved so that
// their loads issue together: bs = find_run(xs), ps = all_p[bs] (be, pe
// for xe); a search that is done loads nothing more.  h counts the
// halvings of both.
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

// LF_move + fast_forward for one (run, offset) whose lf_abs row la =
// lf_abs[idx] the caller has loaded: the absolute destination la + off,
// mapped back to (run, offset) through the directory.
__device__ __forceinline__ void lf_dir(const int* __restrict__ all_p,
                                       const RunDir& d, int la, int& idx,
                                       int& off, int& h) {
    const int x = la + off;
    int start;
    find_run_dir(all_p, d, x, idx, start, h);
    off = x - start;
}

// LF on both ends of an interval (find_run_dir2), from their lf_abs rows
// las and lae.
__device__ __forceinline__ void lf2_dir(const int* __restrict__ all_p,
                                        const RunDir& d, int las, int lae,
                                        int& rs, int& os, int& re, int& oe,
                                        int& h) {
    const int xs = las + os;
    const int xe = lae + oe;
    int ps, pe;
    find_run_dir2(all_p, d, xs, xe, rs, ps, re, pe, h);
    os = xs - ps;
    oe = xe - pe;
}

struct Tables {
    const int* __restrict__ n;
    const int* __restrict__ lf_abs;
    const int* __restrict__ all_p;
    const int* __restrict__ c_search;
    const int* __restrict__ ch_up_s;
    const int* __restrict__ ch_down_s;
    RunDir dir;
    int r, sigma;
};

__device__ __forceinline__ int mini(int a, int b) { return a < b ? a : b; }

// backward_search_step (movi_tpu/engine/search.py _bs_step over
// _interval_update), clamped where the JAX engine clamps: the interval
// (rs, os, re, oe) moves to the next one for char a, and the result says
// whether it is empty (an illegal char is empty; its interval is then
// unspecified but deterministic).  Each end's lf_abs row issues with its
// char; an end that moves to a nearest run loads its new run's row with
// the run's length (the early row then goes unused).  h counts the
// halvings of the two LF searches.
__device__ __forceinline__ bool bs_step(const Tables& T, int a, int& rs,
                                        int& os, int& re, int& oe, int& h) {
    const int r = T.r;
    const int64_t last = (int64_t)T.sigma * r - 1;
    const int64_t a_flat = (int64_t)(a > 0 ? a : 0) * r;
    const int a_s = a > 0 ? a : 0;
    const int re_safe = mini(re, r - 1);
    // the two ends' chars and lf_abs rows are independent loads
    const int cs = __ldg(T.c_search + rs);
    const int ce = __ldg(T.c_search + re_safe);
    int las = __ldg(T.lf_abs + rs);
    int lae = __ldg(T.lf_abs + re_safe);
    int rs1 = rs, os1 = os;
    if (cs != a_s) {
        const int64_t at = a_flat + rs;
        rs1 = __ldg(T.ch_down_s + (at < last ? at : last));
        os1 = 0;
        las = __ldg(T.lf_abs + mini(rs1, r - 1));
    }
    int re1 = re_safe, oe1 = oe;
    if (ce != a_s) {
        const int64_t at = a_flat + re_safe;
        re1 = mini(__ldg(T.ch_up_s + (at < last ? at : last)), r - 1);
        oe1 = __ldg(T.n + re1) - 1;
        lae = __ldg(T.lf_abs + re1);
    }
    const bool empty = a < 0 || rs1 >= r || rs1 > re;
    rs1 = mini(rs1, r - 1);
    lf2_dir(T.all_p, T.dir, las, lae, rs1, os1, re1, oe1, h);
    rs = rs1;
    os = os1;
    re = re1;
    oe = oe1;
    return empty;
}

}  // namespace compact
}  // namespace movi
