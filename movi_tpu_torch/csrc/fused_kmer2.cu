// Kernels 11a and 11b: exact k-mer counts on the bidirectional k/2 cache.
//
// 11a replaces movi_tpu/engine/fused_kmer2.py _kmer2_right_scan, 11b
// replaces _kmer2_left_flat together with the host compaction around it
// (FusedKmer2CountEngine.query_batch: the alive flags brought back and
// np.nonzero).
//
// Bound on this card: 11a the latency of the dependent steps, k-1 per
// group chain (two 32 B MEM v2 rows each), from a table far past the 50 MB
// L2; tens of thousands of chains in flight hide part of it, so it runs as
// a gather stream.  11b the rate of random sectors past the L2 (about
// 1.0 TB/s on the H100, where its 3.35 TB/s count of bytes understates a
// gather about 3x): per live depth-d partial two pos2rba rows, then up to
// ceil(d/2) pair steps; the bound counts the rows the inputs need, one
// 24 B paired search row a step where the down row decides the step or
// stands in for the up row (engine/fused_kmer2.py kmer2_left_rows_plain),
// else two.
// Design:
//  - 11a: one thread per group of p window ends reads its k chars from
//    the read-order int8 slots by (lane, anchor) (the TPU shipped an int32
//    [k, G] char matrix for its relay link), inits from the anchor char
//    and its complement, and takes k-1 extend_right steps on the rc side
//    with a = comp(c), carrying the fw interval in absolute coordinates
//    (the skip and abs come in the rows).  A dead chain loads nothing
//    more.  It writes alive and the fw abs interval per step, [k-1, G],
//    which stay on the card.
//  - 11b: one thread per (group, depth d < p), t = g*p + d: a group's
//    depths are neighbours, so a warp's partials after the same steps
//    often read the same rows (timed 2.2x faster than t = d*G + g, whose
//    warps share a depth and so a count of steps; the outputs stay
//    [p, G]).  A thread whose partial is dead after step k-2-d, or whose
//    d is past the group's windows, writes (0, 0) and returns at once:
//    this replaces the alive flags' trip to the host and the compaction.
//    A live thread issues its two pos2rba rows together, with the first
//    pair's chars, then takes up to ceil(d/2) paired left extensions with
//    bs2_step, both rows of a step in flight together.  Under this layout
//    two rows a step beat kernel 7b's one-row step (a dependent second
//    load where the down row cannot stand in) by 5-6% on two trial runs,
//    so 11b loads both.  Each pair's chars are loaded a step ahead, from
//    clamped addresses.  The JAX sentinels: a first char -2 is a pad
//    no-op, and -1 in either char (an illegal read char) kills the window
//    before any row loads.

#include <cuda_runtime.h>

#include <cstdint>

#include "mem2.cuh"
#include "search2.cuh"

namespace {

using movi::Interval;
using movi::Iv6;
using movi::Step2;

__global__ void kmer2_right_kernel(
    const int* __restrict__ rec_all, const int* __restrict__ init6_g,
    const int8_t* __restrict__ slots, int W, const int* __restrict__ own,
    const int* __restrict__ anchor, int G, int r, int sigma, int k,
    uint8_t* __restrict__ alive_out, int* __restrict__ fs_out,
    int* __restrict__ fe_out) {
    extern __shared__ int init6[];  // (sigma + 1) rows of six words
    for (int i = threadIdx.x; i < (sigma + 1) * 6; i += blockDim.x)
        init6[i] = init6_g[i];
    __syncthreads();
    const int g = blockIdx.x * blockDim.x + threadIdx.x;
    if (g >= G) return;
    const int8_t* w = slots + (int64_t)own[g] * W + anchor[g];
    const int a0 = w[0];
    const Iv6 i_f = movi::init6(init6, a0);
    const Iv6 i_r = movi::init6(init6, a0 >= 0 ? sigma - 1 - a0 : -1);
    int rrs = i_r.rs, ros = i_r.os, rre = i_r.re, roe = i_r.oe;
    int fas = i_f.as, fae = i_f.ae;
    bool alive = a0 >= 0;
    for (int j = 1; j < k; ++j) {
        const int c = w[j];
        const int a = c >= 0 ? sigma - 1 - c : -1;
        bool ok = false;
        if (alive && a >= 0) {
            const Step2 s = movi::mem2_step(rec_all, r, sigma, a, rrs, ros,
                                            rre, roe);
            ok = !s.empty;
            if (ok) {
                fas += s.skip;
                fae = fas + (s.nxt.ae - s.nxt.as);
                rrs = s.nxt.rs; ros = s.nxt.os; rre = s.nxt.re;
                roe = s.nxt.oe;
            }
        }
        alive = ok;
        const int64_t o = (int64_t)(j - 1) * G + g;
        alive_out[o] = ok ? 1 : 0;
        fs_out[o] = fas;
        fe_out[o] = fae;
    }
}

// The chars of a depth-d partial in left order, j = 0..d-1 at anchor-1-j
// (all inside the read: d <= anchor); -2, the pad, from j = d on.  The
// address is clamped, so the load waits on nothing.
__device__ __forceinline__ int left_char(const int8_t* __restrict__ w,
                                         int anc, int d, int j) {
    const int c = w[anc - 1 - j >= 0 ? anc - 1 - j : 0];
    return j < d ? c : -2;
}

__global__ void kmer2_left_kernel(
    const int* __restrict__ m2_rec, int r, int sigma, int n,
    const int* __restrict__ s2_rec, const int* __restrict__ s2_all_p,
    const int8_t* __restrict__ slots, int W, const int* __restrict__ own,
    const int* __restrict__ anchor, int G, int k, int p,
    const uint8_t* __restrict__ alive, const int* __restrict__ fs,
    const int* __restrict__ fe, uint8_t* __restrict__ found_out,
    int* __restrict__ cnt_out) {
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= (int64_t)p * G) return;
    const int g = (int)(t / p);
    const int d = (int)(t - (int64_t)g * p);
    const int64_t o = (int64_t)d * G + g;  // the outputs are [p, G]
    const int anc = anchor[g];
    const int64_t row = (k - 2 - d) * (int64_t)G + g;
    // d < p_eff = min(p, anchor + 1): the group's windows
    if (d > anc || !alive[row]) {
        found_out[o] = 0;
        cnt_out[o] = 0;
        return;
    }
    const int8_t* w = slots + (int64_t)own[g] * W;
    int c1 = left_char(w, anc, d, 0), c2 = left_char(w, anc, d, 1);
    const int64_t p2r = 2 * (int64_t)sigma * r;
    Interval cur;
    movi::mem2_resolve(m2_rec, p2r, n, fs[row], cur.rs, cur.os);
    movi::mem2_resolve(m2_rec, p2r, n, fe[row], cur.re, cur.oe);
    const int S2 = sigma * sigma;
    bool dead = false;
    for (int j = 0; j < d; j += 2) {
        const int a1 = c1, a2 = c2;
        c1 = left_char(w, anc, d, j + 2);
        c2 = left_char(w, anc, d, j + 3);
        if (a1 == -2) continue;         // pad: a no-op
        if (a1 < 0 || a2 == -1) {       // illegal: kills the window
            dead = true;
            break;
        }
        const bool l2 = a2 >= 0;
        Interval mid, fin;
        bool e1, e2;
        movi::bs2_step(s2_rec, r, S2, cur, a1 * sigma + (l2 ? a2 : 0), true,
                       l2, mid, fin, e1, e2);
        if (e1 || (l2 && e2)) {
            dead = true;
            break;
        }
        cur = l2 ? fin : mid;
    }
    found_out[o] = dead ? 0 : 1;
    cnt_out[o] = movi::interval_count(s2_all_p, r, cur, dead ? 0 : 1);
}

}  // namespace

// Kernel 11a.  slots int8 [lanes, W]; group g's chain reads slots[own[g],
// anchor[g] .. anchor[g]+k-1].  alive (uint8), fs and fe (int32) are
// [k-1, G].
extern "C" int movi_kmer2_right_scan(const void* rec_all, const void* init6,
                                     const void* slots, int W,
                                     const void* own, const void* anchor,
                                     int G, int r, int sigma, int k,
                                     void* alive, void* fs, void* fe,
                                     void* stream) {
    const int block = 128;
    const int grid = (G + block - 1) / block;
    if (grid > 0) {
        kmer2_right_kernel<<<grid, block,
                             (size_t)(sigma + 1) * 6 * sizeof(int),
                             (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int*)init6, (const int8_t*)slots, W,
            (const int*)own, (const int*)anchor, G, r, sigma, k,
            (uint8_t*)alive, (int*)fs, (int*)fe);
    }
    return (int)cudaGetLastError();
}

// Kernel 11b.  alive, fs, fe from kernel 11a; found (uint8) and count
// (int32) are [p, G].
extern "C" int movi_kmer2_left_scan(
    const void* m2_rec, int r, int sigma, int n, const void* s2_rec,
    const void* s2_all_p, const void* slots, int W, const void* own,
    const void* anchor, int G, int k, int p, const void* alive,
    const void* fs, const void* fe, void* found, void* cnt, void* stream) {
    const int block = 128;
    const long long grid = ((long long)p * G + block - 1) / block;
    if (grid > 0) {
        kmer2_left_kernel<<<(unsigned)grid, block, 0,
                            (cudaStream_t)stream>>>(
            (const int*)m2_rec, r, sigma, n, (const int*)s2_rec,
            (const int*)s2_all_p, (const int8_t*)slots, W, (const int*)own,
            (const int*)anchor, G, k, p, (const uint8_t*)alive,
            (const int*)fs, (const int*)fe, (uint8_t*)found, (int*)cnt);
    }
    return (int)cudaGetLastError();
}
