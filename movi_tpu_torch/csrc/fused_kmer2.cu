// Kernels 11a and 11b: exact k-mer counts on the bidirectional k/2 cache.
//
// 11a replaces movi_tpu/engine/fused_kmer2.py _kmer2_right_scan, 11b
// replaces _kmer2_left_flat together with the host compaction around it
// (FusedKmer2CountEngine.query_batch: the alive flags brought back and
// np.nonzero).
//
// Bound on this card: the latency of the dependent steps, k-1 per group
// chain (two 32 B MEM v2 rows each) and 1 + ceil(d/2) per depth-d partial
// (two pos2rba rows, then two 24 B paired search rows per step), from
// tables far past the 50 MB L2.  Tens of thousands of chains in flight
// hide part of the latency, so the kernels run as gather streams.
// Design:
//  - 11a: one thread per group of p window ends reads its k chars from
//    the read-order int8 slots by (lane, anchor) (the TPU shipped an int32
//    [k, G] char matrix for its relay link), inits from the anchor char
//    and its complement, and takes k-1 extend_right steps on the rc side
//    with a = comp(c), carrying the fw interval in absolute coordinates
//    (the skip and abs come in the rows).  A dead chain loads nothing
//    more.  It writes alive and the fw abs interval per step, [k-1, G],
//    which stay on the card.
//  - 11b: one thread per (depth d < p, group).  A thread whose partial is
//    dead after step k-2-d, or whose d is past the group's windows,
//    writes (0, 0) and returns at once: this replaces the alive flags'
//    trip to the host and the compaction.  A live thread resolves its two
//    abs ends through the pos2rba rows, then takes ceil(d/2) paired left
//    extensions with bs2_step (the JAX sentinels: -2 is a pad no-op, -1 an
//    illegal char that kills the window) and writes (found, count).

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
    const int d = (int)(t / G);
    const int g = (int)(t - (int64_t)d * G);
    const int anc = anchor[g];
    const int64_t row = (int64_t)(k - 2 - d) * G + g;
    // d < p_eff = min(p, anchor + 1): the group's windows
    if (d > anc || !alive[row]) {
        found_out[t] = 0;
        cnt_out[t] = 0;
        return;
    }
    const int64_t p2r = 2 * (int64_t)sigma * r;
    Interval cur;
    movi::mem2_resolve(m2_rec, p2r, n, fs[row], cur.rs, cur.os);
    movi::mem2_resolve(m2_rec, p2r, n, fe[row], cur.re, cur.oe);
    const int8_t* w = slots + (int64_t)own[g] * W;
    const int S2 = sigma * sigma;
    bool dead = false;
    // chars j = 0..d-1 at anchor-1-j (all inside the read: d <= anchor),
    // two per paired step; a second char past the depth is the pad
    for (int j = 0; j < d; j += 2) {
        const int a1 = w[anc - 1 - j];
        const int a2 = j + 1 < d ? w[anc - 2 - j] : -2;
        if (a1 == -2) continue;  // pad: a no-op
        if (a1 < 0) {            // illegal: kills the window
            dead = true;
            break;
        }
        Interval mid, fin;
        bool e1, e2;
        movi::bs2_step(s2_rec, r, S2, cur, a1 * sigma + (a2 > 0 ? a2 : 0),
                       true, a2 >= 0, mid, fin, e1, e2);
        if (e1 || a2 == -1 || (a2 >= 0 && e2)) {
            dead = true;
            break;
        }
        cur = a2 >= 0 ? fin : mid;
    }
    found_out[t] = dead ? 0 : 1;
    cnt_out[t] = movi::interval_count(s2_all_p, r, cur, dead ? 0 : 1);
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
