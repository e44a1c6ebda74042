// Kernel 7b: exact k-mer counts on the paired search records.
//
// Replaces movi_tpu/engine/fused_search2.py fused2_kmer_count_scan.
//
// Bound on this card: the rate of random 24 B row gathers from a paired
// table far past the L2 (3.8 GB at five million runs); each k-mer's
// ceil((k-1)/2) dependent pair steps are few against the threads in
// flight.  Design: one thread per k-mer reads its k chars from the
// read-order int8 slots (no [k, nk] window matrix), inits from the last
// char, and takes the k-1 extensions as composed pairs; an odd tail's
// second char is the beyond-read sentinel, which takes the mid-pair
// interval and does not kill the k-mer.  A lane stops at its first empty
// step (its result is fixed then).  A step loads one row where one is
// enough (pair_count_step): once the interval lies in one run, which most
// deep steps do, the down row decides the step or stands in for the up
// row.  A row is read as two loads, its 16 B-aligned half as an int4.

#include <cuda_runtime.h>

#include <cstdint>

#include "search2.cuh"

namespace {

using movi::Interval;
using movi::Rec6;

// A 24 B row at byte 24*row of a table whose base is 8 B aligned: rows of
// one parity start at a 16 B boundary (p0, the base's bit 3, says which),
// so each row is an int4 at its aligned 16 bytes and an int2 at the other
// 8, both issued before either is used.
__device__ __forceinline__ Rec6 load_row(const int* __restrict__ rec_all,
                                         int64_t row, int p0) {
    const int* p = rec_all + row * 6;
    const bool lead8 = (((int)row ^ p0) & 1) != 0;  // int2 first
    const int4 q = *reinterpret_cast<const int4*>(p + (lead8 ? 2 : 0));
    const int2 d = *reinterpret_cast<const int2*>(p + (lead8 ? 0 : 4));
    return lead8 ? Rec6{{d.x, d.y, q.x, q.y, q.z, q.w}}
                 : Rec6{{q.x, q.y, q.z, q.w, d.x, d.y}};
}

// A pair step of kernel 7b for the pair a12 (a1 legal), as bs2_step
// decides it, loading the up row only where the down row cannot stand in
// for it.  Where the directions' first micro-step keeps its run (u1, word
// 0's bit 25, the same bit in both tables: run rs holds a1), both tables
// hold the same words 0 and 3, and where a branch keeps its run (its u2)
// the same words of that branch (engine/fused_search2.py
// _compose_search2_chunk: fields() is a function of the runs alone
// there).  So where rs == re:
//  - u1 = 0: the first micro-step leaves rs's run at both ends, whose
//    offsets it ignores, and the mid interval is crossed (the next a1-run
//    below re maps before the next one above rs, and the sentinels,
//    SENT_HI on the start side and (0, 0) on the end side, cross too):
//    e1, from the down row alone;
//  - u1 = 1 and the end's branch (ff1 = B1 + oe >= C1) keeps its run: the
//    end decodes from the down row;
//  - otherwise the up row is loaded once the down row has landed.
// Where rs != re both rows are in flight together: the up row's loads sit
// in a short branch that waits on nothing before them.
__device__ __forceinline__ void pair_count_step(
    const int* __restrict__ rec_all, int r, int S2, int p0,
    const Interval& cur, int a12, bool l2, Interval& mid, Interval& fin,
    bool& e1, bool& e2) {
    const int a = movi::clampi(a12, 0, S2 - 1);
    const int64_t up = ((int64_t)r + movi::clampi(cur.re, 0, r - 1)) * S2 + a;
    const bool one = cur.rs == cur.re;
    const Rec6 rd =
        load_row(rec_all, (int64_t)movi::clampi(cur.rs, 0, r - 1) * S2 + a,
                 p0);
    Rec6 ru{{0, 0, 0, 0, 0, 0}};
    if (!one) ru = load_row(rec_all, up, p0);
    const int w0 = rd.w[0], w3 = rd.w[3];
    const bool u1 = ((w0 >> 25) & 1) != 0;
    const bool hi = (w3 & movi::S2_GUARD) + cur.oe >=
                    ((w3 >> 12) & movi::S2_GUARD);
    const bool u2 = ((w0 >> (hi ? 27 : 26)) & 1) != 0;
    if (one && u1 && !u2) ru = load_row(rec_all, up, p0);
    movi::bs2_decode(movi::PairRows{rd, one && u2 ? rd : ru}, cur, true, l2,
                     mid, fin, e1, e2);
    e1 = e1 || (one && !u1);
}

__global__ void fused2_kmer_count_kernel(
    const int* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
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
    const int S2 = sigma * sigma;
    const int p0 = (int)((reinterpret_cast<uintptr_t>(rec_all) >> 3) & 1);
    const int8_t* w = slots + (int64_t)lane_of[i] * W + start_of[i];
    bool dead = false;
    for (int j = 0; j < k; ++j) dead |= w[j] < 0;
    Interval iv = movi::init_interval(init_rec, w[k - 1]);
    // the extensions kmer[k-2] ... kmer[0], two per step
    for (int e = 0; e < k - 1 && !dead; e += 2) {
        const int a1 = w[k - 2 - e];
        const int a2 = e + 1 < k - 1 ? w[k - 3 - e] : -2;
        const bool l2 = a2 >= 0;
        Interval mid, fin;
        bool e1, e2;
        pair_count_step(rec_all, r, S2, p0, iv,
                        a1 * sigma + (a2 > 0 ? a2 : 0), l2, mid, fin, e1,
                        e2);
        if (e1) {
            dead = true;
        } else if (e2) {
            iv = mid;
            dead = l2;
        } else {
            iv = fin;
        }
    }
    found_out[i] = dead ? 0 : 1;
    cnt_out[i] = movi::interval_count(all_p, r, iv, dead ? 0 : 1);
}

}  // namespace

// slots int8 [lanes, W]; the k-mer i starts at (lane_of[i], start_of[i])
// with start_of[i] <= W - k.
extern "C" int movi_fused2_kmer_count_scan(
    const void* rec_all, const void* init_rec, const void* all_p,
    const void* slots, int W, const void* lane_of, const void* start_of,
    int nk, int r, int sigma, int k, void* found, void* cnt, void* stream) {
    const int block = 256;
    const int grid = (nk + block - 1) / block;
    if (grid > 0) {
        fused2_kmer_count_kernel<<<grid, block,
                                   (size_t)(sigma + 1) * sizeof(int4),
                                   (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int4*)init_rec, (const int*)all_p,
            (const int8_t*)slots, W, (const int*)lane_of,
            (const int*)start_of, nk, r, sigma, k, (uint8_t*)found,
            (int*)cnt);
    }
    return (int)cudaGetLastError();
}
