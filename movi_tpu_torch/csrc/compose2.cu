// Kernel 2: compose the paired (two-step) PML records; kernel B: the same
// compose in its 8-word Movi Color form.
//
// Replaces movi_tpu/engine/fused2.py _compose_chunk (jitted with donation
// and driven chunk by chunk by compose_records), in its 4-word PML form
// and in its 8-word `cids` form (words 4-6 hold the 16-bit color-id pairs
// of step 1's two branches and of each branch's two step-2 destinations,
// word 7 pads the row to 32 B).
//
// Bound on this card: device-memory traffic.  Each output record (16 B)
// needs its run's one-step record for a1 (8 B, shared by the slots
// threads of that (run, a1)) and two one-step rows for a2 gathered from
// the lo and hi step-1 destinations, which land anywhere in the table.
// Design: one thread per (run, a1, a2), which composes its record in
// registers and writes one int4 straight into the preallocated table: no
// chunking, no intermediates, so peak memory is the paired table plus the
// one-step table (what the JAX version chunks to approach).  The color
// form gathers the color ids of the candidate destinations (int32 cids,
// clamped like the run ids) and writes its 32 B row as two int4 stores
// (rows are 32 B aligned).  The B-field
// range check reduces min and max within each warp and then issues one
// atomicMin and one atomicMax per warp on a 2-int scratch; the order of
// those atomics does not change the result.  Row indices are 64-bit: at
// r near 2^25 the word offset passes 2^31.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "records.cuh"

namespace {

struct Desc {
    int A, B, C, kind, flags;
    uint32_t c2;  // color form: the step-2 destinations' ids, a | b << 16
};

__device__ __forceinline__ uint32_t cid_of(const int* __restrict__ cids,
                                           int run, int r) {
    return (uint32_t)cids[movi::clampi(run, 0, r - 1)];
}

__device__ __forceinline__ uint32_t pair16(uint32_t lo, uint32_t hi) {
    return lo | (hi << 16);
}

// One branch's step-2 descriptor (fused2.py descriptor()): slope-1
// branches (step 1 was LF-like) carry a composed LF2/MIS2 descriptor;
// constant branches (step 1 repositioned) resolve step 2 here.  With
// cids, also the color ids of the step-2 destinations the query selects
// between: (A, A+1) by ff for LF2, (up, down) by down for MIS2, the one
// destination in both halves for CONST.
template <bool COLOR>
__device__ __forceinline__ Desc descriptor(
    const int2* __restrict__ records1, const int* __restrict__ cids, int r,
    int slots, int a2, int pd_run, int pd_off, bool slope, int i_b, int c_b,
    int y_b) {
    // unreachable branches may carry out-of-range ids: clip for the gather
    const int i = movi::clampi(i_b, 0, r - 1);
    const movi::Step1 g = movi::decode1(records1[(int64_t)i * slots + a2]);
    Desc d;
    const bool lf2 = slope && g.use_lf;
    const bool mis2 = slope && !g.use_lf;
    if (lf2) {
        d.A = g.m;
        d.B = c_b + g.fa;
        d.C = g.fb;
        d.kind = movi::KIND_LF2;
        d.flags = g.match;
        if (COLOR)
            d.c2 = pair16(cid_of(cids, movi::clampi(g.m, 0, r - 1), r),
                          cid_of(cids, movi::clampi(g.m, 0, r - 1) + 1, r));
    } else if (mis2) {
        d.A = g.m;
        d.B = movi::clampi(g.fb - c_b, -movi::BIAS, movi::BIAS - 1);
        d.C = g.fa;
        d.kind = movi::KIND_MIS2;
        d.flags = g.bump | (g.d_up << 1) | (g.d_dn << 2);
        if (COLOR)
            d.c2 = pair16(cid_of(cids, g.d_up ? pd_run : g.m, r),
                          cid_of(cids, g.d_dn ? pd_run : g.m + g.bump, r));
    } else {
        int j, off;
        movi::step1(g, y_b, pd_run, pd_off, j, off);
        d.A = j;
        d.B = 0;
        d.C = off;
        d.kind = movi::KIND_CONST;
        d.flags = g.use_lf ? g.match : 0;
        if (COLOR) {
            const uint32_t c = cid_of(cids, j, r);
            d.c2 = pair16(c, c);
        }
    }
    d.A = movi::clampi(d.A, 0, r - 1);
    return d;
}

template <bool COLOR>
__global__ void compose_paired_kernel(const int2* __restrict__ records1,
                                      const int* __restrict__ cids, int r,
                                      int slots, int pd_run, int pd_off,
                                      int4* __restrict__ out,
                                      int* __restrict__ bminmax) {
    const int64_t n = (int64_t)r * slots * slots;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    int bmin = INT_MAX;
    int bmax = INT_MIN;
    if (t < n) {
        const int s2 = slots * slots;
        const int64_t run = t / s2;
        const int rem = (int)(t - run * s2);
        const int a1 = rem / slots;
        const int a2 = rem - a1 * slots;
        const movi::Step1 f = movi::decode1(records1[run * slots + a1]);
        const bool use_lf = f.use_lf;
        const int T1 = movi::clampi(use_lf ? f.fb - f.fa : f.fb,
                                    -movi::BIAS, movi::BIAS - 1);
        // branch states: lo = (x < T1), hi = (x >= T1)
        const int i_up = f.d_up ? pd_run : f.m;
        const int y_up = f.d_up ? pd_off : f.fa;
        const int i_dn = f.d_dn ? pd_run : f.m + f.bump;
        const int y_dn = f.d_dn ? pd_off : (f.bump ? 0 : f.fa + 1);
        const int i_lo = use_lf ? f.m : i_up;
        const int i_hi = use_lf ? f.m + 1 : i_dn;
        const Desc lo = descriptor<COLOR>(records1, cids, r, slots, a2,
                                          pd_run, pd_off, use_lf, i_lo,
                                          use_lf ? f.fa : 0,
                                          use_lf ? 0 : y_up);
        const Desc hi = descriptor<COLOR>(records1, cids, r, slots, a2,
                                          pd_run, pd_off, use_lf, i_hi,
                                          use_lf ? f.fa - f.fb : 0,
                                          use_lf ? 0 : y_dn);
        // built in uint32: (A_hi >> 16) << 23 reaches bit 31
        const uint32_t w0 = (uint32_t)(T1 + movi::BIAS)
                            | ((uint32_t)f.match << 13)
                            | ((uint32_t)(lo.A >> 16) << 14)
                            | ((uint32_t)(hi.A >> 16) << 23);
        const uint32_t w1 = (uint32_t)(lo.B + movi::BIAS)
                            | ((uint32_t)lo.C << 13)
                            | ((uint32_t)lo.kind << 25)
                            | ((uint32_t)lo.flags << 27);
        const uint32_t w2 = (uint32_t)(hi.B + movi::BIAS)
                            | ((uint32_t)hi.C << 13)
                            | ((uint32_t)hi.kind << 25)
                            | ((uint32_t)hi.flags << 27);
        const uint32_t w3 = ((uint32_t)lo.A & 0xFFFFu)
                            | (((uint32_t)hi.A & 0xFFFFu) << 16);
        if (COLOR) {
            const uint32_t w4 = pair16(cid_of(cids, i_lo, r),
                                       cid_of(cids, i_hi, r));
            out[2 * t] = make_int4((int)w0, (int)w1, (int)w2, (int)w3);
            out[2 * t + 1] = make_int4((int)w4, (int)lo.c2, (int)hi.c2, 0);
        } else {
            out[t] = make_int4((int)w0, (int)w1, (int)w2, (int)w3);
        }
        bmin = min(lo.B, hi.B);
        bmax = max(lo.B, hi.B);
    }
    // every lane of the warp reaches here (no early return above)
    bmin = __reduce_min_sync(0xffffffffu, bmin);
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    if ((threadIdx.x & 31) == 0) {
        atomicMin(&bminmax[0], bmin);
        atomicMax(&bminmax[1], bmax);
    }
}

template <bool COLOR>
int launch(const void* records1, const void* cids, int r, int slots,
           int pd_run, int pd_off, void* out, void* bminmax,
           cudaStream_t stream) {
    const int64_t n = (int64_t)r * slots * slots;
    const int block = 256;
    const int64_t grid = (n + block - 1) / block;
    if (grid > 0) {
        compose_paired_kernel<COLOR><<<(unsigned)grid, block, 0, stream>>>(
            (const int2*)records1, (const int*)cids, r, slots, pd_run,
            pd_off, (int4*)out, (int*)bminmax);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The 4-word PML table [r*slots^2, 4].
extern "C" int movi_compose_paired_records(const void* records1, int r,
                                           int slots, int pd_run,
                                           int pd_off, void* out,
                                           void* bminmax, void* stream) {
    return launch<false>(records1, nullptr, r, slots, pd_run, pd_off, out,
                         bminmax, (cudaStream_t)stream);
}

// The 8-word color table [r*slots^2, 8] from the records and cids [r].
extern "C" int movi_compose_paired_color_records(
    const void* records1, const void* cids, int r, int slots, int pd_run,
    int pd_off, void* out, void* bminmax, void* stream) {
    return launch<true>(records1, cids, r, slots, pd_run, pd_off, out,
                        bminmax, (cudaStream_t)stream);
}
