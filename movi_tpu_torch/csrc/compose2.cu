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
// needs its run's one-step record for a1 and two one-step rows for a2
// gathered from the lo and hi step-1 destinations.  Design: a block
// composes a tile of consecutive runs (tile_runs), one thread a run at
// one a1, a1-major, so that a warp takes 32 consecutive runs at one a1.
// The tile's one-step rows come into shared memory with coalesced loads; a
// thread decodes its run's record for its a1 and issues all the loads of
// both destination rows before it uses any.  At one a1 the
// destinations of consecutive runs are non-decreasing (LF keeps the BWT
// order within a character, and the nearest run with that character moves
// monotonically), so a warp's gathers fall into one narrow window of the
// table and neighbouring lanes share rows.  Each record is composed in
// registers into a shared-memory tile at its run-major row, and the tile,
// contiguous in the table, goes out with coalesced 16 B stores: no
// chunking and no intermediates, so peak memory is the paired table plus
// the one-step table (what the JAX version chunks to approach).  The color
// form gathers the color ids of the candidate destinations (int32 cids,
// clamped like the run ids) once its rows have landed, and its 32 B rows
// fill the tile as two int4.  The B-field range check reduces min and max
// within each warp, then across the block's warps in shared memory, and
// issues one atomicMin and one atomicMax a block on a 2-int scratch; the
// order of those atomics does not change the result.  Row offsets are
// 64-bit: at r near 2^25 the word offset passes 2^31.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "records.cuh"

namespace {

struct Desc {
    int A, B, C, kind, flags;
    int ca, cb;  // color form: the runs of the step-2 destinations' ids
};

__device__ __forceinline__ uint32_t cid_of(const int* __restrict__ cids,
                                           int run, int r) {
    return (uint32_t)cids[movi::clampi(run, 0, r - 1)];
}

__device__ __forceinline__ uint32_t pair16(uint32_t lo, uint32_t hi) {
    return lo | (hi << 16);
}

// One branch's step-2 descriptor (fused2.py descriptor()) from the
// one-step row g of its destination for a2: slope-1 branches (step 1 was
// LF-like) carry a composed LF2/MIS2 descriptor; constant branches (step 1
// repositioned) resolve step 2 here.  Also the runs whose color ids the
// query selects between: (A, A+1) by ff for LF2, (up, down) by down for
// MIS2, the one destination in both halves for CONST.
__device__ __forceinline__ Desc descriptor(const movi::Step1& g, int r,
                                           int pd_run, int pd_off,
                                           bool slope, int c_b, int y_b) {
    Desc d;
    const bool lf2 = slope && g.use_lf;
    const bool mis2 = slope && !g.use_lf;
    if (lf2) {
        d.A = g.m;
        d.B = c_b + g.fa;
        d.C = g.fb;
        d.kind = movi::KIND_LF2;
        d.flags = g.match;
        d.ca = movi::clampi(g.m, 0, r - 1);
        d.cb = d.ca + 1;
    } else if (mis2) {
        d.A = g.m;
        d.B = movi::clampi(g.fb - c_b, -movi::BIAS, movi::BIAS - 1);
        d.C = g.fa;
        d.kind = movi::KIND_MIS2;
        d.flags = g.bump | (g.d_up << 1) | (g.d_dn << 2);
        d.ca = g.d_up ? pd_run : g.m;
        d.cb = g.d_dn ? pd_run : g.m + g.bump;
    } else {
        int j, off;
        movi::step1(g, y_b, pd_run, pd_off, j, off);
        d.A = j;
        d.B = 0;
        d.C = off;
        d.kind = movi::KIND_CONST;
        d.flags = g.use_lf ? g.match : 0;
        d.ca = j;
        d.cb = j;
    }
    d.A = movi::clampi(d.A, 0, r - 1);
    return d;
}

// The first four words of a paired record (built in uint32: (A_hi >> 16)
// << 23 reaches bit 31).
__device__ __forceinline__ int4 pack4(int T1, int match1, const Desc& lo,
                                      const Desc& hi) {
    const uint32_t w0 = (uint32_t)(T1 + movi::BIAS)
                        | ((uint32_t)match1 << 13)
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
    return make_int4((int)w0, (int)w1, (int)w2, (int)w3);
}

// The a2 whose destination rows are in flight together: the whole row
// for alphabets of up to kAhead - 1 chars.
constexpr int kAhead = 8;
// The runs of a tile (400 B of PML or 800 B of color records a run): 32
// was faster than 16 or 64 in both forms.
constexpr int kTileRuns = 32;
// The dynamic shared memory a block takes at most: under the 48 KB a
// block may take without an opt-in, with room for block_minmax's.
constexpr int kSmemBytes = 44 * 1024;

// bmin and bmax over the block, then one atomic pair; every thread of the
// block calls it.
__device__ __forceinline__ void block_minmax(int bmin, int bmax,
                                             int* __restrict__ bminmax) {
    __shared__ int red[2][32];
    bmin = __reduce_min_sync(0xffffffffu, bmin);
    bmax = __reduce_max_sync(0xffffffffu, bmax);
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
        red[0][warp] = bmin;
        red[1][warp] = bmax;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {
            bmin = min(bmin, red[0][w]);
            bmax = max(bmax, red[1][w]);
        }
        atomicMin(&bminmax[0], bmin);
        atomicMax(&bminmax[1], bmax);
    }
}

// One block composes the tile of `tile` runs from blockIdx.x * tile (the
// last tile may be ragged), thread a1 * tile + j run j at a1; blockDim.x
// is a multiple of 32 and at least tile * slots.  Shared memory: the
// output tile (tile * slots^2 records of NW int4), then the tile's
// one-step rows (tile * slots int2).
template <bool COLOR>
__global__ void compose_paired_kernel(const int2* __restrict__ records1,
                                      const int* __restrict__ cids, int r,
                                      int slots, int pd_run, int pd_off,
                                      int tile, int4* __restrict__ out,
                                      int* __restrict__ bminmax) {
    constexpr int NW = COLOR ? 2 : 1;
    extern __shared__ int4 smem[];
    const int s2 = slots * slots;
    int4* const recs = smem;
    int2* const rows = (int2*)(smem + (size_t)tile * s2 * NW);
    const int64_t run0 = (int64_t)blockIdx.x * tile;
    const int nrun = (int)min((int64_t)tile, (int64_t)r - run0);
    const int2* const src = records1 + run0 * slots;
    for (int i = threadIdx.x; i < nrun * slots; i += blockDim.x)
        rows[i] = src[i];
    __syncthreads();

    // thread (a1, j): run j of the tile at a1, so that a warp takes 32
    // consecutive runs at one a1
    const int a1 = threadIdx.x / tile;
    const int j = threadIdx.x - a1 * tile;
    int bmin = INT_MAX;
    int bmax = INT_MIN;
    if (a1 < slots && j < nrun) {
        const movi::Step1 f = movi::decode1(rows[j * slots + a1]);
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
        const int c_lo = use_lf ? f.fa : 0, y_lo = use_lf ? 0 : y_up;
        const int c_hi = use_lf ? f.fa - f.fb : 0;
        const int y_hi = use_lf ? 0 : y_dn;
        // unreachable branches may carry out-of-range ids: clip to
        // gather
        const int2* const lo_row =
            records1 + (int64_t)movi::clampi(i_lo, 0, r - 1) * slots;
        const int2* const hi_row =
            records1 + (int64_t)movi::clampi(i_hi, 0, r - 1) * slots;
        uint32_t w4 = 0;
        if (COLOR)
            w4 = pair16(cid_of(cids, i_lo, r), cid_of(cids, i_hi, r));
        int4* const dst = recs + (size_t)(j * slots + a1) * slots * NW;
        for (int c0 = 0; c0 < slots; c0 += kAhead) {
            // both destination rows, all in flight before any is used
            int2 glo[kAhead], ghi[kAhead];
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                if (c0 + k < slots) {
                    glo[k] = lo_row[c0 + k];
                    ghi[k] = hi_row[c0 + k];
                }
            }
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                if (c0 + k >= slots) continue;
                const Desc lo = descriptor(movi::decode1(glo[k]), r,
                                           pd_run, pd_off, use_lf, c_lo,
                                           y_lo);
                const Desc hi = descriptor(movi::decode1(ghi[k]), r,
                                           pd_run, pd_off, use_lf, c_hi,
                                           y_hi);
                bmin = min(bmin, min(lo.B, hi.B));
                bmax = max(bmax, max(lo.B, hi.B));
                const int4 v = pack4(T1, f.match, lo, hi);
                if (COLOR) {
                    dst[2 * (c0 + k)] = v;
                    dst[2 * (c0 + k) + 1] = make_int4(
                        (int)w4,
                        (int)pair16(cid_of(cids, lo.ca, r),
                                    cid_of(cids, lo.cb, r)),
                        (int)pair16(cid_of(cids, hi.ca, r),
                                    cid_of(cids, hi.cb, r)),
                        0);
                } else {
                    dst[c0 + k] = v;
                }
            }
        }
    }
    __syncthreads();
    // the tile is contiguous in the table: coalesced 16 B stores
    int4* const to = out + run0 * s2 * NW;
    const int n = nrun * s2 * NW;
    for (int i = threadIdx.x; i < n; i += blockDim.x) to[i] = recs[i];
    block_minmax(bmin, bmax, bminmax);
}

// The runs of a tile: kTileRuns while its records and rows fit kSmemBytes
// and its threads a block, which they do for alphabets of up to five
// chars in the color form (slots <= 6; DNA has five slots) and of up to
// eight in the PML form; for larger ones the largest power of two that
// fits.
template <bool COLOR>
int tile_runs(int slots) {
    const size_t per_run =
        (size_t)slots * slots * 16 * (COLOR ? 2 : 1) + (size_t)slots * 8;
    int t = kTileRuns;
    while (t > 1 && ((size_t)t * per_run > kSmemBytes || t * slots > 1024))
        t >>= 1;
    return t;
}

template <bool COLOR>
int launch(const void* records1, const void* cids, int r, int slots,
           int pd_run, int pd_off, void* out, void* bminmax,
           cudaStream_t stream) {
    if (r <= 0 || slots <= 0) return (int)cudaGetLastError();
    const int tile = tile_runs<COLOR>(slots);
    const int block = (tile * slots + 31) / 32 * 32;
    const int64_t grid = ((int64_t)r + tile - 1) / tile;
    const size_t smem = (size_t)tile * slots * slots * 16 * (COLOR ? 2 : 1)
                        + (size_t)tile * slots * 8;
    if (smem > kSmemBytes || block > 1024) return (int)cudaErrorInvalidValue;
    compose_paired_kernel<COLOR><<<(unsigned)grid, block, smem, stream>>>(
        (const int2*)records1, (const int*)cids, r, slots, pd_run, pd_off,
        tile, (int4*)out, (int*)bminmax);
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
