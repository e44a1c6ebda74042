// Kernel 7's compose: the paired backward-search records.
//
// Replaces movi_tpu/engine/fused_search2.py _compose_search2_chunk
// (jitted with donation and driven chunk by chunk by compose_search2).
//
// Bound on this card: device-memory traffic.  Each 24 B output record needs
// step 1's fields at its own run (shared by the sigma records of that (run,
// a1)) and step 2's fields at the step-1 destination A1 and A1+1, which land
// anywhere in the run arrays: a few 4 B gathers per record in chains of three
// (next-run row -> id/offset/n -> n at the id), plus the 768 B/run table write
// (3.8 GB at five million runs for DNA).  Design: a block composes a tile of
// kTileRuns (32) consecutive runs in one direction (one launch covers both
// slabs, down then up), thread a1 * kTileRuns + j run j of the tile at a1, so
// that a warp takes 32 consecutive runs at one a1.  At one a1 the step-1 destinations of
// consecutive runs are non-decreasing (LF order), so a warp's step-2 gathers
// fall into one narrow window of the tables and neighbouring lanes share rows.
// A thread evaluates step 1 once for its (run, a1), then, for kAhead chars a2
// at a time (one), issues each level of both branches' loads before it uses
// any; the first group's destinations go out before step 1's last load (n at
// its id, which only C1 needs) is waited on, each later group's at the end of
// the group before.  Each record is composed in registers into a shared-memory
// tile at its run-major row ((run * sigma + a1) * sigma + a2); the tile is
// contiguous in the table and goes out with coalesced 16 B stores.  A tile's
// first word may sit 8 B past a 16 B boundary (the up slab starts at r *
// sigma^2 rows of 24 B) and its last 8 B short of one: the shared tile is laid
// out with the same offset from a 16 B boundary as the table, and a partial
// first or last 16 B piece goes out as one 8 B store (rows are 8 B aligned).
// The shared tile's 16 B pieces are swizzled within each group of eight (piece
// g at g ^ ((g >> 3) & 7)), so that the 32 runs of a warp, 96 words apart for
// DNA, do not write one bank.  The paired search holds sigma <= 6 chars (its
// pair codes), which bounds a block to 192 threads and its tile to 27 KB, under
// the 48 KB a block may take without an opt-in.  No chunks and no
// intermediates, so peak memory is the table plus its inputs.  Sentinels as in
// the JAX compose: a start-side step with no matching run gets A = SENT_HI, an
// end-side one A = 0, both with B = 0 and C = GUARD; C is GUARD too when the
// destination is the last run.  Words are built in 32-bit unsigned arithmetic
// (the highest field bit is u2_hi at 27); row indices are 64-bit.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "records.cuh"

namespace {

constexpr int GUARD = 0xFFF;
constexpr int SENT_HI = 0x1FFFFFF;
// The chars a2 whose step-2 loads are in flight together: one, so that
// a thread holds few registers (32) and an SM many blocks; all four of
// DNA at once took 80 registers and ran 33% slower
// (tools/dense_compose_trials.py, "7 kAhead 4").
constexpr int kAhead = 1;
// The runs of a tile (384 B of records a run for DNA).
constexpr int kTileRuns = 32;
// The chars a pair code holds (the wrapper's bound too).
constexpr int kMaxSigma = 6;
// The dynamic shared memory a block may take without an opt-in.
constexpr int kSmemBytes = 48 * 1024;

struct Fields {
    int A, B, C, u;
};

// One micro-step's (A, B, C, u) at run `cur` from what its loads gave:
// the destination d of the char's next-run row at cur, the run arrays at
// d (id, off, n) and n at that id (nid) (fields() of the JAX compose).
__device__ __forceinline__ Fields fields_of(bool up, int cur, int d, int id,
                                            int off, int n, int nid, int r) {
    const bool ex = d < r && cur < r;
    const bool keep = d == cur;
    Fields f;
    f.A = ex ? id : (up ? 0 : SENT_HI);
    f.B = ex ? off + (keep || !up ? 0 : n - 1) : 0;
    f.C = ex && id < r - 1 ? nid : GUARD;
    f.u = ex && keep ? 1 : 0;
    return f;
}

// Step 2's first level of loads: the destinations d of the next-run
// rows of chars c0 .. c0 + kAhead - 1 (those below sigma) at the
// branches' clamped runs cc.
__device__ __forceinline__ void destinations(const int* __restrict__ tab,
                                             int r, int sigma, int c0,
                                             const int (&cc)[2],
                                             int (&d)[2][kAhead]) {
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
        if (c0 + k < sigma) {
            const int* const t2 = tab + (int64_t)(c0 + k) * r;
            d[0][k] = t2[cc[0]];
            d[1][k] = t2[cc[1]];
        }
    }
}

// The shared tile's 16 B piece that holds the table's piece g of the tile.
__device__ __forceinline__ int swizzle(int g) { return g ^ ((g >> 3) & 7); }

// Words a and a+1 (a even, counted from the 16 B boundary at or before
// the tile's first word) into the shared tile.
__device__ __forceinline__ void put2(int4* __restrict__ tile, int a, int x,
                                     int y) {
    reinterpret_cast<int2*>(tile + swizzle(a >> 2))[(a & 3) >> 1] =
        make_int2(x, y);
}

// The shared tile of `tile` runs: their records' words and the offset
// of up to 2 words, in whole groups of eight 16 B pieces (the swizzle's).
constexpr int64_t stage_bytes(int tile, int64_t s2) {
    return ((2 + 6 * tile * s2 + 3) / 4 + 7) / 8 * 8 * 16;
}
static_assert(stage_bytes(kTileRuns, kMaxSigma * kMaxSigma) <= kSmemBytes,
              "a tile of kMaxSigma chars must fit the shared memory");

// Block b composes the runs [run0, run0 + kTileRuns) of the down slab for
// b < the tiles of a slab, else of the up slab (the last tile may be
// ragged); thread a1 * kTileRuns + j run j at a1.
__global__ void compose_search2_kernel(const int* __restrict__ id_a,
                                       const int* __restrict__ off_a,
                                       const int* __restrict__ n_a,
                                       const int* __restrict__ nu,
                                       const int* __restrict__ nd, int r,
                                       int sigma, int* __restrict__ out) {
    extern __shared__ int4 smem[];
    const int64_t tiles = ((int64_t)r + kTileRuns - 1) / kTileRuns;
    const bool up = blockIdx.x >= tiles;
    const int64_t run0 =
        ((int64_t)blockIdx.x - (up ? tiles : 0)) * kTileRuns;
    const int nrun = (int)min((int64_t)kTileRuns, (int64_t)r - run0);
    const int64_t s2 = (int64_t)sigma * sigma;
    // the tile's first row, and its first word's offset in words from the
    // 16 B boundary at or before it (0 or 2: rows are 8 B aligned)
    const int64_t row0 = (up ? (int64_t)r * s2 : 0) + run0 * s2;
    int* const dst = out + row0 * 6;
    const int shift = (int)(((uintptr_t)dst >> 2) & 3);
    const int* const tab = up ? nu : nd;

    const int j = threadIdx.x % kTileRuns;
    const int a1 = threadIdx.x / kTileRuns;
    const int run = (int)run0 + j;
    if (j < nrun) {
        // step 1, once for the (run, a1)
        const int d1 = tab[(int64_t)a1 * r + run];
        const int d1c = movi::clampi(d1, 0, r - 1);
        const int id1 = id_a[d1c];
        const int off1 = off_a[d1c];
        const int n1 = n_a[d1c];
        const int nid1 = n_a[movi::clampi(id1, 0, r - 1)];
        const Fields s1 = fields_of(up, run, d1, id1, off1, n1, nid1, r);
        // step 2 from the branches' runs A1 (lo) and A1 + 1 (hi)
        const int cur[2] = {s1.A, s1.A + 1};
        const int cc[2] = {movi::clampi(cur[0], 0, r - 1),
                           movi::clampi(cur[1], 0, r - 1)};
        // the first chars' destinations, in flight while step 1's last
        // load (n at its id, for C1) lands
        int d[2][kAhead];
        destinations(tab, r, sigma, 0, cc, d);
        const uint32_t w0_1 = (uint32_t)s1.A | ((uint32_t)s1.u << 25);
        const uint32_t w3 = (uint32_t)s1.B | ((uint32_t)s1.C << 12);
        for (int c0 = 0; c0 < sigma; c0 += kAhead) {
            // each further level of both branches' loads, all in flight
            // before any is used
            int id[2][kAhead], off[2][kAhead], n[2][kAhead], nid[2][kAhead];
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (c0 + k < sigma) {
                        const int dc = movi::clampi(d[b][k], 0, r - 1);
                        id[b][k] = id_a[dc];
                        off[b][k] = off_a[dc];
                        n[b][k] = n_a[dc];
                    }
                }
            }
            // step 2's last level (n at each id, for C2)
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
#pragma unroll
                for (int b = 0; b < 2; ++b) {
                    if (c0 + k < sigma)
                        nid[b][k] = n_a[movi::clampi(id[b][k], 0, r - 1)];
                }
            }
#pragma unroll
            for (int k = 0; k < kAhead; ++k) {
                const int a2 = c0 + k;
                if (a2 >= sigma) continue;
                const Fields lo = fields_of(up, cur[0], d[0][k], id[0][k],
                                            off[0][k], n[0][k], nid[0][k], r);
                const Fields hi = fields_of(up, cur[1], d[1][k], id[1][k],
                                            off[1][k], n[1][k], nid[1][k], r);
                const uint32_t w0 = w0_1 | ((uint32_t)lo.u << 26)
                                    | ((uint32_t)hi.u << 27);
                const uint32_t w4 = (uint32_t)lo.B | ((uint32_t)lo.C << 12);
                const uint32_t w5 = (uint32_t)hi.B | ((uint32_t)hi.C << 12);
                const int64_t rec = ((int64_t)j * sigma + a1) * sigma + a2;
                const int a = shift + 6 * (int)rec;
                put2(smem, a, (int)w0, lo.A);
                put2(smem, a + 2, hi.A, (int)w3);
                put2(smem, a + 4, (int)w4, (int)w5);
            }
            // the next chars' destinations
            destinations(tab, r, sigma, c0 + kAhead, cc, d);
        }
    }
    __syncthreads();
    // the tile is contiguous in the table: coalesced 16 B stores, and an
    // 8 B store for a first or last piece the tile fills only half of
    const int words = nrun * (int)s2 * 6;
    const int pieces = (shift + words + 3) >> 2;
    int4* const to = reinterpret_cast<int4*>(dst - shift);
    for (int g = threadIdx.x; g < pieces; g += blockDim.x) {
        const int4 v = smem[swizzle(g)];
        const bool lo_half = g > 0 || shift == 0;
        const bool hi_half = g < pieces - 1 || ((shift + words) & 3) == 0;
        if (lo_half && hi_half) {
            to[g] = v;
        } else {
            int2* const half = reinterpret_cast<int2*>(to + g);
            if (lo_half) half[0] = make_int2(v.x, v.y);
            if (hi_half) half[1] = make_int2(v.z, v.w);
        }
    }
}

}  // namespace

// id/offset/n: int32 [r]; nu/nd: int32 [sigma, r] (r = no matching run);
// out: int32 [2*r*sigma^2, 6], down slab then up slab, 8 B aligned.
extern "C" int movi_compose_search2_records(const void* id_a,
                                            const void* off_a,
                                            const void* n_a, const void* nu,
                                            const void* nd, int r, int sigma,
                                            void* out, void* stream) {
    if (r <= 0 || sigma <= 0) return (int)cudaGetLastError();
    if (sigma > kMaxSigma) return (int)cudaErrorInvalidValue;
    const int64_t s2 = (int64_t)sigma * sigma;
    const int64_t grid = 2 * (((int64_t)r + kTileRuns - 1) / kTileRuns);
    if (grid > INT_MAX) return (int)cudaErrorInvalidValue;
    compose_search2_kernel<<<(unsigned)grid, kTileRuns * sigma,
                             (size_t)stage_bytes(kTileRuns, s2),
                             (cudaStream_t)stream>>>(
        (const int*)id_a, (const int*)off_a, (const int*)n_a,
        (const int*)nu, (const int*)nd, r, sigma, (int*)out);
    return (int)cudaGetLastError();
}
