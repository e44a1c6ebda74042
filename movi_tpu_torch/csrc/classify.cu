// Kernel 16a: binary classification from the matching lengths.
//
// Replaces movi_tpu/parallel/mesh.py _classify_from_ml (after the PML
// scans of _pml_classify_scan and _pml_classify_scan_paired): the maxima
// of bins of bin_width processing-order lengths, with the last short
// region merged into the previous bin (classifier.cpp:99-143), and the
// vote of the bins at or above max_value_thr.
//
// Bound on this card: bytes, one read of ml [W, lanes] inside the reads
// (the lengths past each read are never loaded), the lengths in, three
// results out.  ml sits in the 50 MB L2 straight after the PML scan that
// wrote it (4.9 MB an 8,192 x 150 batch), so a time under the HBM bound
// means that the L2 served it.
//
// Design: the work spreads along the read as well as across the lanes, so
// that every batch shape fills the SMs (one thread a lane walking its
// column put a 64-lane 10 kb batch on one SM).
//  - A block is a tile of 32 lanes and a slice of consecutive naive bins
//    (ceil(W / bin_width), positions past a read -1, the last bin padded
//    with -1 as the JAX version pads it).  A warp reads 32 consecutive
//    lanes of one row (128 B); the block's warps split the slice's rows,
//    each thread with UNROLL loads in flight (predicated on t < L, from
//    rows clamped to its piece, no branch in front of a load).
//  - The warps' maxima of a (bin, lane) meet in shared memory
//    (atomicMax), CHUNK_BINS bins at a time.  Per lane, B = max(L /
//    bin_width, 1): the bins before B-1 vote one each, and bins B-1 to the
//    end fold into one tail maximum (never empty: nb >= B).
//  - A tile of one slice writes found = 2 * above > B, above and below at
//    once.  The slices of a tile meet in the call's own scratch, zeroed
//    by the caller: votes by atomicAdd, the tail by atomicMax on an
//    order-keeping unsigned form.  Integer atomics give the same answer
//    in any order.  The last block of the tile to finish (a ticket)
//    writes the results.  Launches on several streams at once each have
//    their own scratch.
// A lane of length 0 gives (false, 0, 1), as the JAX version does.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#include "spread.cuh"

namespace {

constexpr int TILE = 32;         // lanes a block: one warp's row, 128 B
constexpr int WARPS = 8;         // warps a block, splitting its rows
constexpr int UNROLL = 8;        // loads in flight a thread
constexpr int CHUNK_BINS = 64;   // bins a block holds in shared memory
constexpr int BLOCKS_PER_SM = 2048 / (TILE * WARPS);

// int order kept in unsigned order, INT_MIN at 0
__device__ __forceinline__ unsigned order_key(int v) {
    return (unsigned)v ^ 0x80000000u;
}

__device__ __forceinline__ void finish(int lane, int B, int thr, int votes,
                                       int tail, uint8_t* __restrict__ found,
                                       int* __restrict__ above_out,
                                       int* __restrict__ below_out) {
    // the JAX version's tail maximum counts -1 for each bin before B-1
    if (B > 1 && tail < -1) tail = -1;
    const int above = votes + (tail >= thr ? 1 : 0);
    found[lane] = 2 * above > B ? 1 : 0;
    above_out[lane] = above;
    below_out[lane] = B - above;
}

__global__ void __launch_bounds__(TILE * WARPS) classify_from_ml_kernel(
    const int* __restrict__ ml, const int* __restrict__ lengths, int W,
    int lanes, int bin_width, int thr, int nb, int slice_bins, int tiles,
    int slices, uint8_t* __restrict__ found, int* __restrict__ above_out,
    int* __restrict__ below_out, int* __restrict__ votes_s,
    unsigned* __restrict__ tail_s, unsigned* __restrict__ ticket) {
    __shared__ int bmax[CHUNK_BINS][TILE];
    __shared__ bool last;
    const int tile = blockIdx.x % tiles;
    const int slice = blockIdx.x / tiles;
    const int x = threadIdx.x, y = threadIdx.y;
    const int lane = tile * TILE + x;
    const bool in = lane < lanes;
    const int L = in ? lengths[lane] : 0;
    const int q = L / bin_width;
    const int B = q > 1 ? q : 1;
    const int* __restrict__ col = ml + (in ? lane : 0);
    const bool padded = (int64_t)nb * bin_width > W;
    const int b_hi = min(slice * slice_bins + slice_bins, nb);
    int votes = 0, tail = INT_MIN;  // warp 0's, for its lane
    for (int c0 = slice * slice_bins; c0 < b_hi; c0 += CHUNK_BINS) {
        const int c1 = min(c0 + CHUNK_BINS, b_hi);
        for (int i = y * TILE + x; i < (c1 - c0) * TILE; i += TILE * WARPS)
            bmax[i / TILE][i % TILE] = INT_MIN;
        __syncthreads();
        // the chunk's rows [r0, r1) in WARPS pieces, warp y's [t0, t1)
        const int r0 = c0 * bin_width;
        const int r1 = (int)min((int64_t)c1 * bin_width, (int64_t)W);
        const int per = (r1 - r0 + WARPS - 1) / WARPS;
        const int t0 = r0 + y * per;
        const int t1 = min(t0 + per, r1);
        const int lim = min(t1, L);  // rows past the read: -1, not loaded
        int b = t0 / bin_width;      // the open bin and where it ends
        int next = (b + 1) * bin_width;
        int m = INT_MIN;
        for (int t = t0; t < t1; t += UNROLL) {
            int v[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int tc = t + u < t1 ? t + u : t1 - 1;
                v[u] = t + u < lim ? col[(int64_t)tc * lanes] : -1;
            }
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                if (t + u < t1) {
                    if (t + u == next) {
                        atomicMax(&bmax[b - c0][x], m);
                        ++b;
                        next += bin_width;
                        m = INT_MIN;
                    }
                    m = max(m, v[u]);
                }
            }
        }
        if (t0 < t1) atomicMax(&bmax[b - c0][x], m);
        __syncthreads();
        if (y == 0) {
            for (int bb = c0; bb < c1; ++bb) {
                int v = bmax[bb - c0][x];
                if (bb == nb - 1 && padded) v = max(v, -1);
                if (bb < B - 1)
                    votes += v >= thr ? 1 : 0;
                else
                    tail = max(tail, v);
            }
        }
        __syncthreads();  // bmax is filled again by the next chunk
    }
    if (slices == 1) {
        if (y == 0 && in)
            finish(lane, B, thr, votes, tail, found, above_out, below_out);
        return;
    }
    if (y == 0 && in) {
        if (votes) atomicAdd(&votes_s[lane], votes);
        if (tail != INT_MIN) atomicMax(&tail_s[lane], order_key(tail));
    }
    __threadfence();
    __syncthreads();
    if (x == 0 && y == 0)
        last = atomicAdd(&ticket[tile], 1u) == (unsigned)slices - 1;
    __syncthreads();
    if (!last || y != 0 || !in) return;
    // the other slices' atomics, read past the L1
    const int v = __ldcg(&votes_s[lane]);
    const int tl = (int)(__ldcg(&tail_s[lane]) ^ 0x80000000u);
    finish(lane, B, thr, v, tl, found, above_out, below_out);
}

}  // namespace

// scratch: int32 [(2 * 32 + 1) * ceil(lanes / 32)], zeroed: the votes
// and the tails of the lanes, then a ticket a tile of 32 lanes.
extern "C" int movi_classify_from_ml(const void* ml, const void* lengths,
                                     int W, int lanes, int bin_width,
                                     int thr, void* found, void* above,
                                     void* below, void* scratch,
                                     void* stream) {
    if (lanes <= 0 || W <= 0) return (int)cudaGetLastError();
    int sms = 0;
    const cudaError_t e = movi::sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    const int nb = (int)(((int64_t)W + bin_width - 1) / bin_width);
    const int tiles = (lanes + TILE - 1) / TILE;
    // bins a block: enough blocks to fill the SMs
    const int64_t target = (int64_t)sms * BLOCKS_PER_SM;
    int64_t slice_bins = ((int64_t)tiles * nb + target - 1) / target;
    if (slice_bins > nb) slice_bins = nb;
    const int slices = (int)((nb + slice_bins - 1) / slice_bins);
    classify_from_ml_kernel<<<(unsigned)((int64_t)tiles * slices),
                              dim3(TILE, WARPS), 0, (cudaStream_t)stream>>>(
        (const int*)ml, (const int*)lengths, W, lanes, bin_width, thr, nb,
        (int)slice_bins, tiles, slices, (uint8_t*)found, (int*)above,
        (int*)below, (int*)scratch,
        (unsigned*)scratch + (int64_t)tiles * TILE,
        (unsigned*)scratch + (int64_t)tiles * 2 * TILE);
    return (int)cudaGetLastError();
}
