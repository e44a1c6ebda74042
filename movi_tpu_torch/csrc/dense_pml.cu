// Kernel 14: the dense-automaton PML scan.
//
// Replaces movi_tpu/engine/dense.py _dense_pml_scan (one lax.scan per
// batch over the transition table dense[p * (sigma+1) + a] = next_p |
// (is_match << 31)).
//
// Bound on this card: the latency of one dependent random 4 B load per
// base per lane.  Each step's address depends on the previous step's
// position, and the table of a real index ((sigma+1) * 4 B per BWT row,
// 120 MB at six million rows) is past the 50 MB L2.  Design: one thread
// per read lane with (p, ml) in registers and the loop over the W bases
// inside the kernel, so a batch is one launch.  Only the table load waits
// on the chain: a lane's codes do not depend on its state, so each is
// loaded two steps before the step whose row it addresses, from a clamped
// address (in the last two steps this step's own code, never used), and a
// step's row is issued as soon as the step before has given its position;
// ml is stored after that issue.  After a lane's last step it issues its
// own row again, never used: behind a branch the load can sink below the
// store.  A batch with no more lanes than the card has SMs runs one lane a
// warp, so that no lane waits on the slowest row of 31 others
// (spread.cuh).  The code loads (uint8) and ml stores are coalesced across
// the lanes of a warp.  The table index is 64-bit: at n * (sigma+1) >=
// 2^31 entries (n >= ~4.3e8 rows for DNA) the JAX package's int32 index
// wraps, and the 80 GB card holds such a table.  State comes in and goes
// out, so a scan split into pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "spread.cuh"

namespace {

__global__ void dense_pml_scan_kernel(
    const int* __restrict__ table, const uint8_t* __restrict__ codes, int W,
    int lanes, int slots, const int* __restrict__ p_in,
    const int* __restrict__ ml_in, int* __restrict__ p_out,
    int* __restrict__ ml_state_out, int* __restrict__ ml, int lpw) {
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    int p = p_in[lane];
    int m = ml_in[lane];
    if (W > 0) {
        // the first step's row, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        int64_t row = (int64_t)p * slots + codes[lane];
        int w = table[row];
        int a_next = codes[W > 1 ? lanes_s + lane : (size_t)lane];
        for (int t = 0; t < W; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's row is in flight: the code two steps on
            // (in the last two steps this step's own code, never used)
            const int a_after = codes[t + 2 < W ? at + 2 * lanes_s : at];
            m = w < 0 ? m + 1 : 0;
            p = w & 0x7FFFFFFF;
            // the next step's row: the chain's only load (after the last
            // step this step's row again, never used)
            row = t + 1 < W ? (int64_t)p * slots + a_next : row;
            w = table[row];
            ml[at] = m;
            a_next = a_after;
        }
    }
    p_out[lane] = p;
    ml_state_out[lane] = m;
}

}  // namespace

extern "C" int movi_dense_pml_scan(const void* table, const void* codes,
                                   int W, int lanes, int slots,
                                   const void* p_in, const void* ml_in,
                                   void* p_out, void* ml_state_out, void* ml,
                                   void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        dense_pml_scan_kernel<<<s.grid, s.block, 0, (cudaStream_t)stream>>>(
            (const int*)table, (const uint8_t*)codes, W, lanes, slots,
            (const int*)p_in, (const int*)ml_in, (int*)p_out,
            (int*)ml_state_out, (int*)ml, s.lpw);
    }
    return (int)cudaGetLastError();
}
