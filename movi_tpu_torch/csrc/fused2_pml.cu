// Kernel 3: the paired PML scan (two bases per record).
//
// Replaces movi_tpu/engine/fused2.py fused2_step + _fused2_decode under
// _fused2_scan_carry.
//
// Bound on this card: the latency of one dependent random 16 B load per
// two bases per lane (the paired table of a real index is gigabytes, far
// past the L2).  Halving the dependent loads per base against kernel 1 is
// the point of the layout.  Design: as kernel 1, one thread per read lane
// with the state in registers and the loop over the W2 pair steps inside
// the kernel; one int4 load per step, the decode in registers
// (records.cuh decode_pair), and two coalesced int32 stores (rows 2t and
// 2t+1 of ml).  Only the record load waits on the chain: a lane's pair
// codes do not depend on its state, so each is loaded two steps before
// the step whose record it addresses, from a clamped address (in the
// last two steps this step's own code, never used), and a step's record
// is issued as soon as the decode before has given its run id; both ml
// stores follow that issue.  After a lane's last step it issues its own
// record again, never used.  A batch with no more lanes
// than the card has SMs runs one lane a warp (spread.cuh).  Words are
// decoded from uint32 because the A_hi field reaches bit 31; record rows
// are indexed as int4 with 64-bit arithmetic (the word offset passes 2^31
// at r near 2^25).  State comes in and goes out, so a scan split into
// pieces equals one pass over the width.

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"
#include "spread.cuh"

namespace {

template <typename PairT>
__global__ void fused2_pml_scan_kernel(
    const int4* __restrict__ records, const PairT* __restrict__ a12,
    int W2, int lanes, int slots, int pd_run, int pd_off,
    const int* __restrict__ idx_in, const int* __restrict__ off_in,
    const int* __restrict__ ml_in, int* __restrict__ idx_out,
    int* __restrict__ off_out, int* __restrict__ ml_state_out,
    int* __restrict__ ml, int lpw) {
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    const int64_t s2 = (int64_t)slots * slots;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    if (W2 > 0) {
        // the first step's record, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        int64_t row = (int64_t)idx * s2 + (int)a12[lane];
        int4 rec = records[row];
        int a_next = (int)a12[W2 > 1 ? lanes_s + lane : (size_t)lane];
        // one step an iteration: unrolled twice by the compiler, the
        // uint8 form once ran slower on the smoke's 10 kb batch
        // (tools/pair_scan_trials.py, "unroll default")
#pragma unroll 1
        for (int t = 0; t < W2; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's record is in flight: the code two steps on
            // (in the last two steps this step's own code, never used:
            // selecting 0 there instead would wait on the load here)
            const int a_after =
                (int)a12[t + 2 < W2 ? at + 2 * lanes_s : at];
            const movi::PairStep d =
                movi::decode_pair(rec, off, pd_run, pd_off);
            const int ml1 = d.match1 ? m + 1 : 0;
            const int ml2 = d.match2 ? ml1 + 1 : 0;
            idx = d.nidx;
            off = d.noff;
            m = ml2;
            // the next step's record: the chain's only load (after the
            // last step this step's record again, never used: behind a
            // branch the load can sink below the stores, and a state may
            // come in that leaves the table, as chip_smoke.py's decode of
            // 25-bit run ids does)
            row = t + 1 < W2 ? (int64_t)idx * s2 + a_next : row;
            rec = records[row];
            const size_t out = 2 * (size_t)t * lanes_s + lane;
            ml[out] = ml1;
            ml[out + lanes_s] = ml2;
            a_next = a_after;
        }
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

template <typename PairT>
void launch(const movi::Spread& s, const void* records, const void* a12,
            int W2, int lanes, int slots, int pd_run, int pd_off,
            const void* idx_in, const void* off_in, const void* ml_in,
            void* idx_out, void* off_out, void* ml_state_out, void* ml,
            cudaStream_t stream) {
    fused2_pml_scan_kernel<PairT><<<s.grid, s.block, 0, stream>>>(
        (const int4*)records, (const PairT*)a12, W2, lanes, slots, pd_run,
        pd_off, (const int*)idx_in, (const int*)off_in, (const int*)ml_in,
        (int*)idx_out, (int*)off_out, (int*)ml_state_out, (int*)ml, s.lpw);
}

}  // namespace

// pair_bytes: 1 when the pair codes are uint8, 4 when int32.
extern "C" int movi_fused2_pml_scan(
    const void* records, const void* a12, int pair_bytes, int W2,
    int lanes, int slots, int pd_run, int pd_off, const void* idx_in,
    const void* off_in, const void* ml_in, void* idx_out, void* off_out,
    void* ml_state_out, void* ml, void* stream) {
    if (pair_bytes != 1 && pair_bytes != 4)
        return (int)cudaErrorInvalidValue;
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        auto go = pair_bytes == 1 ? &launch<uint8_t> : &launch<int32_t>;
        go(s, records, a12, W2, lanes, slots, pd_run, pd_off, idx_in,
           off_in, ml_in, idx_out, off_out, ml_state_out, ml,
           (cudaStream_t)stream);
    }
    return (int)cudaGetLastError();
}
