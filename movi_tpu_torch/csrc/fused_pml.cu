// Kernel 1: the one-step PML scan.
//
// Replaces movi_tpu/engine/fused.py fused_pml_step + fused_step_math under
// _fused_pml_scan and _fused_pml_scan_carry (one lax.scan per batch).
//
// Bound on this card: the latency of one dependent random 8 B load per
// base per lane.  Each step's record address depends on the previous
// step's run id, and the one-step table of a real index (about 200 MB at
// five million runs) is past the 50 MB L2, so every step waits on device
// memory.  Design: one thread per read lane with (idx, off, ml) held in
// registers and the loop over the W bases inside the kernel, so a batch is
// one launch.  Only the record load waits on the chain: a lane's codes do
// not depend on its state, so each is loaded two steps before the step
// whose record it addresses, and a step's record is issued as soon as the
// step before has given its run id; ml is stored after that issue.  A
// batch with no more lanes than the card has SMs runs one lane a warp, so
// that no lane waits on the slowest row of 31 others (spread.cuh).  The
// code loads (uint8) and ml stores (int32) are coalesced across the lanes
// of a warp.  State comes in and goes out, so a scan split into pieces
// equals one pass over the width.

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"
#include "spread.cuh"

namespace {

__global__ void fused_pml_scan_kernel(
    const int2* __restrict__ records, const uint8_t* __restrict__ alphas,
    int W, int lanes, int slots, int pd_run, int pd_off,
    const int* __restrict__ idx_in, const int* __restrict__ off_in,
    const int* __restrict__ ml_in, int* __restrict__ idx_out,
    int* __restrict__ off_out, int* __restrict__ ml_state_out,
    int* __restrict__ ml, int lpw) {
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    if (W > 0) {
        // the first step's record, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        int2 rec = records[(int64_t)idx * slots + alphas[lane]];
        int a_next = W > 1 ? alphas[lanes_s + lane] : 0;
        for (int t = 0; t < W; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's record is in flight: the code two steps on
            const int a_after = t + 2 < W ? alphas[at + 2 * lanes_s] : 0;
            const movi::Step1 f = movi::decode1(rec);
            movi::step1(f, off, pd_run, pd_off, idx, off);
            m = f.match ? m + 1 : 0;
            // the next step's record: the chain's only load
            if (t + 1 < W) rec = records[(int64_t)idx * slots + a_next];
            ml[at] = m;
            a_next = a_after;
        }
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

}  // namespace

extern "C" int movi_fused_pml_scan(
    const void* records, const void* alphas, int W, int lanes, int slots,
    int pd_run, int pd_off, const void* idx_in, const void* off_in,
    const void* ml_in, void* idx_out, void* off_out, void* ml_state_out,
    void* ml, void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        fused_pml_scan_kernel<<<s.grid, s.block, 0, (cudaStream_t)stream>>>(
            (const int2*)records, (const uint8_t*)alphas, W, lanes, slots,
            pd_run, pd_off, (const int*)idx_in, (const int*)off_in,
            (const int*)ml_in, (int*)idx_out, (int*)off_out,
            (int*)ml_state_out, (int*)ml, s.lpw);
    }
    return (int)cudaGetLastError();
}
