// Kernel C: the paired Movi Color scan (two bases and their color ids per
// record).
//
// Replaces movi_tpu/engine/fused2.py fused2_color_step (with
// _fused2_decode) under _fused2_color_scan_carry and, with early stop,
// _fused2_color_scan_carry_es.
//
// Bound on this card: the latency of one dependent random 32 B load per
// two bases per lane (the paired color table of a real pangenome index is
// gigabytes, far past the L2); against kernel 3 the row doubles from 16 B
// to 32 B, one sector instead of half of one.  Design: as kernel 3, one
// thread per read lane with the state in registers and the loop over the
// W2 pair steps inside the kernel.  A row is two int4 loads (rows are
// 32 B aligned), the decode is records.cuh decode_pair, then the color
// selectors: word 4's half by the branch bit; word 5 (lo branch) or 6 (hi
// branch), then its half by ff (LF2), by down (MIS2), or the low half
// (CONST).  Only the row loads wait on the chain: a lane's pair codes do
// not depend on its state, so each is loaded two steps before the step
// whose row it addresses, from a clamped address (in the last two steps
// this step's own code, never used); a step takes both color ids out of
// its row's color words, then issues the next row as soon as the decode
// has given its run id, then makes its four coalesced int32 stores (ml
// and cid, rows 2t and 2t+1).  After a lane's last step the row issued
// lies inside the table (every state a step of the table leaves is one
// of its runs) and is never used.  Each row's word 7 carries no field but
// is read (into `sink`), so that no register of an in-flight row is
// reused.  The loop is unrolled twice, which tools/pair_scan_trials.py
// found faster with early stop.  A batch with no more lanes than the card
// has SMs runs one lane a warp (spread.cuh).  Early stop: two checks per
// pair step, at t1 and t1+1; a lane that retires (stop = t1+2, the rows
// it scanned) or passes its read's end leaves its loop, and the wrapper
// zero-fills the outputs.  State, the early-stop state and the global
// step t0 of row 0 (even) come in and go out, so a scan split into
// pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"
#include "records.cuh"
#include "spread.cuh"

namespace {

template <typename PairT, bool ES>
__global__ void fused2_color_scan_kernel(
    const int4* __restrict__ records, const PairT* __restrict__ a12,
    int W2, int lanes, int slots, int pd_run, int pd_off,
    const int* __restrict__ lens, int t0, const int* __restrict__ idx_in,
    const int* __restrict__ off_in, const int* __restrict__ ml_in,
    const long long* __restrict__ csum_in, const int* __restrict__ stop_in,
    int* __restrict__ idx_out, int* __restrict__ off_out,
    int* __restrict__ ml_state_out, long long* __restrict__ csum_out,
    int* __restrict__ stop_out, int* __restrict__ ml,
    int* __restrict__ cid, int lpw) {
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    const int64_t s2 = (int64_t)slots * slots;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    long long csum = 0;
    int stop = 0;
    int L = 0;
    int steps = W2;
    if (ES) {
        csum = csum_in[lane];
        stop = stop_in[lane];
        L = lens[lane];
        // pair steps whose first base lies in the read
        steps = stop ? 0 : max(0, min(W2, (L - t0 + 1) / 2));
    }
    // 0 (W2 >= 0), but not to the compiler: `sink` collects each row's
    // word 7 (a write to a register of an in-flight 128-bit load waits on
    // the whole load), and after the loop the last row and code issued,
    // so that they are live on the early stop's break path too and cannot
    // sink below the stores and the stop test into the path that goes on;
    // it is and-ed with keep.
    const int keep = W2 >> 31;
    int sink = 0;
    if (steps > 0) {
        // the first step's row, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        int64_t row = (int64_t)idx * s2 + (int)a12[lane];
        int4 q0 = records[2 * row];
        int4 q1 = records[2 * row + 1];
        int a_next = (int)a12[steps > 1 ? lanes_s + lane : (size_t)lane];
#pragma unroll 2
        for (int t = 0; t < steps; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's row is in flight: the code two steps on
            // (in the last two steps this step's own code, never used:
            // selecting 0 there instead would wait on the load here)
            const int a_after =
                (int)a12[t + 2 < steps ? at + 2 * lanes_s : at];
            const movi::PairStep d =
                movi::decode_pair(q0, off, pd_run, pd_off);
            // this row's color ids, before the next row's words take the
            // registers of this row's
            const uint32_t w4 = (uint32_t)q1.x;
            const uint32_t wc2 = (uint32_t)(d.hi ? q1.z : q1.y);
            sink |= q1.w;
            const bool sel2 = d.kind == movi::KIND_LF2    ? d.ff
                              : d.kind == movi::KIND_MIS2 ? d.down
                                                          : false;
            const int cid1 = (int)(d.hi ? w4 >> 16 : w4 & 0xFFFFu);
            const int cid2 = (int)(sel2 ? wc2 >> 16 : wc2 & 0xFFFFu);
            const int ml1 = d.match1 ? m + 1 : 0;
            const int ml2 = d.match2 ? ml1 + 1 : 0;
            idx = d.nidx;
            off = d.noff;
            m = ml2;
            // the next step's row: the chain's only loads (after the last
            // step a row inside the table that is never used: behind a
            // branch, or behind a select of this step's row, the loads
            // sink below the stores)
            row = (int64_t)idx * s2 + a_next;
            q0 = records[2 * row];
            q1 = records[2 * row + 1];
            const size_t out = 2 * (size_t)t * lanes_s + lane;
            ml[out] = ml1;
            ml[out + lanes_s] = ml2;
            cid[out] = cid1;
            cid[out + lanes_s] = cid2;
            a_next = a_after;
            if constexpr (ES) {
                const int t1 = t0 + 2 * t;
                csum += ml1;
                const bool hit1 = movi::es_hit(csum, t1, L);
                csum += ml2;
                const bool hit2 = movi::es_hit(csum, t1 + 1, L);
                if (hit1 || hit2) {
                    stop = t1 + 2;
                    break;
                }
            }
        }
        sink |= q0.x | q0.y | q0.z | q0.w | q1.x | q1.y | q1.z | q1.w
                | a_next;
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m + (sink & keep);
    if (ES) {
        csum_out[lane] = csum;
        stop_out[lane] = stop;
    }
}

template <typename PairT>
int launch(const void* records, const void* a12, int W2, int lanes,
           int slots, int pd_run, int pd_off, const void* lens, int t0,
           const void* idx_in, const void* off_in, const void* ml_in,
           const void* csum_in, const void* stop_in, void* idx_out,
           void* off_out, void* ml_state_out, void* csum_out, void* stop_out,
           void* ml, void* cid, cudaStream_t stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes <= 0) return (int)cudaGetLastError();
    auto kern = lens ? &fused2_color_scan_kernel<PairT, true>
                     : &fused2_color_scan_kernel<PairT, false>;
    kern<<<s.grid, s.block, 0, stream>>>(
        (const int4*)records, (const PairT*)a12, W2, lanes, slots, pd_run,
        pd_off, (const int*)lens, t0, (const int*)idx_in,
        (const int*)off_in, (const int*)ml_in, (const long long*)csum_in,
        (const int*)stop_in, (int*)idx_out, (int*)off_out,
        (int*)ml_state_out, (long long*)csum_out, (int*)stop_out, (int*)ml,
        (int*)cid, s.lpw);
    return (int)cudaGetLastError();
}

}  // namespace

// pair_bytes: 1 when the pair codes are uint8, 4 when int32.  lens NULL
// runs without early stop (csum/stop unused).
extern "C" int movi_fused2_color_scan(
    const void* records, int pair_bytes, const void* a12, int W2, int lanes,
    int slots, int pd_run, int pd_off, const void* lens, int t0,
    const void* idx_in, const void* off_in, const void* ml_in,
    const void* csum_in, const void* stop_in, void* idx_out, void* off_out,
    void* ml_state_out, void* csum_out, void* stop_out, void* ml, void* cid,
    void* stream) {
    if (pair_bytes == 1)
        return launch<uint8_t>(records, a12, W2, lanes, slots, pd_run,
                               pd_off, lens, t0, idx_in, off_in, ml_in,
                               csum_in, stop_in, idx_out, off_out,
                               ml_state_out, csum_out, stop_out, ml, cid,
                               (cudaStream_t)stream);
    if (pair_bytes == 4)
        return launch<int32_t>(records, a12, W2, lanes, slots, pd_run,
                               pd_off, lens, t0, idx_in, off_in, ml_in,
                               csum_in, stop_in, idx_out, off_out,
                               ml_state_out, csum_out, stop_out, ml, cid,
                               (cudaStream_t)stream);
    return (int)cudaErrorInvalidValue;
}
