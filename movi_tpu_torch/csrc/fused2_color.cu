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
// (CONST).  Four coalesced int32 stores per step (ml and cid, rows 2t and
// 2t+1).  Early stop: two checks per pair step, at t1 and t1+1; a lane
// that retires (stop = t1+2, the rows it scanned) or passes its read's
// end leaves its loop, and the wrapper zero-fills the outputs.  State,
// the early-stop state and the global step t0 of row 0 (even) come in
// and go out, so a scan split into pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"
#include "records.cuh"

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
    int* __restrict__ cid) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int s2 = slots * slots;
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
    for (int t = 0; t < steps; ++t) {
        const int a = (int)a12[(size_t)t * lanes + lane];
        const int64_t row = (int64_t)idx * s2 + a;
        const int4 q0 = records[2 * row];
        const int4 q1 = records[2 * row + 1];
        const movi::PairStep d = movi::decode_pair(q0, off, pd_run, pd_off);
        const uint32_t w4 = (uint32_t)q1.x;
        const uint32_t wc2 = (uint32_t)(d.hi ? q1.z : q1.y);
        const bool sel2 = d.kind == movi::KIND_LF2    ? d.ff
                          : d.kind == movi::KIND_MIS2 ? d.down
                                                      : false;
        const int cid1 = (int)(d.hi ? w4 >> 16 : w4 & 0xFFFFu);
        const int cid2 = (int)(sel2 ? wc2 >> 16 : wc2 & 0xFFFFu);
        const int ml1 = d.match1 ? m + 1 : 0;
        const int ml2 = d.match2 ? ml1 + 1 : 0;
        const size_t at = (size_t)(2 * t) * lanes + lane;
        ml[at] = ml1;
        ml[at + lanes] = ml2;
        cid[at] = cid1;
        cid[at + lanes] = cid2;
        idx = d.nidx;
        off = d.noff;
        m = ml2;
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
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
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
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid == 0) return (int)cudaGetLastError();
    auto kern = lens ? &fused2_color_scan_kernel<PairT, true>
                     : &fused2_color_scan_kernel<PairT, false>;
    kern<<<grid, block, 0, stream>>>(
        (const int4*)records, (const PairT*)a12, W2, lanes, slots, pd_run,
        pd_off, (const int*)lens, t0, (const int*)idx_in,
        (const int*)off_in, (const int*)ml_in, (const long long*)csum_in,
        (const int*)stop_in, (int*)idx_out, (int*)off_out,
        (int*)ml_state_out, (long long*)csum_out, (int*)stop_out, (int*)ml,
        (int*)cid);
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
