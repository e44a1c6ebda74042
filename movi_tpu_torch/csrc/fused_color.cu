// Kernel A: the one-step Movi Color scan (PML plus each base's color id).
//
// Replaces movi_tpu/engine/fused_color.py fused_color_step (with
// fused_step_math) under _fused_color_scan_carry and, with early stop,
// _fused_color_scan_carry_es and _es_check; and their records3-is-None
// form, the PML step followed by doc_set_inds[new_idx].
//
// Bound on this card: the latency of one dependent random load per base
// per lane, as kernel 1, with a 12 B row instead of 8 B (the color table
// of a real pangenome index is tens of MB and more, past the 50 MB L2).
// Design: one thread per read lane, (idx, off, ml) in registers, the loop
// over the bases inside the kernel, one launch per batch.  3-word rows are
// only 4 B aligned, so a row is three int32 loads from consecutive
// addresses (an int4 or int2 load of a misaligned row would fault).  The
// two-load form reads the 8 B PML row as one int2, then cids[new_idx].
// The color selector uses the offset from before the step.  Only the row
// load waits on the chain: a lane's codes do not depend on its state, so
// each is loaded two steps before the step whose row it addresses, and a
// step's row is issued as soon as the step before has given its run id;
// ml and the color id are stored after that issue.  In the two-load form
// cids[new_idx] is issued beside the next row, and nothing the next row's
// address needs waits on it, so the chain keeps one load a step.  A batch
// with no more lanes than the card has SMs runs one lane a warp
// (spread.cuh).  Early stop: the lane carries (csum int64, stop) and
// leaves its loop when the reference's rule fires (stop = the rows it
// scanned) or at its read's end; the row issued after a lane's last
// step lies inside the table and is never used.  The wrapper zero-fills
// the outputs, so rows past a lane's retirement are zero.  State, the
// early-stop state and the global step t0 of row 0 come in and go out,
// so a scan split into pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"
#include "records.cuh"
#include "spread.cuh"

namespace {

// A step's row: the one-step PML record and, in the three-word form, the
// packed color ids of its two destinations.
struct ColorRow {
    int2 pml;
    int wc;
};

template <bool THREE>
__device__ __forceinline__ ColorRow load_row(const int* __restrict__ records,
                                             int64_t row) {
    ColorRow v;
    if constexpr (THREE) {
        const int* p = records + row * 3;
        v.pml = make_int2(p[0], p[1]);
        v.wc = p[2];
    } else {
        v.pml = reinterpret_cast<const int2*>(records)[row];
        v.wc = 0;
    }
    return v;
}

template <bool THREE, bool ES>
__global__ void fused_color_scan_kernel(
    const int* __restrict__ records, const int* __restrict__ cids,
    const uint8_t* __restrict__ alphas, int W, int lanes, int slots,
    int pd_run, int pd_off, const int* __restrict__ lens, int t0,
    const int* __restrict__ idx_in, const int* __restrict__ off_in,
    const int* __restrict__ ml_in, const long long* __restrict__ csum_in,
    const int* __restrict__ stop_in, int* __restrict__ idx_out,
    int* __restrict__ off_out, int* __restrict__ ml_state_out,
    long long* __restrict__ csum_out, int* __restrict__ stop_out,
    int* __restrict__ ml, int* __restrict__ cid, int lpw) {
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    long long csum = 0;
    int stop = 0;
    int L = 0;
    int steps = W;
    if (ES) {
        csum = csum_in[lane];
        stop = stop_in[lane];
        L = lens[lane];
        steps = stop ? 0 : max(0, min(W, L - t0));
    }
    // 0 (W >= 0), but not to the compiler: with early stop the last row
    // and code issued are and-ed with it into `sink` after the loop, so
    // that they are live on the break's path too and cannot sink below
    // the stores and the stop test into the path that goes on
    const int keep = W >> 31;
    int sink = 0;
    if (steps > 0) {
        // the first step's row, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        ColorRow rec =
            load_row<THREE>(records, (int64_t)idx * slots + alphas[lane]);
        int a_next = steps > 1 ? alphas[lanes_s + lane] : 0;
        for (int t = 0; t < steps; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's row is in flight: the code two steps on
            // (in the last two steps this step's own code, never used:
            // selecting 0 there instead would wait on the load here)
            const int a_after =
                alphas[t + 2 < steps ? at + 2 * lanes_s : at];
            const movi::Step1 f = movi::decode1(rec.pml);
            const bool hi = f.use_lf ? f.fa + off >= f.fb : off >= f.fb;
            // the three-word form's color id, before the next row's words
            // take the registers of this row's
            const uint32_t w = (uint32_t)rec.wc;
            const int c3 = (int)(hi ? w >> 16 : w & 0xFFFFu);
            movi::step1(f, off, pd_run, pd_off, idx, off);
            m = f.match ? m + 1 : 0;
            // the next step's row: the chain's only load (after the last
            // step a row inside the table that is never used: behind a
            // branch the load can sink below the stores)
            rec = load_row<THREE>(records, (int64_t)idx * slots + a_next);
            const int c = THREE ? c3 : cids[idx];
            ml[at] = m;
            cid[at] = c;
            a_next = a_after;
            if constexpr (ES) {
                csum += m;
                if (movi::es_hit(csum, t0 + t, L)) {
                    stop = t0 + t + 1;
                    break;
                }
            }
        }
        if (ES)
            sink = (rec.pml.x | rec.pml.y | rec.wc | a_next) & keep;
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m + sink;
    if (ES) {
        csum_out[lane] = csum;
        stop_out[lane] = stop;
    }
}

}  // namespace

// rec_words: 3 for the color records (cids NULL), 2 for the PML records
// read with cids.  lens NULL runs without early stop (csum/stop unused).
extern "C" int movi_fused_color_scan(
    const void* records, int rec_words, const void* cids, const void* alphas,
    int W, int lanes, int slots, int pd_run, int pd_off, const void* lens,
    int t0, const void* idx_in, const void* off_in, const void* ml_in,
    const void* csum_in, const void* stop_in, void* idx_out, void* off_out,
    void* ml_state_out, void* csum_out, void* stop_out, void* ml, void* cid,
    void* stream) {
    if (rec_words != 2 && rec_words != 3) return (int)cudaErrorInvalidValue;
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes <= 0) return (int)cudaGetLastError();
    auto kern = &fused_color_scan_kernel<true, false>;
    if (rec_words == 3 && lens) kern = &fused_color_scan_kernel<true, true>;
    if (rec_words == 2)
        kern = lens ? &fused_color_scan_kernel<false, true>
                    : &fused_color_scan_kernel<false, false>;
    kern<<<s.grid, s.block, 0, (cudaStream_t)stream>>>(
        (const int*)records, (const int*)cids, (const uint8_t*)alphas, W,
        lanes, slots, pd_run, pd_off, (const int*)lens, t0,
        (const int*)idx_in, (const int*)off_in, (const int*)ml_in,
        (const long long*)csum_in, (const int*)stop_in, (int*)idx_out,
        (int*)off_out, (int*)ml_state_out, (long long*)csum_out,
        (int*)stop_out, (int*)ml, (int*)cid, s.lpw);
    return (int)cudaGetLastError();
}
