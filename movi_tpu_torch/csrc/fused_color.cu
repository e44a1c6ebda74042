// Kernel A: the one-step Movi Color scan (PML plus each base's color id).
//
// Replaces movi_tpu/engine/fused_color.py fused_color_step (with
// fused_step_math) under _fused_color_scan_carry and, with early stop,
// _fused_color_scan_carry_es and _es_check; and their records3-is-None
// form, the PML step followed by doc_set_inds[new_idx].
//
// Bound on this card: the latency of one dependent random load per base
// per lane, as kernel 1, with a 12 B row instead of 8 B (the color table
// of a real pangenome index is tens of MB and more, past the 50 MB L2);
// the two-load form adds a second load that depends on the first.
// Design: one thread per read lane, (idx, off, ml) in registers, the loop
// over the bases inside the kernel, one launch per batch.  3-word rows are
// only 4 B aligned, so a row is three int32 loads from consecutive
// addresses (an int4 or int2 load of a misaligned row would fault).  The
// two-load form reads the 8 B PML row as one int2, then cids[new_idx].
// The color selector uses the offset from before the step.  Early stop:
// the lane carries (csum int64, stop) and leaves its loop when the
// reference's rule fires (stop = the rows it scanned) or at its read's
// end; the wrapper zero-fills the outputs, so rows past a lane's
// retirement are zero.  State, the
// early-stop state and the global step t0 of row 0 come in and go out,
// so a scan split into pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "color.cuh"
#include "records.cuh"

namespace {

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
    int* __restrict__ ml, int* __restrict__ cid) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
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
    for (int t = 0; t < steps; ++t) {
        const size_t at = (size_t)t * lanes + lane;
        const int64_t row = (int64_t)idx * slots + alphas[at];
        int2 pml;
        int wc = 0;
        if constexpr (THREE) {
            const int* p = records + row * 3;
            pml = make_int2(p[0], p[1]);
            wc = p[2];
        } else {
            pml = reinterpret_cast<const int2*>(records)[row];
        }
        const movi::Step1 f = movi::decode1(pml);
        const bool hi = f.use_lf ? f.fa + off >= f.fb : off >= f.fb;
        int nidx, noff;
        movi::step1(f, off, pd_run, pd_off, nidx, noff);
        int c;
        if constexpr (THREE) {
            const uint32_t w = (uint32_t)wc;
            c = (int)(hi ? w >> 16 : w & 0xFFFFu);
        } else {
            c = cids[nidx];
        }
        idx = nidx;
        off = noff;
        m = f.match ? m + 1 : 0;
        ml[at] = m;
        cid[at] = c;
        if constexpr (ES) {
            csum += m;
            if (movi::es_hit(csum, t0 + t, L)) {
                stop = t0 + t + 1;
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
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid == 0) return (int)cudaGetLastError();
    if (rec_words != 2 && rec_words != 3) return (int)cudaErrorInvalidValue;
    auto kern = &fused_color_scan_kernel<true, false>;
    if (rec_words == 3 && lens) kern = &fused_color_scan_kernel<true, true>;
    if (rec_words == 2)
        kern = lens ? &fused_color_scan_kernel<false, true>
                    : &fused_color_scan_kernel<false, false>;
    kern<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)records, (const int*)cids, (const uint8_t*)alphas, W,
        lanes, slots, pd_run, pd_off, (const int*)lens, t0,
        (const int*)idx_in, (const int*)off_in, (const int*)ml_in,
        (const long long*)csum_in, (const int*)stop_in, (int*)idx_out,
        (int*)off_out, (int*)ml_state_out, (long long*)csum_out,
        (int*)stop_out, (int*)ml, (int*)cid);
    return (int)cudaGetLastError();
}
