// Kernels 8a and 8b: SA entries (query --pml --sa-entries).
//
// 8a, the pre-state scan, replaces movi_tpu/engine/fused_sa.py
// _pml_pre_state_scan: kernel 1's one-step PML scan that also writes each
// base's pre-LF (run, offset), the state the reference walks from.  Bound
// on this card: as kernel 1, the latency of one dependent random 8 B
// record load per base per lane.  The 12 B pre_tab row is keyed by the
// same idx*slots + a as the record, so its loads issue beside the record
// load and the next step's row does not depend on them; but the stores
// that use them come before the next step's record load, so a step waits
// for the slower of the two rows.  The rows are only 4 B aligned, so a
// row is three int32 loads.  Design: one thread per lane, (idx, off, ml)
// in registers, the loop over the W bases inside the kernel, state in and
// out so a scan split into pieces equals one pass.
//
// 8b, the SA walk, replaces movi_tpu/engine/fused_sa.py _sa_walk: every
// flat (run, offset) takes plain LF steps (with the bounded fast-forward
// of the illegal-char record slot) until its absolute position is a
// multiple of rate, then reads sampled[pos / rate] and adds the steps.
// Bound on this card: the random loads of the walk, two per step (the
// run's first position and its record), about rate steps per element.
// Design: one thread per element (a 64-bit flat index), each looping on
// its own until it reaches a sampled row, where the JAX while_loop ran
// the whole batch as long as its slowest element; millions of independent
// threads keep the memory system busy.  Both per-step loads depend on idx
// alone and issue together.  Positions, sampled values and the output
// are 64-bit.  From any valid state the LF cycle reaches row 0 within n
// steps, so a walk longer than max_steps (the text length) can only come
// from a bad state: it stops with -1 instead of holding the card.

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"

namespace {

__global__ void fused_sa_pre_scan_kernel(
    const int2* __restrict__ records, const int* __restrict__ pre_tab,
    const uint8_t* __restrict__ alphas, int W, int lanes, int slots,
    int pd_run, int pd_off, const int* __restrict__ idx_in,
    const int* __restrict__ off_in, const int* __restrict__ ml_in,
    int* __restrict__ idx_out, int* __restrict__ off_out,
    int* __restrict__ ml_state_out, int* __restrict__ ml,
    int* __restrict__ pre_idx, int* __restrict__ pre_off) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    for (int t = 0; t < W; ++t) {
        const size_t at = (size_t)t * lanes + lane;
        const int64_t row = (int64_t)idx * slots + alphas[at];
        const int2 rec = records[row];
        const int* pt = pre_tab + row * 3;
        const int up_run = pt[0];
        const int dn_run = pt[1];
        const int up_off = pt[2];
        const movi::Step1 f = movi::decode1(rec);
        // the carry on the match/illegal path; else the reposition
        // target before its LF: (up_run, n-1) going up, (dn_run, 0) down
        const bool down = off >= f.fb;
        pre_idx[at] = f.use_lf ? idx : (down ? dn_run : up_run);
        pre_off[at] = f.use_lf ? off : (down ? 0 : up_off);
        int nidx, noff;
        movi::step1(f, off, pd_run, pd_off, nidx, noff);
        idx = nidx;
        off = noff;
        m = f.match ? m + 1 : 0;
        ml[at] = m;
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

__global__ void sa_walk_kernel(const int2* __restrict__ records, int slots,
                               const long long* __restrict__ all_p,
                               const long long* __restrict__ sampled,
                               long long rate, long long max_steps,
                               const int* __restrict__ idx_in,
                               const int* __restrict__ off_in, long long n,
                               long long* __restrict__ out) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int sigma = slots - 1;
    int idx = idx_in[i];
    int off = off_in[i];
    long long dist = 0;
    for (;;) {
        const long long first = all_p[idx];
        const int2 rec = records[(int64_t)idx * slots + sigma];
        const long long pos = first + off;
        if (pos % rate == 0) {
            out[i] = sampled[pos / rate] + dist;
            return;
        }
        if (dist == max_steps) {  // no valid state walks this far
            out[i] = -1;
            return;
        }
        const int fa = rec.y & movi::FA_MASK;
        const int fb = (rec.y >> movi::FB_SHIFT) & movi::FB_MASK;
        const int off0 = fa + off;
        const int ff = off0 >= fb ? 1 : 0;
        idx = rec.x + ff;
        off = off0 - ff * fb;
        ++dist;
    }
}

}  // namespace

extern "C" int movi_fused_sa_pre_scan(
    const void* records, const void* pre_tab, const void* alphas, int W,
    int lanes, int slots, int pd_run, int pd_off, const void* idx_in,
    const void* off_in, const void* ml_in, void* idx_out, void* off_out,
    void* ml_state_out, void* ml, void* pre_idx, void* pre_off,
    void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        fused_sa_pre_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int2*)records, (const int*)pre_tab, (const uint8_t*)alphas,
            W, lanes, slots, pd_run, pd_off, (const int*)idx_in,
            (const int*)off_in, (const int*)ml_in, (int*)idx_out,
            (int*)off_out, (int*)ml_state_out, (int*)ml, (int*)pre_idx,
            (int*)pre_off);
    }
    return (int)cudaGetLastError();
}

extern "C" int movi_sa_walk(const void* records, int slots, const void* all_p,
                            const void* sampled, long long rate,
                            long long max_steps, const void* idx,
                            const void* off, long long n, void* out,
                            void* stream) {
    if (rate <= 0) return (int)cudaErrorInvalidValue;
    const int block = 256;
    const long long grid = (n + block - 1) / block;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (grid > 0) {
        sa_walk_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const int2*)records, slots, (const long long*)all_p,
            (const long long*)sampled, rate, max_steps, (const int*)idx,
            (const int*)off, n, (long long*)out);
    }
    return (int)cudaGetLastError();
}
