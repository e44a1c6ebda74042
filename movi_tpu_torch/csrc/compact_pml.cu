// Kernel 12a: the compact PML scan, threshold or --rpml repositioning.
//
// Replaces movi_tpu/engine/pml.py _pml_scan (body make_pml_step, LF by
// lf_step's searchsorted over all_p).
//
// Bound on this card: the latency of a chain of dependent loads per base
// per lane.  A matching base, the common one, is a chain of three loads:
//   1. the row's char and its lf_abs row, issued together;
//   2. the directory pair of the destination row's bucket (the LF's
//      absolute row lf_abs[idx] + off, csrc/compact.cuh find_run_dir);
//   3. all_p[dir[k]] with the first halving of the bucket's span, then one
//      load per further halving (a bucket of 2^b rows spans at most b + 1
//      halvings, one or two on most buckets).
// A mismatch adds its threshold (or run length) and one reposition row
// (the other too under --rpml when the first finds none), then the
// destination's length and lf_abs row together; the early lf_abs row then
// goes unused.  The directory takes the place of a search of all of all_p
// (23 dependent halvings at five million runs, 27-30 at the 10^8 runs of
// a pangenome whose all_p is far past the 50 MB L2).  Design: one thread
// per read lane with (idx, off, ml) in registers and the loop over the W
// bases inside the kernel, so a batch is one launch; latency is hidden by
// the lanes in flight.  The char loads (int8) and ml stores are coalesced
// across a warp.  State comes in and goes out, so a scan split into
// pieces equals one pass.  A reposition that finds no run in either
// direction (ScalarEngine's "character not found in index") sets *err and
// stops the lane; the wrapper raises.

#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"

namespace {

__global__ void compact_pml_kernel(
    const int* __restrict__ n, const int* __restrict__ lf_abs,
    const int* __restrict__ all_p, const uint8_t* __restrict__ c,
    const int* __restrict__ thr_full, const int* __restrict__ rep_up,
    const int* __restrict__ rep_down, movi::compact::RunDir dir,
    const int8_t* __restrict__ codes, int W, int lanes, int r, int sigma,
    int rpml, const int* __restrict__ idx_in, const int* __restrict__ off_in,
    const int* __restrict__ ml_in, int* __restrict__ idx_out,
    int* __restrict__ off_out, int* __restrict__ ml_state_out,
    int* __restrict__ ml, int* __restrict__ err) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    int h = 0;  // the halvings (unused: the plain version counts them)
    for (int t = 0; t < W; ++t) {
        const size_t at = (size_t)t * lanes + lane;
        const int a = codes[at];
        int la = __ldg(lf_abs + idx);  // issued with the row's char
        if (a >= 0) {
            if ((int)__ldg(c + idx) == a) {
                m += 1;
            } else {
                const int64_t rep = (int64_t)a * r + idx;
                bool up;
                if (rpml) {
                    up = 2 * off < __ldg(n + idx);
                    if (idx == r - 1) up = true;
                    if (idx == 0) up = false;
                } else {
                    up = off < __ldg(thr_full + (int64_t)idx * sigma + a);
                }
                int dest = __ldg((up ? rep_up : rep_down) + rep);
                if (rpml && dest >= r) {  // the other direction
                    up = !up;
                    dest = __ldg((up ? rep_up : rep_down) + rep);
                }
                if (dest >= r) {
                    *err = 1;
                    break;
                }
                idx = dest;
                off = up ? __ldg(n + dest) - 1 : 0;
                la = __ldg(lf_abs + dest);
                m = 0;
            }
        } else {
            m = 0;  // an illegal char keeps the position; LF still runs
        }
        ml[at] = m;
        movi::compact::lf_dir(all_p, dir, la, idx, off, h);
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

}  // namespace

extern "C" int movi_compact_pml_scan(
    const void* n, const void* lf_abs, const void* all_p, const void* c,
    const void* thr_full, const void* rep_up, const void* rep_down,
    const void* run_dir, int K, int b, const void* codes, int W, int lanes,
    int r, int sigma, int rpml, const void* idx_in, const void* off_in,
    const void* ml_in, void* idx_out, void* off_out, void* ml_state_out,
    void* ml, void* err, void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        compact_pml_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int*)n, (const int*)lf_abs, (const int*)all_p,
            (const uint8_t*)c, (const int*)thr_full, (const int*)rep_up,
            (const int*)rep_down,
            movi::compact::RunDir{(const int*)run_dir, K, b},
            (const int8_t*)codes, W, lanes, r, sigma, rpml,
            (const int*)idx_in, (const int*)off_in, (const int*)ml_in,
            (int*)idx_out, (int*)off_out, (int*)ml_state_out, (int*)ml,
            (int*)err);
    }
    return (int)cudaGetLastError();
}
