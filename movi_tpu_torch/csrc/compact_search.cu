// Kernels 12b and 12c: the compact count and ZML scans.
//
// Replace movi_tpu/engine/search.py _count_scan and _zml_scan (over
// _bs_step, _interval_update and _init_interval).
//
// Bound on this card: the latency of a chain of dependent loads per base
// per lane.  A step loads the two ends' chars, where they differ from the
// read's char a nearest-run row (and the end's run length), then lf_abs and
// about log2(r+1) all_p rows of each end's fast-forward search: two chains
// of some 25-28 loads each at five million runs.  Design: one thread per
// read lane with the interval in registers and the loop over the bases
// inside the kernel, so a batch is one launch.  The two ends are
// independent, and their loads are issued side by side so both chains are
// in flight together (csrc/compact.cuh lf2).  The sigma+1 rows of the
// first/last run tables sit in shared memory.  A count lane stops once its
// interval is empty; a char of -2 (past the read's start) changes nothing.
// ZML emits every step and runs to the end.  `first` starts from the first
// row of chars; otherwise the scan continues from the state passed in, so a
// scan split into pieces equals one pass.

#include <cuda_runtime.h>

#include <cstdint>

#include "compact.cuh"

namespace {

// Scan state rows in the [6, lanes] state tensors.
constexpr int ST_RS = 0, ST_OS = 1, ST_RE = 2, ST_OE = 3, ST_X = 4,
              ST_Y = 5;

template <bool ZML>
__global__ void compact_search_kernel(
    movi::compact::Tables T, const int* __restrict__ first_runs,
    const int* __restrict__ first_offsets,
    const int* __restrict__ last_runs, const int* __restrict__ last_offsets,
    const int8_t* __restrict__ codes, int W, int lanes, int first,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ out) {
    extern __shared__ int4 init[];  // (first run, offset, last run, offset)
    for (int i = threadIdx.x; i <= T.sigma; i += blockDim.x)
        init[i] = make_int4(first_runs[i], first_offsets[i], last_runs[i],
                            last_offsets[i]);
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    // initialize_backward_search: an illegal char reads the first char's
    // row, as the JAX engine does
    auto init_of = [&](int a) { return init[(a > 0 ? a : 0) + 1]; };
    // (x, y) = (matched, done) for count, (have, ml) for ZML
    int rs, os, re, oe, x, y;
    int t0 = 0;
    if (first) {
        const int a0 = codes[lane];
        const int4 v = init_of(a0);
        rs = v.x, os = v.y, re = v.z, oe = v.w;
        x = a0 >= 0 ? 1 : 0;
        y = ZML ? 0 : 1 - x;
        if (ZML) out[lane] = 0;
        t0 = 1;
    } else {
        rs = st_in[ST_RS * lanes + lane];
        os = st_in[ST_OS * lanes + lane];
        re = st_in[ST_RE * lanes + lane];
        oe = st_in[ST_OE * lanes + lane];
        x = st_in[ST_X * lanes + lane];
        y = st_in[ST_Y * lanes + lane];
    }
    for (int t = t0; t < W; ++t) {
        if (!ZML && y) break;  // done: the count never changes again
        const size_t at = (size_t)t * lanes + lane;
        const int a = codes[at];
        if (!ZML && a == -2) continue;  // past the read: not alive
        int nrs = rs, nos = os, nre = re, noe = oe;
        const bool empty = movi::compact::bs_step(T, a, nrs, nos, nre, noe);
        if (ZML) {
            const bool ext_ok = x && !empty;
            if (ext_ok) {
                rs = nrs, os = nos, re = nre, oe = noe;
                y += 1;
            } else {
                const int4 v = init_of(a);
                rs = v.x, os = v.y, re = v.z, oe = v.w;
                y = 0;
            }
            x = ext_ok || a >= 0;
            out[at] = x ? y : 0;
        } else if (empty) {
            y = 1;
        } else {
            rs = nrs, os = nos, re = nre, oe = noe;
            x += 1;
        }
    }
    st_out[ST_RS * lanes + lane] = rs;
    st_out[ST_OS * lanes + lane] = os;
    st_out[ST_RE * lanes + lane] = re;
    st_out[ST_OE * lanes + lane] = oe;
    st_out[ST_X * lanes + lane] = x;
    st_out[ST_Y * lanes + lane] = y;
    if (!ZML) {
        // the last non-empty interval's size, 0 for a lane never started
        // (int32 wraparound as in the JAX engine)
        const uint32_t s = (uint32_t)__ldg(T.all_p + rs) + (uint32_t)os;
        const uint32_t e = (uint32_t)__ldg(T.all_p + re) + (uint32_t)oe;
        out[lane] = x > 0 ? (int)(e - s + 1u) : 0;
    }
}

template <bool ZML>
int launch(const void* n, const void* lf_abs, const void* all_p,
           const void* c_search, const void* ch_up_s, const void* ch_down_s,
           const void* first_runs, const void* first_offsets,
           const void* last_runs, const void* last_offsets, int r, int sigma,
           const void* codes, int W, int lanes, int first, const void* st_in,
           void* st_out, void* out, void* stream) {
    const movi::compact::Tables T{(const int*)n,        (const int*)lf_abs,
                                  (const int*)all_p,    (const int*)c_search,
                                  (const int*)ch_up_s,  (const int*)ch_down_s,
                                  r,                    sigma};
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    const size_t smem = (size_t)(sigma + 1) * sizeof(int4);
    if (grid > 0) {
        compact_search_kernel<ZML>
            <<<grid, block, smem, (cudaStream_t)stream>>>(
                T, (const int*)first_runs, (const int*)first_offsets,
                (const int*)last_runs, (const int*)last_offsets,
                (const int8_t*)codes, W, lanes, first, (const int*)st_in,
                (int*)st_out, (int*)out);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// (n, lf_abs, all_p, c_search, ch_up_s, ch_down_s, first_runs,
// first_offsets, last_runs, last_offsets, r, sigma, codes, W, lanes, first,
// state in, state out, count [lanes] or ml [W, lanes], stream)
extern "C" int movi_compact_count_scan(
    const void* n, const void* lf_abs, const void* all_p,
    const void* c_search, const void* ch_up_s, const void* ch_down_s,
    const void* first_runs, const void* first_offsets, const void* last_runs,
    const void* last_offsets, int r, int sigma, const void* codes, int W,
    int lanes, int first, const void* st_in, void* st_out, void* count,
    void* stream) {
    return launch<false>(n, lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                         first_runs, first_offsets, last_runs, last_offsets,
                         r, sigma, codes, W, lanes, first, st_in, st_out,
                         count, stream);
}

extern "C" int movi_compact_zml_scan(
    const void* n, const void* lf_abs, const void* all_p,
    const void* c_search, const void* ch_up_s, const void* ch_down_s,
    const void* first_runs, const void* first_offsets, const void* last_runs,
    const void* last_offsets, int r, int sigma, const void* codes, int W,
    int lanes, int first, const void* st_in, void* st_out, void* ml,
    void* stream) {
    return launch<true>(n, lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                        first_runs, first_offsets, last_runs, last_offsets,
                        r, sigma, codes, W, lanes, first, st_in, st_out, ml,
                        stream);
}
