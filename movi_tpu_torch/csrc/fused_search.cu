// Kernel 6: the one-step backward-search scans, count and ZML.
//
// Replaces movi_tpu/engine/fused_search.py _count_init + _count_carry
// (with the final all_p gather of fused_count_scan) and _zml_init +
// _zml_carry, each over fused_bs_step.
//
// Bound on this card: the latency of two random 16 B loads per base per
// lane, the down row at (a, rs) and the up row at (a, re).  Each step's
// rows depend on the previous step's interval, and the search table of a
// real index (about 640 MB at five million runs) is past the 50 MB L2, so
// every step waits on device memory.  Design: one thread per read lane
// with the interval in registers and the loop over the bases inside the
// kernel, so a batch is one launch.  The two rows of a step do not depend
// on each other and are both in flight before either is used (the TPU
// concatenated them into one gather).  The loop is software-pipelined:
// a lane's chars do not depend on its state, so each is loaded two steps
// before the step that uses it, and a step's rows are issued as soon as
// the last decode gives its interval; while they fly the step computes
// the failure outcome's interval (init_interval, from the sigma+1 rows of
// init_rec in shared memory, indexed directly: the TPU's one-hot selects
// are not needed), and ml is stored after the next step's rows are issued.
// A count lane stops loading once its interval is empty: nothing changes
// after that.  ZML emits every step and runs to the end.  The `first` flag
// starts from the first row of chars (init, then steps from row 1);
// otherwise the scan continues from the state passed in, so a scan split
// into pieces equals one pass.  Chars are int8: -1 illegal, -2 past the
// read, 0..sigma-1.  A batch with few lanes is spread over the card's SMs
// (spread.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "search.cuh"
#include "spread.cuh"

namespace {

using movi::Interval;

template <bool ZML>
__global__ void fused_search_scan_kernel(
    const int4* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ all_p, const int8_t* __restrict__ chars, int W,
    int lanes, int r, int sigma, int first, const int* __restrict__ st_in,
    int* __restrict__ st_out, int* __restrict__ out, int lpw) {
    extern __shared__ int4 init_rec[];  // sigma + 1 rows
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    __syncthreads();
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;

    // (x, y) = (matched, done) for count, (have, ml) for ZML
    Interval cur;
    int x, y;
    int t0 = 0;
    if (first) {
        const int a0 = chars[lane];
        cur = movi::init_interval(init_rec, a0);
        x = a0 >= 0 ? 1 : 0;
        y = ZML ? 0 : 1 - x;
        if (ZML) out[lane] = 0;
        t0 = 1;
    } else {
        cur = Interval{st_in[movi::ST_RS * lanes + lane],
                       st_in[movi::ST_OS * lanes + lane],
                       st_in[movi::ST_RE * lanes + lane],
                       st_in[movi::ST_OE * lanes + lane]};
        x = st_in[movi::ST_X * lanes + lane];
        y = st_in[movi::ST_Y * lanes + lane];
    }
    // 0 (W >= 0), but not to the compiler: the word of a down row that no
    // decode reads is and-ed with it into `sink`, so that its register
    // stays live until the row lands (an instruction that reused it would
    // wait on the whole in-flight load)
    const int keep = W >> 31;
    int sink = 0;
    if (t0 < W) {
        // the first step's char and rows, and the next step's char
        const size_t lanes_s = (size_t)lanes;
        int a = chars[t0 * lanes_s + lane];
        int a_next = t0 + 1 < W ? chars[(t0 + 1) * lanes_s + lane] : 0;
        movi::StepRows rows{};
        if (ZML || !y) rows = movi::bs_rows(rec_all, r, sigma, cur, a);
        for (int t = t0; t < W; ++t) {
            if (!ZML && y) break;  // done: the count never changes again
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's rows are in flight: the char two steps on
            // and the failure outcome's interval
            const int a_after = t + 2 < W ? chars[at + 2 * lanes_s] : 0;
            const Interval ini = movi::init_interval(init_rec, a);
            Interval nxt;
            const bool empty = movi::step_decode(rows, r, cur, a, nxt);
            sink |= rows.rd.w & keep;
            int ml = 0;
            if (ZML) {
                const bool ext_ok = x && !empty;
                cur = ext_ok ? nxt : ini;
                y = ext_ok ? y + 1 : 0;
                x = ext_ok || a >= 0;
                ml = x ? y : 0;
            } else if (empty) {
                y = 1;
            } else {
                cur = nxt;
                x += 1;
            }
            // the next step's rows: the chain's only loads that wait on
            // this step's rows
            if (t + 1 < W && (ZML || !y))
                rows = movi::bs_rows(rec_all, r, sigma, cur, a_next);
            if (ZML) out[at] = ml;
            a = a_next;
            a_next = a_after;
        }
    }
    st_out[movi::ST_RS * lanes + lane] = cur.rs;
    st_out[movi::ST_OS * lanes + lane] = cur.os;
    st_out[movi::ST_RE * lanes + lane] = cur.re;
    st_out[movi::ST_OE * lanes + lane] = cur.oe;
    st_out[movi::ST_X * lanes + lane] = x + sink;
    st_out[movi::ST_Y * lanes + lane] = y;
    if (!ZML) out[lane] = movi::interval_count(all_p, r, cur, x);
}

template <bool ZML>
int launch(const void* rec_all, const void* init_rec, const void* all_p,
           const void* chars, int W, int lanes, int r, int sigma, int first,
           const void* st_in, void* st_out, void* out, void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(sigma + 1) * sizeof(int4);
    if (lanes > 0) {
        fused_search_scan_kernel<ZML>
            <<<s.grid, s.block, smem, (cudaStream_t)stream>>>(
                (const int4*)rec_all, (const int4*)init_rec,
                (const int*)all_p, (const int8_t*)chars, W, lanes, r, sigma,
                first, (const int*)st_in, (int*)st_out, (int*)out, s.lpw);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// The lanes a warp carried in the last launch of kernel 1, 5, 6, 7 or
// 10b.
extern "C" int movi_last_lanes_per_warp() {
    return movi::last_lanes_per_warp();
}

// The search scans' shared C signature; a0 is unused here (the one-step
// scans take their first char from row 0 of chars).
extern "C" int movi_fused_count_scan(const void* rec_all,
                                     const void* init_rec, const void* all_p,
                                     const void* a0, const void* chars,
                                     int W, int lanes, int r, int sigma,
                                     int first, const void* st_in,
                                     void* st_out, void* count,
                                     void* stream) {
    (void)a0;
    return launch<false>(rec_all, init_rec, all_p, chars, W, lanes, r, sigma,
                         first, st_in, st_out, count, stream);
}

extern "C" int movi_fused_zml_scan(const void* rec_all, const void* init_rec,
                                   const void* aux, const void* a0,
                                   const void* chars, int W, int lanes, int r,
                                   int sigma, int first, const void* st_in,
                                   void* st_out, void* ml, void* stream) {
    (void)aux;
    (void)a0;
    return launch<true>(rec_all, init_rec, nullptr, chars, W, lanes, r,
                        sigma, first, st_in, st_out, ml, stream);
}
