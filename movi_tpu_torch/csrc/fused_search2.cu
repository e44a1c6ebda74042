// Kernel 7: the paired backward-search scans, count and ZML.
//
// Replaces movi_tpu/engine/fused_search2.py _count2_init + _count2_carry
// (with the final all_p gather of fused2_count_scan) and _zml2_carry
// (_zml_pair_body), each over fused2_bs_step.
//
// Bound on this card: the latency of two random 24 B loads per two bases
// per lane, one per direction.  The paired table of a real index (768 B
// per run for DNA, 3.8 GB at five million runs) is far past the L2, so
// each pair step waits on device memory; the layout halves the dependent
// steps against kernel 6.  Design: one thread per read lane with the
// interval in registers and the loop over the pair steps inside the
// kernel (one launch per batch; the TPU's 1024-pair carried chunks are
// gone).  A row is read as three 8 B loads (24 B rows are only 8 B
// aligned), both directions' rows in flight together, with 64-bit row
// offsets.  init_rec (sigma+1 rows) and ZML's mid-pair restart table
// restart_rec (sigma^2 rows of 5) sit in shared memory and are indexed
// directly, where the TPU used one-hot contractions.  The loop is
// software-pipelined: a lane's pair codes do not depend on its state, so
// each is loaded two steps before the step whose rows it addresses and
// unpacked the step before, and a step's rows are issued as soon as the
// decode before gives its interval.  While they fly, ZML reads its
// failure outcomes from shared memory (init_interval of a2, and the
// restart row of a12), and its two ml stores follow the next step's
// issue.  Emptiness is the crossed-interval test, and the second step's
// emptiness counts only where the first step was not empty.  A count lane
// stops loading once it is done.  The count's `first` flag starts from
// the first chars a0 (int8 [lanes]) and ZML's from nothing matched;
// otherwise the scan continues from the state passed in.  A batch with
// few lanes is spread over the card's SMs (spread.cuh).

#include <cuda_runtime.h>

#include <cstdint>

#include "search2.cuh"
#include "spread.cuh"

namespace {

using movi::Interval;

template <bool ZML>
__global__ void fused2_search_scan_kernel(
    const int* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ aux, const int8_t* __restrict__ a0_in,
    const uint8_t* __restrict__ pairs, int W2, int lanes, int r, int sigma,
    int first, const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ out, int lpw) {
    // init_rec (sigma+1 int4), then for ZML restart_rec (sigma^2 x 5 int)
    extern __shared__ int4 smem[];
    int4* init_rec = smem;
    int* restart = reinterpret_cast<int*>(smem + sigma + 1);
    const int S2 = sigma * sigma;
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    if (ZML) {
        for (int i = threadIdx.x; i < S2 * 5; i += blockDim.x)
            restart[i] = aux[i];
    }
    __syncthreads();
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;

    // (x, y) = (matched, done) for count, (have, ml) for ZML
    Interval cur;
    int x, y;
    if (first) {
        if (ZML) {
            cur = Interval{0, 0, 0, 0};
            x = 0;
            y = 0;
        } else {
            const int a0 = a0_in[lane];
            cur = movi::init_interval(init_rec, a0);
            x = a0 >= 0 ? 1 : 0;
            y = 1 - x;
        }
    } else {
        cur = Interval{st_in[movi::ST_RS * lanes + lane],
                       st_in[movi::ST_OS * lanes + lane],
                       st_in[movi::ST_RE * lanes + lane],
                       st_in[movi::ST_OE * lanes + lane]};
        x = st_in[movi::ST_X * lanes + lane];
        y = st_in[movi::ST_Y * lanes + lane];
    }
    if (W2 > 0 && (ZML || !y)) {
        // the first pair step's code and rows, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        movi::PairCode p = movi::pair_code(pairs[lane], sigma);
        int v_next = W2 > 1 ? pairs[lanes_s + lane] : 0;
        movi::PairRows rows = movi::bs2_rows(rec_all, r, S2, cur, p.a12);
        for (int t = 0; t < W2; ++t) {
            if (!ZML && y) break;  // done: the count never changes again
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's rows are in flight: the next step's code
            // unpacked, the code two steps on (in the last two steps this
            // step's own, never used) and, for ZML, the failure outcomes
            const movi::PairCode pn = movi::pair_code(v_next, sigma);
            const int v_after = pairs[t + 2 < W2 ? at + 2 * lanes_s : at];
            Interval mid, fin;
            bool e1, e2;
            int ml1 = 0;
            if (ZML) {
                const int* rst = restart + movi::clampi(p.a12, 0, S2 - 1) * 5;
                const Interval restart_iv{rst[0], rst[1], rst[2], rst[3]};
                const bool restart_ok = rst[4] == 0;
                const Interval ini = movi::init_interval(init_rec, p.a2);
                movi::bs2_decode(rows, cur, p.l1, p.l2, mid, fin, e1, e2);
                const bool ok1 = x && !e1;
                ml1 = ok1 ? y + 1 : 0;
                const bool okA = ok1 && !e2;
                const bool okB = !ok1 && p.l1 && p.l2 && restart_ok;
                cur = okA ? fin : (okB ? restart_iv : ini);
                x = okA || okB || p.l2;
                y = (okA || okB) ? ml1 + 1 : 0;
            } else {
                movi::bs2_decode(rows, cur, p.l1, p.l2, mid, fin, e1, e2);
                if (!e1) {
                    cur = e2 ? mid : fin;
                    x += e2 ? 1 : 2;
                }
                y = e1 || e2;
            }
            // the next step's rows: the chain's only loads (after the
            // last step, or once a count lane is done, rows inside the
            // table that are never used: behind a branch the loads can
            // sink below the stores)
            rows = movi::bs2_rows(rec_all, r, S2, cur, pn.a12);
            if (ZML) {
                const size_t row = (size_t)(2 * t) * lanes_s + lane;
                out[row] = ml1;
                out[row + lanes_s] = y;
            }
            p = pn;
            v_next = v_after;
        }
    }
    st_out[movi::ST_RS * lanes + lane] = cur.rs;
    st_out[movi::ST_OS * lanes + lane] = cur.os;
    st_out[movi::ST_RE * lanes + lane] = cur.re;
    st_out[movi::ST_OE * lanes + lane] = cur.oe;
    st_out[movi::ST_X * lanes + lane] = x;
    st_out[movi::ST_Y * lanes + lane] = y;
    if (!ZML) out[lane] = movi::interval_count(aux, r, cur, x);
}

template <bool ZML>
int launch(const void* rec_all, const void* init_rec, const void* aux,
           const void* a0, const void* pairs, int W2, int lanes, int r,
           int sigma, int first, const void* st_in, void* st_out, void* out,
           void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = (size_t)(sigma + 1) * sizeof(int4)
                        + (ZML ? (size_t)sigma * sigma * 5 * sizeof(int) : 0);
    if (lanes > 0) {
        fused2_search_scan_kernel<ZML>
            <<<s.grid, s.block, smem, (cudaStream_t)stream>>>(
                (const int*)rec_all, (const int4*)init_rec, (const int*)aux,
                (const int8_t*)a0, (const uint8_t*)pairs, W2, lanes, r,
                sigma, first, (const int*)st_in, (int*)st_out, (int*)out,
                s.lpw);
    }
    return (int)cudaGetLastError();
}

}  // namespace

// aux is all_p for count and restart_rec for ZML; a0 is used by count
// only, and only when first is set.
extern "C" int movi_fused2_count_scan(const void* rec_all,
                                      const void* init_rec, const void* aux,
                                      const void* a0, const void* pairs,
                                      int W2, int lanes, int r, int sigma,
                                      int first, const void* st_in,
                                      void* st_out, void* count,
                                      void* stream) {
    return launch<false>(rec_all, init_rec, aux, a0, pairs, W2, lanes, r,
                         sigma, first, st_in, st_out, count, stream);
}

extern "C" int movi_fused2_zml_scan(const void* rec_all,
                                    const void* init_rec, const void* aux,
                                    const void* a0, const void* pairs,
                                    int W2, int lanes, int r, int sigma,
                                    int first, const void* st_in,
                                    void* st_out, void* ml, void* stream) {
    return launch<true>(rec_all, init_rec, aux, a0, pairs, W2, lanes, r,
                        sigma, first, st_in, st_out, ml, stream);
}
