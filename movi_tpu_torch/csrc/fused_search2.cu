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
// steps against kernel 4.  Design: one thread per read lane with the
// interval in registers and the loop over the pair steps inside the
// kernel (one launch per batch; the TPU's 1024-pair carried chunks are
// gone).  A row is read as three 8 B loads (24 B rows are only 8 B
// aligned), both directions' rows in flight together, with 64-bit row
// offsets.  init_rec (sigma+1 rows) and ZML's mid-pair restart table
// restart_rec (sigma^2 rows of 5) sit in shared memory and are indexed
// directly, where the TPU used one-hot contractions.  Emptiness is the
// crossed-interval test, and the second step's emptiness counts only
// where the first step was not empty.  A count lane stops loading once it
// is done.  The count's `first` flag starts from the first chars a0
// (int8 [lanes]) and ZML's from nothing matched; otherwise the scan
// continues from the state passed in.

#include <cuda_runtime.h>

#include <cstdint>

#include "search2.cuh"

namespace {

using movi::Interval;

template <bool ZML>
__global__ void fused2_search_scan_kernel(
    const int* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ aux, const int8_t* __restrict__ a0_in,
    const uint8_t* __restrict__ pairs, int W2, int lanes, int r, int sigma,
    int first, const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ out) {
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
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

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
    for (int t = 0; t < W2; ++t) {
        if (!ZML && y) break;  // done: the count never changes again
        int a1, a2, a12;
        movi::unpack_pair(pairs[(size_t)t * lanes + lane], sigma, a1, a2,
                          a12);
        const bool l1 = a1 >= 0, l2 = a2 >= 0;
        Interval mid, fin;
        bool e1, e2;
        movi::bs2_step(rec_all, r, S2, cur, a12, l1, l2, mid, fin, e1, e2);
        if (ZML) {
            const bool ok1 = x && !e1;
            const int ml1 = ok1 ? y + 1 : 0;
            const int* rst = restart + movi::clampi(a12, 0, S2 - 1) * 5;
            const bool okA = ok1 && !e2;
            const bool okB = !ok1 && l1 && l2 && rst[4] == 0;
            const int ml2 = (okA || okB) ? ml1 + 1 : 0;
            if (okA) {
                cur = fin;
            } else if (okB) {
                cur = Interval{rst[0], rst[1], rst[2], rst[3]};
            } else {
                cur = movi::init_interval(init_rec, a2);
            }
            x = okA || okB || l2;
            y = ml2;
            const size_t row = (size_t)(2 * t) * lanes + lane;
            out[row] = ml1;
            out[row + lanes] = ml2;
        } else {
            if (!e1) {
                cur = e2 ? mid : fin;
                x += e2 ? 1 : 2;
            }
            y = e1 || e2;
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
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    const size_t smem = (size_t)(sigma + 1) * sizeof(int4)
                        + (ZML ? (size_t)sigma * sigma * 5 * sizeof(int) : 0);
    if (grid > 0) {
        fused2_search_scan_kernel<ZML>
            <<<grid, block, smem, (cudaStream_t)stream>>>(
                (const int*)rec_all, (const int4*)init_rec, (const int*)aux,
                (const int8_t*)a0, (const uint8_t*)pairs, W2, lanes, r,
                sigma, first, (const int*)st_in, (int*)st_out, (int*)out);
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
