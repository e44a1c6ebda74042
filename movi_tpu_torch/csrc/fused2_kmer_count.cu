// Kernel 7b: exact k-mer counts on the paired search records.
//
// Replaces movi_tpu/engine/fused_search2.py fused2_kmer_count_scan.
//
// Bound on this card: the latency of ceil((k-1)/2) dependent pair steps
// per k-mer, each two random 24 B rows (one per direction) from a paired
// table far past the L2 (3.8 GB at five million runs); half the dependent
// steps of kernel 9b.  Design: one thread per k-mer reads its k chars from
// the read-order int8 slots (no [k, nk] window matrix), inits from the
// last char, and takes the k-1 extensions as composed pairs with
// bs2_step; an odd tail's second char is the beyond-read sentinel, which
// takes the mid-pair interval and does not kill the k-mer.  A lane stops
// at its first empty step (its result is fixed then).

#include <cuda_runtime.h>

#include <cstdint>

#include "search2.cuh"

namespace {

using movi::Interval;

__global__ void fused2_kmer_count_kernel(
    const int* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ all_p, const int8_t* __restrict__ slots, int W,
    const int* __restrict__ lane_of, const int* __restrict__ start_of,
    int nk, int r, int sigma, int k, uint8_t* __restrict__ found_out,
    int* __restrict__ cnt_out) {
    extern __shared__ int4 init_rec[];  // sigma + 1 rows
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    __syncthreads();
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= nk) return;
    const int S2 = sigma * sigma;
    const int8_t* w = slots + (int64_t)lane_of[i] * W + start_of[i];
    bool dead = false;
    for (int j = 0; j < k; ++j) dead |= w[j] < 0;
    Interval iv = movi::init_interval(init_rec, w[k - 1]);
    // the extensions kmer[k-2] ... kmer[0], two per step
    for (int e = 0; e < k - 1 && !dead; e += 2) {
        const int a1 = w[k - 2 - e];
        const int a2 = e + 1 < k - 1 ? w[k - 3 - e] : -2;
        const bool l2 = a2 >= 0;
        Interval mid, fin;
        bool e1, e2;
        movi::bs2_step(rec_all, r, S2, iv,
                       (a1 > 0 ? a1 : 0) * sigma + (a2 > 0 ? a2 : 0), a1 >= 0,
                       l2, mid, fin, e1, e2);
        if (e1) {
            dead = true;
        } else if (e2) {
            iv = mid;
            dead = l2;
        } else {
            iv = fin;
        }
    }
    found_out[i] = dead ? 0 : 1;
    cnt_out[i] = movi::interval_count(all_p, r, iv, dead ? 0 : 1);
}

}  // namespace

// slots int8 [lanes, W]; the k-mer i starts at (lane_of[i], start_of[i])
// with start_of[i] <= W - k.
extern "C" int movi_fused2_kmer_count_scan(
    const void* rec_all, const void* init_rec, const void* all_p,
    const void* slots, int W, const void* lane_of, const void* start_of,
    int nk, int r, int sigma, int k, void* found, void* cnt, void* stream) {
    const int block = 256;
    const int grid = (nk + block - 1) / block;
    if (grid > 0) {
        fused2_kmer_count_kernel<<<grid, block,
                                   (size_t)(sigma + 1) * sizeof(int4),
                                   (cudaStream_t)stream>>>(
            (const int*)rec_all, (const int4*)init_rec, (const int*)all_p,
            (const int8_t*)slots, W, (const int*)lane_of,
            (const int*)start_of, nk, r, sigma, k, (uint8_t*)found,
            (int*)cnt);
    }
    return (int)cudaGetLastError();
}
