// Kernel 3: the paired PML scan (two bases per record).
//
// Replaces movi_tpu/engine/fused2.py fused2_step + _fused2_decode under
// _fused2_scan_carry.
//
// Bound on this card: the latency of one dependent random 16 B load per
// two bases per lane (the paired table of a real index is gigabytes, far
// past the L2).  Halving the dependent loads per base against kernel 1 is
// the point of the layout.  Design: as kernel 1, one thread per read lane
// with the state in registers and the loop over the W2 pair steps inside
// the kernel; one int4 load per step, the decode in registers
// (records.cuh decode_pair), and two coalesced int32 stores (rows 2t and
// 2t+1 of ml).  Words are decoded from uint32 because the A_hi field
// reaches bit 31; record rows are
// indexed as int4 with 64-bit arithmetic (the word offset passes 2^31 at
// r near 2^25).

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"

namespace {

template <typename PairT>
__global__ void fused2_pml_scan_kernel(
    const int4* __restrict__ records, const PairT* __restrict__ a12,
    int W2, int lanes, int slots, int pd_run, int pd_off,
    const int* __restrict__ idx_in, const int* __restrict__ off_in,
    const int* __restrict__ ml_in, int* __restrict__ idx_out,
    int* __restrict__ off_out, int* __restrict__ ml_state_out,
    int* __restrict__ ml) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int s2 = slots * slots;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    for (int t = 0; t < W2; ++t) {
        const int a = (int)a12[(size_t)t * lanes + lane];
        const movi::PairStep d = movi::decode_pair(
            records[(int64_t)idx * s2 + a], off, pd_run, pd_off);
        const int ml1 = d.match1 ? m + 1 : 0;
        const int ml2 = d.match2 ? ml1 + 1 : 0;
        const size_t row = (size_t)(2 * t) * lanes + lane;
        ml[row] = ml1;
        ml[row + lanes] = ml2;
        idx = d.nidx;
        off = d.noff;
        m = ml2;
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

}  // namespace

// pair_bytes: 1 when the pair codes are uint8, 4 when int32.
extern "C" int movi_fused2_pml_scan(
    const void* records, const void* a12, int pair_bytes, int W2,
    int lanes, int slots, int pd_run, int pd_off, const void* idx_in,
    const void* off_in, const void* ml_in, void* idx_out, void* off_out,
    void* ml_state_out, void* ml, void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        if (pair_bytes == 1) {
            fused2_pml_scan_kernel<uint8_t>
                <<<grid, block, 0, (cudaStream_t)stream>>>(
                    (const int4*)records, (const uint8_t*)a12, W2, lanes,
                    slots, pd_run, pd_off, (const int*)idx_in,
                    (const int*)off_in, (const int*)ml_in, (int*)idx_out,
                    (int*)off_out, (int*)ml_state_out, (int*)ml);
        } else if (pair_bytes == 4) {
            fused2_pml_scan_kernel<int32_t>
                <<<grid, block, 0, (cudaStream_t)stream>>>(
                    (const int4*)records, (const int32_t*)a12, W2, lanes,
                    slots, pd_run, pd_off, (const int*)idx_in,
                    (const int*)off_in, (const int*)ml_in, (int*)idx_out,
                    (int*)off_out, (int*)ml_state_out, (int*)ml);
        } else {
            return (int)cudaErrorInvalidValue;
        }
    }
    return (int)cudaGetLastError();
}
