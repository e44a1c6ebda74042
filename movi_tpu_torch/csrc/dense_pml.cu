// Kernel 14: the dense-automaton PML scan.
//
// Replaces movi_tpu/engine/dense.py _dense_pml_scan (one lax.scan per
// batch over the transition table dense[p * (sigma+1) + a] = next_p |
// (is_match << 31)).
//
// Bound on this card: the latency of one dependent random 4 B load per
// base per lane.  Each step's address depends on the previous step's
// position, and the table of a real index ((sigma+1) * 4 B per BWT row,
// 120 MB at six million rows) is past the 50 MB L2.  Design: one thread
// per read lane with (p, ml) in registers and the loop over the W bases
// inside the kernel, so a batch is one launch; the slot loads (uint8) and
// ml stores are coalesced across a warp.  The table index is 64-bit: at
// n * (sigma+1) >= 2^31 entries (n >= ~4.3e8 rows for DNA) the JAX
// package's int32 index wraps, and the 80 GB card holds such a table.
// State comes in and goes out, so a scan split into pieces equals one
// pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void dense_pml_scan_kernel(
    const int* __restrict__ table, const uint8_t* __restrict__ codes, int W,
    int lanes, int slots, const int* __restrict__ p_in,
    const int* __restrict__ ml_in, int* __restrict__ p_out,
    int* __restrict__ ml_state_out, int* __restrict__ ml) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int p = p_in[lane];
    int m = ml_in[lane];
    for (int t = 0; t < W; ++t) {
        const size_t at = (size_t)t * lanes + lane;
        const int w = table[(int64_t)p * slots + codes[at]];
        m = w < 0 ? m + 1 : 0;
        p = w & 0x7FFFFFFF;
        ml[at] = m;
    }
    p_out[lane] = p;
    ml_state_out[lane] = m;
}

}  // namespace

extern "C" int movi_dense_pml_scan(const void* table, const void* codes,
                                   int W, int lanes, int slots,
                                   const void* p_in, const void* ml_in,
                                   void* p_out, void* ml_state_out, void* ml,
                                   void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        dense_pml_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int*)table, (const uint8_t*)codes, W, lanes, slots,
            (const int*)p_in, (const int*)ml_in, (int*)p_out,
            (int*)ml_state_out, (int*)ml);
    }
    return (int)cudaGetLastError();
}
