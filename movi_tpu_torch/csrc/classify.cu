// Kernel 16a: binary classification from the matching lengths.
//
// Replaces movi_tpu/parallel/mesh.py _classify_from_ml (after the PML
// scans of _pml_classify_scan and _pml_classify_scan_paired): the maxima
// of bins of bin_width processing-order lengths, with the last short
// region merged into the previous bin (classifier.cpp:99-143), and the
// vote of the bins at or above max_value_thr.
//
// Bound on this card: bytes, one read of ml [W, lanes] (the lengths past
// each read are never loaded).  Design: one thread per lane walking its
// column, loads coalesced across the lanes of a warp; the naive bins of
// the JAX version (ceil(W / bin_width), positions past the read at -1)
// are closed as the walk crosses them, so nothing but three counters
// lives per lane.  B = max(L / bin_width, 1) true bins: the bins before
// B-1 vote one each, and the maximum over bins B-1 to the end votes once.
// found = 2 * above > B, below = B - above; a lane of length 0 gives
// (false, 0, 1), as the JAX version does.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__global__ void classify_from_ml_kernel(
    const int* __restrict__ ml, const int* __restrict__ lengths, int W,
    int lanes, int bin_width, int thr, uint8_t* __restrict__ found,
    int* __restrict__ above_out, int* __restrict__ below_out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int L = lengths[lane];
    const int q = L / bin_width;
    const int B = q > 1 ? q : 1;
    int above = 0;
    int tail = -1;     // the merged last bin's maximum
    int bin_max = -1;  // the open naive bin's maximum
    int b = 0, in_bin = 0;
    for (int t = 0; t < W; ++t) {
        const int v = t < L ? ml[(size_t)t * lanes + lane] : -1;
        bin_max = v > bin_max ? v : bin_max;
        if (++in_bin == bin_width || t == W - 1) {
            if (b < B - 1)
                above += bin_max >= thr ? 1 : 0;
            else
                tail = bin_max > tail ? bin_max : tail;
            ++b;
            in_bin = 0;
            bin_max = -1;
        }
    }
    above += tail >= thr ? 1 : 0;
    found[lane] = 2 * above > B ? 1 : 0;
    above_out[lane] = above;
    below_out[lane] = B - above;
}

}  // namespace

extern "C" int movi_classify_from_ml(const void* ml, const void* lengths,
                                     int W, int lanes, int bin_width,
                                     int thr, void* found, void* above,
                                     void* below, void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        classify_from_ml_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int*)ml, (const int*)lengths, W, lanes, bin_width, thr,
            (uint8_t*)found, (int*)above, (int*)below);
    }
    return (int)cudaGetLastError();
}
