// How a batch's lanes are laid over the card's warps (kernels 1, 3, 4,
// 5, 6, 7, 10b, 14, 15a and 15b).
//
// A lane is one thread's chain of dependent row loads, and a warp issues
// in step: it waits each step on the slowest of its lanes' rows.  A batch
// with no more lanes than the card has SMs (the 64 lanes of a 10 kb batch)
// is better spread one lane a warp, one warp an SM, than packed into two
// warps of one SM; a larger batch keeps 32 lanes a warp, so that its
// warps' instructions serve 32 lanes each.  Only these two shapes have
// been timed (at 64 and 8,192 lanes); the rule takes only the batch's lane
// count and the card's SM count.
#pragma once

#include <cuda_runtime.h>

namespace movi {

// The lanes each warp carries: 1 while the batch has no more lanes than
// the card has SMs, else 32.
__host__ __device__ inline int lanes_per_warp(int lanes, int sms) {
    return lanes <= sms ? 1 : 32;
}

// The lanes a warp carried in this library's last launch of kernel 1, 3,
// 4, 5, 6, 7, 10b, 14, 15a or 15b (0 before the first).
inline int& last_lanes_per_warp() {
    static int lpw = 0;
    return lpw;
}

// A launch over `lanes` lanes: `lpw` lanes a warp; `block` threads a
// block, the kernel's own block when a warp carries 32 lanes, else one
// warp, so that each warp can sit on an SM of its own.
struct Spread {
    int lpw, block, grid;
};

// The current device's SM count, read once a device; an error if the
// device or its SM count cannot be read.
inline cudaError_t sm_count(int* sms) {
    constexpr int kDevices = 64;
    static int sms_of[kDevices];  // 0: not read yet
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return e;
    if (dev < 0 || dev >= kDevices) return cudaErrorInvalidDevice;
    if (sms_of[dev] <= 0) {
        int n = 0;
        e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
        if (e != cudaSuccess) return e;
        if (n <= 0) return cudaErrorInvalidDevice;
        sms_of[dev] = n;
    }
    *sms = sms_of[dev];
    return cudaSuccess;
}

// The launch of `lanes` lanes on the current device; an error if the
// device or its SM count cannot be read.
inline cudaError_t spread(int lanes, int full_block, Spread* s) {
    int sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return e;
    s->lpw = lanes_per_warp(lanes, sms);
    s->block = s->lpw == 32 ? full_block : 32;
    const long long per_block = (long long)(s->block / 32) * s->lpw;
    s->grid = (int)((lanes + per_block - 1) / per_block);
    last_lanes_per_warp() = s->lpw;
    return cudaSuccess;
}

// This thread's lane, or -1 for a thread past its warp's lanes.
__device__ __forceinline__ int spread_lane(int lpw) {
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int j = threadIdx.x & 31;
    return j < lpw ? warp * lpw + j : -1;
}

}  // namespace movi
