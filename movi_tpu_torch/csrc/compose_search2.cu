// Kernel 7's compose: the paired backward-search records.
//
// Replaces movi_tpu/engine/fused_search2.py _compose_search2_chunk
// (jitted with donation and driven chunk by chunk by compose_search2).
//
// Bound on this card: device-memory traffic.  Each 24 B output record
// needs step 1's fields at its own run (shared by the sigma threads of
// that (run, a1)) and step 2's fields at the step-1 destination A1 and
// A1+1, which land anywhere in the run arrays: about a dozen 4 B gathers
// per record, plus the 768 B/run table write (3.8 GB at five million runs
// for DNA).  Design: one thread per (direction, run, a1, a2), which
// evaluates the three micro-step field sets in registers and writes its
// six words straight into the preallocated table as three 8 B stores
// (rows are 8 B aligned), neighbouring threads on neighbouring rows.  No
// chunks and no intermediates, so peak memory is the table plus its
// inputs.  Sentinels as in the JAX compose: a start-side step with no
// matching run gets A = SENT_HI, an end-side one A = 0, both with B = 0
// and C = GUARD; C is GUARD too when the destination is the last run.
// Words are built in 32-bit unsigned arithmetic (the highest field bit is
// u2_hi at 27); thread and row indices are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"

namespace {

constexpr int GUARD = 0xFFF;
constexpr int SENT_HI = 0x1FFFFFF;

struct Fields {
    int A, B, C, u;
};

// One micro-step's (A, B, C, u) for the next-run table row `tab` of one
// char, evaluated at run `cur` (fields() of the JAX compose).
__device__ __forceinline__ Fields fields(const int* __restrict__ tab,
                                         bool up, int cur,
                                         const int* __restrict__ id_a,
                                         const int* __restrict__ off_a,
                                         const int* __restrict__ n_a,
                                         int r) {
    const int d = tab[movi::clampi(cur, 0, r - 1)];
    const bool ex = d < r && cur < r;
    Fields f;
    if (!ex) {
        f.A = up ? 0 : SENT_HI;
        f.B = 0;
        f.C = GUARD;
        f.u = 0;
        return f;
    }
    const int dc = movi::clampi(d, 0, r - 1);
    const bool keep = d == cur;
    const int idd = id_a[dc];
    f.A = idd;
    f.B = off_a[dc] + (keep || !up ? 0 : n_a[dc] - 1);
    f.C = idd < r - 1 ? n_a[movi::clampi(idd, 0, r - 1)] : GUARD;
    f.u = keep ? 1 : 0;
    return f;
}

__global__ void compose_search2_kernel(const int* __restrict__ id_a,
                                       const int* __restrict__ off_a,
                                       const int* __restrict__ n_a,
                                       const int* __restrict__ nu,
                                       const int* __restrict__ nd, int r,
                                       int sigma, int* __restrict__ out) {
    const int64_t S2 = (int64_t)sigma * sigma;
    const int64_t per_dir = (int64_t)r * S2;
    const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= 2 * per_dir) return;
    const bool up = t >= per_dir;
    const int64_t rem = up ? t - per_dir : t;
    const int run = (int)(rem / S2);
    const int k = (int)(rem - (int64_t)run * S2);
    const int a1 = k / sigma;
    const int a2 = k - a1 * sigma;
    const int* tab = up ? nu : nd;
    const int* tab1 = tab + (int64_t)a1 * r;
    const int* tab2 = tab + (int64_t)a2 * r;

    const Fields s1 = fields(tab1, up, run, id_a, off_a, n_a, r);
    const Fields lo = fields(tab2, up, s1.A, id_a, off_a, n_a, r);
    const Fields hi = fields(tab2, up, s1.A + 1, id_a, off_a, n_a, r);

    const uint32_t w0 = (uint32_t)s1.A | ((uint32_t)s1.u << 25)
                        | ((uint32_t)lo.u << 26) | ((uint32_t)hi.u << 27);
    const uint32_t w3 = (uint32_t)s1.B | ((uint32_t)s1.C << 12);
    const uint32_t w4 = (uint32_t)lo.B | ((uint32_t)lo.C << 12);
    const uint32_t w5 = (uint32_t)hi.B | ((uint32_t)hi.C << 12);
    int2* row = reinterpret_cast<int2*>(out + t * 6);
    row[0] = make_int2((int)w0, lo.A);
    row[1] = make_int2(hi.A, (int)w3);
    row[2] = make_int2((int)w4, (int)w5);
}

}  // namespace

// id/offset/n: int32 [r]; nu/nd: int32 [sigma, r] (r = no matching run);
// out: int32 [2*r*sigma^2, 6], down slab then up slab.
extern "C" int movi_compose_search2_records(const void* id_a,
                                            const void* off_a,
                                            const void* n_a, const void* nu,
                                            const void* nd, int r, int sigma,
                                            void* out, void* stream) {
    const int64_t n = 2 * (int64_t)r * sigma * sigma;
    const int block = 256;
    const int64_t grid = (n + block - 1) / block;
    if (grid > 0) {
        compose_search2_kernel<<<(unsigned)grid, block, 0,
                                 (cudaStream_t)stream>>>(
            (const int*)id_a, (const int*)off_a, (const int*)n_a,
            (const int*)nu, (const int*)nd, r, sigma, (int*)out);
    }
    return (int)cudaGetLastError();
}
