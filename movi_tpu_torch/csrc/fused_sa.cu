// Kernels 8a and 8b: SA entries (query --pml --sa-entries).
//
// 8a, the pre-state scan, replaces movi_tpu/engine/fused_sa.py
// _pml_pre_state_scan: kernel 1's one-step PML scan that also writes each
// base's pre-LF (run, offset), the state the reference walks from.  Bound
// on this card: as kernel 1, the latency of one dependent random 8 B
// record load per base per lane.  The 12 B pre_tab row is keyed by the
// same idx*slots + a as the record, so it is loaded beside the record;
// but the stores that use it must not come before the next step's record
// load, or a warp (which issues in order) waits each step for the slower
// of two random rows in tables past the L2.  Design: one thread per lane,
// (idx, off, ml) in registers, the loop over the W bases inside the
// kernel, state in and out so a scan split into pieces equals one pass;
// the loop is software-pipelined: as soon as step t's new idx is known it
// issues step t+1's record and pre_tab row (the code two steps ahead),
// and only then writes step t's ml, pre_idx and pre_off, so a step waits
// on one dependent record load, as in kernel 1.  The rows are only 4 B
// aligned, so a row is three int32 loads (a 16 B row, one load, was 1.6%
// faster on an H100 for a third more table).
//
// 8b, the SA walk, replaces movi_tpu/engine/fused_sa.py _sa_walk: the SA
// value of a base is its pre-LF (run, offset)'s LF walk (plain LF steps
// with the bounded fast-forward of the illegal-char record slot) to a row
// that is a multiple of rate, sampled[row / rate] + the steps.  Most of
// those walks repeat each other: the carry after step t is always
// LF(pre_t), and a step t+1 on the LF path (a match, ml > 0, or the
// illegal slot sigma) walks from that carry, so where row(pre_t) is not
// sampled, SA(t) = SA(t+1) + 1 with one step more.  Three launches:
//   sa_mark  one thread per element: a sampled row takes its sample; an
//            element whose step t+1 is on the LF path is a link; the
//            rest (anchors) are appended to a list (one atomic a warp);
//   sa_walk  the walk, over the anchor list only, its length read on the
//            card (a fixed grid strides over it: no host sync);
//   sa_fill  each link takes value(t+1) + 1 and steps(t+1) + 1: a thread
//            per (lane, chunk of t) goes backward over its chunk from the
//            first resolved element at or after the chunk's end.
// A walk longer than max_steps (the text length; from a valid state the
// LF cycle reaches row 0 sooner) can only come from a bad state: it stops
// with -1 instead of holding the card, and so does every link whose
// chain passes max_steps.  Bound on this card: the walk's random loads,
// two per anchor step (the run's first position and its record), which
// issue together; the links cost a coalesced pass.  Positions, sampled
// values, steps and the output are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"

namespace {

constexpr long long SA_LINK = -2;    // steps of an element sa_fill resolves
constexpr long long SA_ANCHOR = -3;  // steps of an element sa_walk resolves
constexpr int FILL_CHUNK = 32;       // bases of t per sa_fill thread

__global__ void fused_sa_pre_scan_kernel(
    const int2* __restrict__ records, const int* __restrict__ pre_tab,
    const uint8_t* __restrict__ alphas, int W, int lanes, int slots,
    int pd_run, int pd_off, const int* __restrict__ idx_in,
    const int* __restrict__ off_in, const int* __restrict__ ml_in,
    int* __restrict__ idx_out, int* __restrict__ off_out,
    int* __restrict__ ml_state_out, int* __restrict__ ml,
    int* __restrict__ pre_idx, int* __restrict__ pre_off) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    if (W > 0) {
        // step 0's record and row, and step 1's code
        int64_t row = (int64_t)idx * slots + alphas[lane];
        int2 rec = records[row];
        // (up_run, dn_run, n[up_run] - 1)
        int up_run = pre_tab[row * 3];
        int dn_run = pre_tab[row * 3 + 1];
        int up_off = pre_tab[row * 3 + 2];
        int a_next = W > 1 ? alphas[lanes + lane] : 0;
        for (int t = 0; t < W; ++t) {
            const size_t at = (size_t)t * lanes + lane;
            const int a_after = t + 2 < W ? alphas[at + 2 * (size_t)lanes]
                                          : 0;
            const movi::Step1 f = movi::decode1(rec);
            int nidx, noff;
            movi::step1(f, off, pd_run, pd_off, nidx, noff);
            m = f.match ? m + 1 : 0;
            const int cur_up = up_run, cur_dn = dn_run, cur_off = up_off;
            if (t + 1 < W) {  // step t+1's loads before step t's stores
                row = (int64_t)nidx * slots + a_next;
                rec = records[row];
                up_run = pre_tab[row * 3];
                dn_run = pre_tab[row * 3 + 1];
                up_off = pre_tab[row * 3 + 2];
                a_next = a_after;
            }
            // the carry on the match/illegal path; else the reposition
            // target before its LF: (up_run, n-1) going up, (dn_run, 0)
            // down -- from the row loaded with this step's record
            const bool down = off >= f.fb;
            ml[at] = m;
            pre_idx[at] = f.use_lf ? idx : (down ? cur_dn : cur_up);
            pre_off[at] = f.use_lf ? off : (down ? 0 : cur_off);
            idx = nidx;
            off = noff;
        }
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

__global__ void sa_mark_kernel(
    const long long* __restrict__ all_p, const long long* __restrict__ sampled,
    long long rate, const int* __restrict__ pre_idx,
    const int* __restrict__ pre_off, const int* __restrict__ ml,
    const uint8_t* __restrict__ codes, int sigma, int lanes, long long n,
    long long* __restrict__ out, long long* __restrict__ dist,
    long long* __restrict__ anchors, unsigned long long* __restrict__ count) {
    const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    bool anchor = false;
    if (i < n) {
        const long long row = all_p[pre_idx[i]] + pre_off[i];
        const long long next = i + lanes;  // step t+1 of the same lane
        if (row % rate == 0) {
            out[i] = sampled[row / rate];
            dist[i] = 0;
        } else if (next < n && (ml[next] > 0 || codes[next] == sigma)) {
            dist[i] = SA_LINK;
        } else {
            dist[i] = SA_ANCHOR;
            anchor = true;
        }
    }
    // one atomic a warp: every thread of the block reaches the ballot
    const unsigned mask = __ballot_sync(0xffffffffu, anchor);
    if (mask == 0) return;
    const int me = threadIdx.x & 31;
    const int leader = __ffs(mask) - 1;
    unsigned long long base = 0;
    if (me == leader) {
        base = atomicAdd(count, (unsigned long long)__popc(mask));
    }
    base = __shfl_sync(0xffffffffu, base, leader);
    if (anchor) anchors[base + __popc(mask & ((1u << me) - 1u))] = i;
}

__global__ void sa_walk_kernel(const int2* __restrict__ records, int slots,
                               const long long* __restrict__ all_p,
                               const long long* __restrict__ sampled,
                               long long rate, long long max_steps,
                               const int* __restrict__ idx_in,
                               const int* __restrict__ off_in,
                               const long long* __restrict__ list,
                               const unsigned long long* __restrict__ count,
                               long long* __restrict__ out,
                               long long* __restrict__ dist_out) {
    const int sigma = slots - 1;
    const long long total = (long long)*count;
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         j < total; j += stride) {
        const long long i = list[j];
        int idx = idx_in[i];
        int off = off_in[i];
        long long dist = 0;
        long long value;
        for (;;) {
            const long long first = all_p[idx];
            const int2 rec = records[(int64_t)idx * slots + sigma];
            const long long pos = first + off;
            if (pos % rate == 0) {
                value = sampled[pos / rate] + dist;
                break;
            }
            if (dist == max_steps) {  // no valid state walks this far
                value = dist = -1;
                break;
            }
            const int fa = rec.y & movi::FA_MASK;
            const int fb = (rec.y >> movi::FB_SHIFT) & movi::FB_MASK;
            const int off0 = fa + off;
            const int ff = off0 >= fb ? 1 : 0;
            idx = rec.x + ff;
            off = off0 - ff * fb;
            ++dist;
        }
        out[i] = value;
        dist_out[i] = dist;
    }
}

__global__ void sa_fill_kernel(const long long* __restrict__ dist,
                               long long* __restrict__ out, int W, int lanes,
                               int chunks, long long max_steps) {
    const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    if (tid >= (long long)chunks * lanes) return;
    const int lane = (int)(tid % lanes);
    const int s = (int)(tid / lanes) * FILL_CHUNK;
    const int e = min(s + FILL_CHUNK, W);
    // (v, d): the value and steps at t+1; -1 past max_steps.  Step W-1 is
    // never a link, so the last chunk starts from its own last element.
    long long v = -1, d = -1;
    if (e < W) {
        int k = e;  // the first element at or after e that is no link
        while (dist[(size_t)k * lanes + lane] == SA_LINK) ++k;
        const long long gap = k - e;
        d = dist[(size_t)k * lanes + lane];
        v = out[(size_t)k * lanes + lane];
        d = d < 0 || d + gap > max_steps ? -1 : d + gap;
        v = d < 0 ? -1 : v + gap;
    }
    for (int t = e - 1; t >= s; --t) {
        const size_t at = (size_t)t * lanes + lane;
        const long long dt = dist[at];
        if (dt == SA_LINK) {
            d = d < 0 || d + 1 > max_steps ? -1 : d + 1;
            v = d < 0 ? -1 : v + 1;
            out[at] = v;
        } else {
            d = dt;
            v = out[at];
        }
    }
}

}  // namespace

extern "C" int movi_fused_sa_pre_scan(
    const void* records, const void* pre_tab, const void* alphas, int W,
    int lanes, int slots, int pd_run, int pd_off, const void* idx_in,
    const void* off_in, const void* ml_in, void* idx_out, void* off_out,
    void* ml_state_out, void* ml, void* pre_idx, void* pre_off,
    void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        fused_sa_pre_scan_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int2*)records, (const int*)pre_tab, (const uint8_t*)alphas,
            W, lanes, slots, pd_run, pd_off, (const int*)idx_in,
            (const int*)off_in, (const int*)ml_in, (int*)idx_out,
            (int*)off_out, (int*)ml_state_out, (int*)ml, (int*)pre_idx,
            (int*)pre_off);
    }
    return (int)cudaGetLastError();
}

extern "C" int movi_sa_mark(const void* all_p, const void* sampled,
                            long long rate, const void* pre_idx,
                            const void* pre_off, const void* ml,
                            const void* codes, int sigma, int lanes,
                            long long n, void* out, void* dist,
                            void* anchors, void* count, void* stream) {
    if (rate <= 0) return (int)cudaErrorInvalidValue;
    const int block = 256;
    const long long grid = (n + block - 1) / block;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (grid > 0) {
        sa_mark_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const long long*)all_p, (const long long*)sampled, rate,
            (const int*)pre_idx, (const int*)pre_off, (const int*)ml,
            (const uint8_t*)codes, sigma, lanes, n, (long long*)out,
            (long long*)dist, (long long*)anchors,
            (unsigned long long*)count);
    }
    return (int)cudaGetLastError();
}

// Walk list[0..*count) (at most n), on a grid of at most 8 blocks an SM
// striding over the count it reads on the card; write each anchor's value
// into out and its steps into dist.
extern "C" int movi_sa_walk(const void* records, int slots, const void* all_p,
                            const void* sampled, long long rate,
                            long long max_steps, const void* idx,
                            const void* off, const void* list,
                            const void* count, long long n, void* out,
                            void* dist, void* stream) {
    if (rate <= 0 || list == nullptr || count == nullptr || dist == nullptr) {
        return (int)cudaErrorInvalidValue;
    }
    const int block = 256;
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long cap = 8LL * (sms > 0 ? sms : 1);
    long long grid = (n + block - 1) / block;
    grid = grid < cap ? grid : cap;
    if (grid > 0) {
        sa_walk_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const int2*)records, slots, (const long long*)all_p,
            (const long long*)sampled, rate, max_steps, (const int*)idx,
            (const int*)off, (const long long*)list,
            (const unsigned long long*)count, (long long*)out,
            (long long*)dist);
    }
    return (int)cudaGetLastError();
}

extern "C" int movi_sa_fill(const void* dist, void* out, int W, int lanes,
                            long long max_steps, void* stream) {
    const int block = 256;
    const int chunks = (W + FILL_CHUNK - 1) / FILL_CHUNK;
    const long long grid = ((long long)chunks * lanes + block - 1) / block;
    if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidConfiguration;
    if (grid > 0) {
        sa_fill_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const long long*)dist, (long long*)out, W, lanes, chunks,
            max_steps);
    }
    return (int)cudaGetLastError();
}
