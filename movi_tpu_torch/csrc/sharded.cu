// Kernels 15a and 15b: the steps of the model-sharded record scans.
//
// Replace movi_tpu/parallel/sharded_index.py sharded_fused_pml (15a) and
// _sharded_search_scan (15b, count and ZML).  There the record table is
// split into `model` row ranges; every step each shard gathers the rows it
// owns (keys clamped into its range, the rest zeroed) and a psum over the
// 'model' axis gives every shard the whole record before the step math.
//
// Here one launch per step does both halves around that all-reduce: it
// applies the step whose summed records it is given (the PML or search
// step math, writing that step's outputs and updating the lane's state in
// place), then gathers this shard's masked rows for the next step's keys.
// The host loop between launches is `torch.distributed.all_reduce` over the
// model group, so a scan of W steps is W+1 launches (PML) or W (search)
// and W all-reduces (W-1 for search).
//
// Bound on this card: launches and collectives, not bytes.  A step moves
// one 8 B record (PML) or two 16 B records (search) per lane; its time is
// the launch, the all-reduce and one dependent load.  Design: one thread
// per lane, state rows int32 [k, lanes] in device memory between launches
// (read and written coalesced), the keys in 64 bits (key - lo never wraps
// a shard's int32 row range), the first-char search init read from
// init_rec by index (no one-hot).

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"
#include "search.cuh"

namespace {

__device__ __forceinline__ bool owned_row(int64_t key, int64_t lo,
                                          int64_t shard_len, int64_t& local) {
    local = key - lo;
    return local >= 0 && local < shard_len;
}

// 15a.  state rows (idx, off, ml); rec_in, if given, holds step t-1's
// summed records; step t < W gathers into rec_out.
__global__ void sharded_pml_step_kernel(
    const int2* __restrict__ local_rec, int64_t lo, int64_t shard_len,
    int slots, int pd_run, int pd_off, const uint8_t* __restrict__ codes,
    int W, int lanes, int t, const int2* __restrict__ rec_in,
    int* __restrict__ state, int* __restrict__ ml,
    int2* __restrict__ rec_out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    int idx = state[lane];
    if (rec_in != nullptr) {
        const movi::Step1 f = movi::decode1(rec_in[lane]);
        int nidx, noff;
        movi::step1(f, state[lanes + lane], pd_run, pd_off, nidx, noff);
        const int m = f.match ? state[2 * lanes + lane] + 1 : 0;
        idx = nidx;
        state[lane] = nidx;
        state[lanes + lane] = noff;
        state[2 * lanes + lane] = m;
        ml[(size_t)(t - 1) * lanes + lane] = m;
    }
    if (t < W) {
        const int a = codes[(size_t)t * lanes + lane];
        int64_t local;
        rec_out[lane] = owned_row((int64_t)idx * slots + a, lo, shard_len,
                                  local)
                            ? local_rec[local]
                            : make_int2(0, 0);
    }
}

// 15b.  state rows (rs, os, re, oe) + (matched, done) for count or (have,
// ml) for ZML; step 0 starts every lane from its first char (init_rec by
// index); step t >= 1 applies the summed records of chars[t]; then the
// down and up rows of chars[t+1] are gathered into rec_out [2, lanes].
// ZML emits row t-1 before step t's update and row W-1 after the last.
template <bool ZML>
__global__ void sharded_search_step_kernel(
    const int4* __restrict__ local_rec, int64_t lo, int64_t shard_len,
    int r, int sigma, const int4* __restrict__ init_rec,
    const int8_t* __restrict__ chars, int W, int lanes, int t,
    const int4* __restrict__ rec_in, int* __restrict__ state,
    int* __restrict__ ml, int4* __restrict__ rec_out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    using movi::Interval;
    Interval cur;
    int x, y;
    if (t == 0) {
        const int a0 = chars[lane];
        cur = movi::init_interval(init_rec, a0);
        x = a0 >= 0 ? 1 : 0;
        y = ZML ? 0 : 1 - x;
    } else {
        cur = Interval{state[movi::ST_RS * lanes + lane],
                       state[movi::ST_OS * lanes + lane],
                       state[movi::ST_RE * lanes + lane],
                       state[movi::ST_OE * lanes + lane]};
        x = state[movi::ST_X * lanes + lane];
        y = state[movi::ST_Y * lanes + lane];
        const int a = chars[(size_t)t * lanes + lane];
        const int4 rd = rec_in[lane];
        const int4 ru = rec_in[lanes + lane];
        const bool empty = a < 0 || rd.x >= r || rd.x > cur.re;
        const int os1 = rd.x != cur.rs ? 0 : cur.os;
        const int oe1 = ru.x != cur.re ? ru.w - 1 : cur.oe;
        Interval nxt;
        movi::lf_from_rec(rd, os1, nxt.rs, nxt.os);
        movi::lf_from_rec(ru, oe1, nxt.re, nxt.oe);
        if (ZML) {
            ml[(size_t)(t - 1) * lanes + lane] = x ? y : 0;
            const bool ext_ok = x && !empty;
            cur = ext_ok ? nxt : movi::init_interval(init_rec, a);
            y = ext_ok ? y + 1 : 0;
            x = (ext_ok || a >= 0) ? 1 : 0;
        } else {
            const bool alive = !y;
            const bool ok = alive && !empty;
            if (ok) cur = nxt;
            x += ok ? 1 : 0;
            y = (y || (alive && empty)) ? 1 : 0;
        }
    }
    state[movi::ST_RS * lanes + lane] = cur.rs;
    state[movi::ST_OS * lanes + lane] = cur.os;
    state[movi::ST_RE * lanes + lane] = cur.re;
    state[movi::ST_OE * lanes + lane] = cur.oe;
    state[movi::ST_X * lanes + lane] = x;
    state[movi::ST_Y * lanes + lane] = y;
    if (t + 1 < W) {
        const int a = chars[(size_t)(t + 1) * lanes + lane];
        const int64_t a_s = a > 0 ? a : 0;
        int64_t local;
        const int64_t key_d = a_s * r + movi::clampi(cur.rs, 0, r - 1);
        const int64_t key_u =
            (sigma + a_s) * r + movi::clampi(cur.re, 0, r - 1);
        const int4 zero = make_int4(0, 0, 0, 0);
        rec_out[lane] =
            owned_row(key_d, lo, shard_len, local) ? local_rec[local] : zero;
        rec_out[lanes + lane] =
            owned_row(key_u, lo, shard_len, local) ? local_rec[local] : zero;
    } else if (ZML) {
        ml[(size_t)(W - 1) * lanes + lane] = x ? y : 0;
    }
}

}  // namespace

extern "C" int movi_sharded_pml_step(
    const void* local_rec, long long lo, long long shard_len, int slots,
    int pd_run, int pd_off, const void* codes, int W, int lanes, int t,
    const void* rec_in, void* state, void* ml, void* rec_out,
    void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        sharded_pml_step_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int2*)local_rec, lo, shard_len, slots, pd_run, pd_off,
            (const uint8_t*)codes, W, lanes, t, (const int2*)rec_in,
            (int*)state, (int*)ml, (int2*)rec_out);
    }
    return (int)cudaGetLastError();
}

extern "C" int movi_sharded_search_step(
    const void* local_rec, long long lo, long long shard_len, int r,
    int sigma, const void* init_rec, const void* chars, int W, int lanes,
    int t, int zml, const void* rec_in, void* state, void* ml, void* rec_out,
    void* stream) {
    const int block = 256;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        auto k = zml ? sharded_search_step_kernel<true>
                     : sharded_search_step_kernel<false>;
        k<<<grid, block, 0, (cudaStream_t)stream>>>(
            (const int4*)local_rec, lo, shard_len, r, sigma,
            (const int4*)init_rec, (const int8_t*)chars, W, lanes, t,
            (const int4*)rec_in, (int*)state, (int*)ml, (int4*)rec_out);
    }
    return (int)cudaGetLastError();
}
