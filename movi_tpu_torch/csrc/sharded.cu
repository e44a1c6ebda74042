// Kernels 15a and 15b: the model-sharded record scans.
//
// Replace movi_tpu/parallel/sharded_index.py sharded_fused_pml (15a) and
// _sharded_search_scan (15b, count and ZML).  There the record table is
// split into `model` row ranges; every step each shard gathers the rows it
// owns (keys clamped into its range, the rest zeroed) and a psum over the
// 'model' axis gives every shard the whole record before the step math.
//
// Two routes, chosen from the mesh before any launch
// (parallel/sharded_index.py).
//
// The scans (sharded_pml_scan_kernel, sharded_search_scan_kernel), where
// every rank of a model group is on one host.  Every rank of a group holds
// the same lanes and, step after step, the same state, so it already knows
// every key its lanes will ask for: the all-reduce only carried each row
// from the rank that owns it.  Each rank maps its peers' shards into its
// address space once (CUDA IPC; on one card that is plain device memory,
// across cards NVLink serves the loads) and passes every shard's address,
// in model order.  A lane then reads the row of key k from shard
// k / shard_len, row k - owner * shard_len, where it lies, and a scan is
// one launch with no collective.  Bound on this card: the latency of one
// dependent 8 B (PML) or two 16 B (search) row loads per base per lane, as
// kernels 1 and 6, whose designs these follow: one thread per lane, the
// state in registers and the loop over the bases inside the kernel; each
// code loaded two steps ahead from a clamped address; a step's rows issued
// as soon as the step before has given their keys, and the stores after
// that issue; a batch with no more lanes than SMs spread one lane a warp
// (spread.cuh).  The owner is found by compares against the shard bounds
// (no 64-bit divide on the chain) from the shard addresses, which each
// block loads once into shared memory; a one-shard table skips both.  A
// key past the last shard reads zeros, as in the step route, where no
// shard owns it.  State comes in and goes out, so a scan split into pieces
// equals one pass.
//
// The steps (sharded_pml_step_kernel, sharded_search_step_kernel), where a
// model group spans hosts.  One launch per step does both halves around
// the all-reduce: it applies the step whose summed records it is given
// (the PML or search step math, writing that step's outputs and updating
// the lane's state in place), then gathers this shard's masked rows for
// the next step's keys.  The host loop between launches is
// `torch.distributed.all_reduce` over the model group, so a scan of W steps
// is W+1 launches (PML) or W (search) and W all-reduces (W-1 for search):
// launch- and collective-bound by design.  Design: one thread per lane,
// state rows int32 [k, lanes] in device memory between launches (read and
// written coalesced), the keys in 64 bits (key - lo never wraps a shard's
// int32 row range), the first-char search init read from init_rec by index
// (no one-hot).

#include <cuda_runtime.h>

#include <cstdint>

#include "records.cuh"
#include "search.cuh"
#include "spread.cuh"

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

// The rows of a table split into `model` shards of `len` rows each, the
// shards' addresses in shared memory in model order (ONE: a single shard,
// its address in a register).
template <typename T, bool ONE>
struct ShardRows {
    const uintptr_t* base;
    const T* first;
    int model;
    int64_t len, total;

    // The row of `key`, and in: whether a shard holds it (a key past the
    // last shard reads shard 0's first row, which the caller zeroes).  A
    // single shard is this rank's own memory and is read through the
    // read-only cache; several may lie on other cards, and are read with
    // plain loads.
    __device__ __forceinline__ T load(int64_t key, bool& in) const {
        in = (uint64_t)key < (uint64_t)total;
        const int64_t k = in ? key : 0;
        if (ONE) return __ldg(first + k);
        int m = 0;
        for (int j = 1; j < model; ++j) m += k >= (int64_t)j * len ? 1 : 0;
        return reinterpret_cast<const T*>(base[m])[k - (int64_t)m * len];
    }
};

// 15a, the scan.  Kernel 1's loop (fused_pml.cu) on the shards.
template <bool ONE>
__global__ void sharded_pml_scan_kernel(
    const uintptr_t* __restrict__ shards, int model, int64_t shard_len,
    const uint8_t* __restrict__ alphas, int W, int lanes, int slots,
    int pd_run, int pd_off, const int* __restrict__ idx_in,
    const int* __restrict__ off_in, const int* __restrict__ ml_in,
    int* __restrict__ idx_out, int* __restrict__ off_out,
    int* __restrict__ ml_state_out, int* __restrict__ ml, int lpw) {
    extern __shared__ uintptr_t pml_shards[];
    for (int i = threadIdx.x; i < model; i += blockDim.x)
        pml_shards[i] = shards[i];
    __syncthreads();
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    const ShardRows<int2, ONE> tab{
        pml_shards, reinterpret_cast<const int2*>(pml_shards[0]), model,
        shard_len, (int64_t)model * shard_len};
    int idx = idx_in[lane];
    int off = off_in[lane];
    int m = ml_in[lane];
    if (W > 0) {
        // the first step's record, and the next step's code
        const size_t lanes_s = (size_t)lanes;
        bool in;
        int2 rec = tab.load((int64_t)idx * slots + alphas[lane], in);
        int a_next = alphas[(W > 1 ? lanes_s : 0) + lane];
        for (int t = 0; t < W; ++t) {
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's record is in flight: the code two steps on
            const int a_after =
                alphas[(size_t)min(t + 2, W - 1) * lanes_s + lane];
            const movi::Step1 f = movi::decode1(in ? rec : make_int2(0, 0));
            movi::step1(f, off, pd_run, pd_off, idx, off);
            m = f.match ? m + 1 : 0;
            // the next step's record: the chain's only load
            if (t + 1 < W) rec = tab.load((int64_t)idx * slots + a_next, in);
            ml[at] = m;
            a_next = a_after;
        }
    }
    idx_out[lane] = idx;
    off_out[lane] = off;
    ml_state_out[lane] = m;
}

// A step's down and up rows, and whether a shard holds each.
struct ShardStepRows {
    int4 rd, ru;
    bool din, uin;
};

template <bool ONE>
__device__ __forceinline__ ShardStepRows shard_step_rows(
    const ShardRows<int4, ONE>& tab, int r, int sigma,
    const movi::Interval& cur, int a) {
    const int64_t a_s = a > 0 ? a : 0;
    ShardStepRows s;
    s.rd = tab.load(a_s * r + movi::clampi(cur.rs, 0, r - 1), s.din);
    s.ru = tab.load((sigma + a_s) * r + movi::clampi(cur.re, 0, r - 1),
                    s.uin);
    return s;
}

// 15b, the scan.  Kernel 6's loop (fused_search.cu) on the shards, with
// the state rows of the step kernel: (rs, os, re, oe) + (matched, done)
// for count or (have, ml) for ZML.  `first` starts every lane from row 0
// of chars (init_rec by index) and ZML's row 0 is 0; otherwise the scan
// continues from st_in.  ZML's row t is the match length after char t.
template <bool ZML, bool ONE>
__global__ void sharded_search_scan_kernel(
    const uintptr_t* __restrict__ shards, int model, int64_t shard_len,
    const int4* __restrict__ init_rec_g, const int8_t* __restrict__ chars,
    int W, int lanes, int r, int sigma, int first,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ ml_out, int lpw) {
    extern __shared__ int4 search_smem[];  // sigma + 1 init rows, shards
    int4* init_rec = search_smem;
    uintptr_t* base = reinterpret_cast<uintptr_t*>(search_smem + sigma + 1);
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    for (int i = threadIdx.x; i < model; i += blockDim.x) base[i] = shards[i];
    __syncthreads();
    const int lane = movi::spread_lane(lpw);
    if (lane < 0 || lane >= lanes) return;
    const ShardRows<int4, ONE> tab{
        base, reinterpret_cast<const int4*>(base[0]), model, shard_len,
        (int64_t)model * shard_len};

    using movi::Interval;
    Interval cur;
    int x, y;
    int t0 = 0;
    if (first) {
        const int a0 = chars[lane];
        cur = movi::init_interval(init_rec, a0);
        x = a0 >= 0 ? 1 : 0;
        y = ZML ? 0 : 1 - x;
        if (ZML) ml_out[lane] = 0;
        t0 = 1;
    } else {
        cur = Interval{st_in[movi::ST_RS * lanes + lane],
                       st_in[movi::ST_OS * lanes + lane],
                       st_in[movi::ST_RE * lanes + lane],
                       st_in[movi::ST_OE * lanes + lane]};
        x = st_in[movi::ST_X * lanes + lane];
        y = st_in[movi::ST_Y * lanes + lane];
    }
    // 0, but not to the compiler: keeps the down row's unread word live
    // until the row lands (fused_search.cu)
    const int keep = W >> 31;
    int sink = 0;
    if (t0 < W) {
        const size_t lanes_s = (size_t)lanes;
        int a = chars[t0 * lanes_s + lane];
        int a_next = chars[(size_t)min(t0 + 1, W - 1) * lanes_s + lane];
        ShardStepRows rows{};
        if (ZML || !y) rows = shard_step_rows(tab, r, sigma, cur, a);
        for (int t = t0; t < W; ++t) {
            if (!ZML && y) break;  // done: the count never changes again
            const size_t at = (size_t)t * lanes_s + lane;
            // while this step's rows are in flight: the char two steps on
            // and the failure outcome's interval
            const int a_after =
                chars[(size_t)min(t + 2, W - 1) * lanes_s + lane];
            const Interval ini = movi::init_interval(init_rec, a);
            const int4 zero = make_int4(0, 0, 0, 0);
            const movi::StepRows got{rows.din ? rows.rd : zero,
                                     rows.uin ? rows.ru : zero};
            Interval nxt;
            const bool empty = movi::step_decode(got, r, cur, a, nxt);
            sink |= rows.rd.w & keep;
            int ml = 0;
            if (ZML) {
                const bool ext_ok = x && !empty;
                cur = ext_ok ? nxt : ini;
                y = ext_ok ? y + 1 : 0;
                x = ext_ok || a >= 0;
                ml = x ? y : 0;
            } else if (empty) {
                y = 1;
            } else {
                cur = nxt;
                x += 1;
            }
            // the next step's rows: the chain's only loads
            if (t + 1 < W && (ZML || !y))
                rows = shard_step_rows(tab, r, sigma, cur, a_next);
            if (ZML) ml_out[at] = ml;
            a = a_next;
            a_next = a_after;
        }
    }
    st_out[movi::ST_RS * lanes + lane] = cur.rs;
    st_out[movi::ST_OS * lanes + lane] = cur.os;
    st_out[movi::ST_RE * lanes + lane] = cur.re;
    st_out[movi::ST_OE * lanes + lane] = cur.oe;
    st_out[movi::ST_X * lanes + lane] = x + sink;
    st_out[movi::ST_Y * lanes + lane] = y;
}

}  // namespace

extern "C" int movi_sharded_pml_scan(
    const void* shards, int model, long long shard_len, const void* codes,
    int W, int lanes, int slots, int pd_run, int pd_off, const void* idx_in,
    const void* off_in, const void* ml_in, void* idx_out, void* off_out,
    void* ml_state_out, void* ml, void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        auto k = model == 1 ? sharded_pml_scan_kernel<true>
                            : sharded_pml_scan_kernel<false>;
        k<<<s.grid, s.block, (size_t)model * sizeof(uintptr_t),
            (cudaStream_t)stream>>>(
            (const uintptr_t*)shards, model, shard_len,
            (const uint8_t*)codes, W, lanes, slots, pd_run, pd_off,
            (const int*)idx_in, (const int*)off_in, (const int*)ml_in,
            (int*)idx_out, (int*)off_out, (int*)ml_state_out, (int*)ml,
            s.lpw);
    }
    return (int)cudaGetLastError();
}

extern "C" int movi_sharded_search_scan(
    const void* shards, int model, long long shard_len, int r, int sigma,
    const void* init_rec, const void* chars, int W, int lanes, int first,
    int zml, const void* st_in, void* st_out, void* ml, void* stream) {
    movi::Spread s;
    const cudaError_t e = movi::spread(lanes, 256, &s);
    if (e != cudaSuccess) return (int)e;
    if (lanes > 0) {
        auto k = zml ? (model == 1 ? sharded_search_scan_kernel<true, true>
                                   : sharded_search_scan_kernel<true, false>)
                     : (model == 1 ? sharded_search_scan_kernel<false, true>
                                   : sharded_search_scan_kernel<false, false>);
        const size_t smem = (size_t)(sigma + 1) * sizeof(int4) +
                            (size_t)model * sizeof(uintptr_t);
        k<<<s.grid, s.block, smem, (cudaStream_t)stream>>>(
            (const uintptr_t*)shards, model, shard_len, (const int4*)init_rec,
            (const int8_t*)chars, W, lanes, r, sigma, first,
            (const int*)st_in, (int*)st_out, (int*)ml, s.lpw);
    }
    return (int)cudaGetLastError();
}

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
