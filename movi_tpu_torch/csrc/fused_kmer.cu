// Kernels 9a, 9b and 10a: k-mer membership, exact k-mer counts on the
// one-step search records, and the membership machine's batch prep.
//
// 9a replaces movi_tpu/engine/fused_kmer.py _kmer_scan (with the resume
// loop of FusedKmerEngine, fused_mem.py _resume_compacted); 9b replaces
// _kmer_count_scan; 10a replaces movi_tpu/engine/fused_mem2.py _prep_alc.
//
// Bound on this card: the latency of the dependent record loads.  A
// membership lane's ticks form one chain (each tick's rows depend on the
// previous tick's interval and cursor), and a count lane's k-1 steps
// another; the one-step search table of a real index (640 MB at five
// million runs, plus 16 MB of ftab rows at fk = 10) is past the 50 MB L2.
// Design:
//  - 9a: one thread per read lane holds the whole tick machine (phase,
//    pos, cur, pc, pok, pinit and the interval) in registers and loops
//    until its lane is done.  A done lane's tick changes nothing, so this
//    equals the TPU's lockstep scan of 2W+64-tick quanta with lanes
//    compacted between them, which exist only for XLA's static shapes.  A
//    tick loads either a step's two rows (bs_step's addressing) or one
//    ftab anchor row at 2*sigma*r + code, or nothing (anchor decisions,
//    probe restarts); the char and fk-mer code at the tick's position are
//    indexed loads from the lane's row and the emission is a plain add
//    into the lane's output row (the TPU's one-hot selects and emits are
//    not needed).  The tick budget and the state go in and out, so a run
//    split in two equals one pass; each lane reports the ticks it ran and
//    the rows it loaded.
//  - 9b: one thread per k-mer reads its k chars from the read-order int8
//    slots by (lane, start) (an int32 [k, nk] window matrix would be 13x
//    the bytes at k = 31), inits
//    from the last char and takes up to k-1 bs_steps, stopping at the
//    first empty one (its result is fixed then).
//  - 10a: one thread per (lane, position) widens the slot and, with fk,
//    writes the fk-mer code ending there (-1 where a char is illegal or
//    p < fk-1): elementwise, bound by its bytes.

#include <cuda_runtime.h>

#include <cstdint>

#include "search.cuh"

namespace {

using movi::Interval;

constexpr int ANCHOR = 0, EXTEND = 1, DONE = 2, PROBE = 3;
constexpr int NREG = 10;  // phase pos cur pc pok pinit rs os re oe

__global__ void kmer_member_kernel(
    const int4* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
    const int* __restrict__ alc, int W, int alc_w, int lanes, int r,
    int sigma, int fk, int k, long long ticks, int use_ftab,
    const int* __restrict__ st_in, int* __restrict__ st_out,
    int* __restrict__ out, int* __restrict__ work) {
    extern __shared__ int4 init_rec[];  // sigma + 1 rows
    for (int i = threadIdx.x; i <= sigma; i += blockDim.x)
        init_rec[i] = init_rec_g[i];
    __syncthreads();
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;

    int reg[NREG];
    for (int i = 0; i < NREG; ++i) reg[i] = st_in[i * lanes + lane];
    int phase = reg[0], pos = reg[1], cur = reg[2], pc = reg[3],
        pok = reg[4], pinit = reg[5];
    Interval iv{reg[6], reg[7], reg[8], reg[9]};
    const int* row = alc + (int64_t)lane * alc_w;
    int* orow = out + (int64_t)lane * W;
    const int step = k / 3;
    const int max_len = k - step;
    const int64_t ftb = 2 * (int64_t)sigma * r;

    long long t = 0;
    int rows = 0;  // 16 B record rows loaded
    for (; t < ticks && phase != DONE; ++t) {
        const bool in_anchor = phase == ANCHOR;
        const bool extending = phase == EXTEND;
        const bool probing = phase == PROBE;
        const bool pi = probing && pinit == 1;
        // anchor char at pos, probe-init char at pc, probe step at pc-1,
        // stretch step at cur-1
        const int p_sel =
            in_anchor ? pos : (probing ? (pi ? pc : pc - 1) : cur - 1);
        const int p = movi::clampi(p_sel, 0, W - 1);
        const int c = row[p];
        const int code = use_ftab ? row[W + p] : -1;

        // anchoring lanes: decide, or start a probe
        int pos1 = (in_anchor && c < 0) ? pos - 1 : pos;
        const bool legal = in_anchor && c >= 0 && pos1 >= k - 1;
        const bool eligible =
            step >= 1 && legal && pos1 >= k - 1 + step && pok == 0;
        const bool anchored = legal && !eligible;
        int pc1 = eligible ? pos1 - step : pc;
        int pinit1 = eligible ? 1 : pinit;
        int phase1 = eligible ? PROBE : (anchored ? EXTEND : phase);
        const int pok1 = anchored ? 0 : pok;
        int cur1 = anchored ? pos1 : cur;
        if (phase1 == ANCHOR && pos1 < k - 1) phase1 = DONE;

        // the tick's rows: a step's two, one ftab anchor row, or none
        const bool can_step = extending && cur1 > 0;
        const bool can_pstep = probing && !pi && pc1 > 0;
        const int a_gate = (can_step || can_pstep) ? c : -1;
        const bool code_ok = code >= 0;
        const bool ftl = use_ftab && (anchored || pi) && code_ok;
        bool empty = true;
        Interval nxt{0, 0, 0, 0};
        int4 frow{0, 0, 0, 0};
        if (ftl) {
            frow = rec_all[ftb + code];
            rows += 1;
        } else if (a_gate >= 0) {
            empty = movi::bs_step(rec_all, r, sigma, iv, a_gate, nxt);
            rows += 2;
        }

        // interval init: the ftab row, or the char's init row
        const Interval ini = movi::init_interval(init_rec, c);
        bool pi_fail;
        if (use_ftab) {
            const bool f_empty = !(frow.x < frow.z ||
                                   (frow.x == frow.z && frow.y <= frow.w));
            const bool a_hit = anchored && code_ok && !f_empty;
            const bool a_miss = anchored && code_ok && f_empty;
            const bool a_plain = anchored && !code_ok;
            const bool p_hit = pi && code_ok && !f_empty;
            const bool p_missf = pi && code_ok && f_empty;  // fails at once
            const bool p_plain = pi && !code_ok && c >= 0;
            if (a_hit || p_hit) {
                iv = movi::interval_of(frow);
            } else if (a_plain || p_plain) {
                iv = ini;
            }
            // a stretch hit jumps the cursor; a miss advances the anchor
            if (a_hit) cur1 = pos1 - fk + 1;
            if (a_miss) {
                pos1 -= 1;
                phase1 = pos1 >= k - 1 ? ANCHOR : DONE;
            }
            if (p_hit) pc1 -= fk - 1;
            if (p_hit || p_plain) pinit1 = 0;
            pi_fail = (pi && c < 0) || p_missf;
        } else {
            if (anchored || (pi && c >= 0)) iv = ini;
            if (pi && c >= 0) pinit1 = 0;
            pi_fail = pi && c < 0;
        }

        // commit the step
        const bool step_ok = can_step && !empty;
        const bool pstep_ok = can_pstep && !empty;
        if (step_ok || pstep_ok) iv = nxt;
        const int cur2 = step_ok ? cur1 - 1 : cur1;
        const int pc2 = pstep_ok ? pc1 - 1 : pc1;

        // probe termination (the look-ahead's backward search loop)
        const int plen = (pos1 - step) - pc2;
        const bool probe_end =
            (probing && !pi &&
             (!can_pstep || empty || (pstep_ok && plen > max_len))) ||
            pi_fail;
        const bool passed = pos1 - pc2 >= k - 1;
        pok = (probe_end && passed) ? 1 : pok1;
        int pos2 = (probe_end && !passed) ? pos1 - step - 1 : pos1;
        int phase2 = probe_end ? ANCHOR : phase1;
        if (probe_end && !passed && pos2 < k - 1) phase2 = DONE;

        // a stretch ends at a failed step or at position 0
        if (extending && !step_ok) {
            const int matched = pos1 - cur2;
            const bool emit = matched >= k - 1;
            if (emit) orow[movi::clampi(cur2, 0, W - 1)] += matched - k + 2;
            // the new anchor: cur + k - 2 after a success, pos - 1 else
            pos2 = emit ? cur2 + k - 2 : pos1 - 1;
            phase2 = pos2 >= k - 1 ? ANCHOR : DONE;
        }
        phase = phase2;
        pos = pos2;
        cur = cur2;
        pc = pc2;
        pinit = pinit1;
    }
    const int fin[NREG] = {phase, pos, cur, pc, pok, pinit,
                           iv.rs, iv.os, iv.re, iv.oe};
    for (int i = 0; i < NREG; ++i) st_out[i * lanes + lane] = fin[i];
    work[lane] = (int)t;
    work[lanes + lane] = rows;
}

__global__ void kmer_count_kernel(
    const int4* __restrict__ rec_all, const int4* __restrict__ init_rec_g,
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
    const int8_t* w = slots + (int64_t)lane_of[i] * W + start_of[i];
    bool dead = false;
    for (int j = 0; j < k; ++j) dead |= w[j] < 0;
    Interval iv = movi::init_interval(init_rec, w[k - 1]);
    // extend with kmer[k-2] ... kmer[0]; a dead lane's result is fixed
    for (int j = k - 2; j >= 0 && !dead; --j) {
        Interval nxt;
        if (movi::bs_step(rec_all, r, sigma, iv, w[j], nxt)) {
            dead = true;
        } else {
            iv = nxt;
        }
    }
    found_out[i] = dead ? 0 : 1;
    cnt_out[i] = movi::interval_count(all_p, r, iv, dead ? 0 : 1);
}

__global__ void prep_alc_kernel(const int8_t* __restrict__ slots, int lanes,
                                int W, int fk, int* __restrict__ out) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= (int64_t)lanes * W) return;
    const int64_t lane = i / W;
    const int p = (int)(i - lane * W);
    const int8_t* row = slots + lane * W;
    int* orow = out + lane * (fk ? 2 * (int64_t)W : W);
    orow[p] = row[p];
    if (fk) {
        int code = 0;
        bool ok = p >= fk - 1;
        for (int j = 0; j < fk; ++j) {
            const int q = p - (fk - 1 - j);
            const int a = q >= 0 ? row[q] : -1;
            code = code * 4 + (a > 0 ? a : 0);
            ok = ok && a >= 0;
        }
        orow[W + p] = ok ? code : -1;
    }
}

}  // namespace

// Kernel 9a.  alc is int32 [lanes, alc_w]: the read-order slots, followed
// with use_ftab by the fk-mer codes (alc_w = 2W).  st_in/st_out are int32
// [10, lanes]; out is int32 [lanes, W], added to in place; work int32
// [2, lanes] gets each lane's ticks and the record rows it loaded.
extern "C" int movi_kmer_member_scan(
    const void* rec_all, const void* init_rec, const void* alc, int W,
    int alc_w, int lanes, int r, int sigma, int fk, int k, long long ticks,
    int use_ftab, const void* st_in, void* st_out, void* out, void* work,
    void* stream) {
    const int block = 128;
    const int grid = (lanes + block - 1) / block;
    if (grid > 0) {
        kmer_member_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                             (cudaStream_t)stream>>>(
            (const int4*)rec_all, (const int4*)init_rec, (const int*)alc, W,
            alc_w, lanes, r, sigma, fk, k, ticks, use_ftab,
            (const int*)st_in, (int*)st_out, (int*)out, (int*)work);
    }
    return (int)cudaGetLastError();
}

// Kernel 9b.  slots int8 [lanes, W]; the k-mer i starts at
// (lane_of[i], start_of[i]) with start_of[i] <= W - k.
extern "C" int movi_kmer_count_scan(const void* rec_all, const void* init_rec,
                                    const void* all_p, const void* slots,
                                    int W, const void* lane_of,
                                    const void* start_of, int nk, int r,
                                    int sigma, int k, void* found,
                                    void* cnt, void* stream) {
    const int block = 256;
    const int grid = (nk + block - 1) / block;
    if (grid > 0) {
        kmer_count_kernel<<<grid, block, (size_t)(sigma + 1) * sizeof(int4),
                            (cudaStream_t)stream>>>(
            (const int4*)rec_all, (const int4*)init_rec, (const int*)all_p,
            (const int8_t*)slots, W, (const int*)lane_of,
            (const int*)start_of, nk, r, sigma, k, (uint8_t*)found,
            (int*)cnt);
    }
    return (int)cudaGetLastError();
}

// Kernel 10a.  slots int8 [lanes, W] -> out int32 [lanes, W] (fk = 0) or
// [lanes, 2W].
extern "C" int movi_prep_alc(const void* slots, int lanes, int W, int fk,
                             void* out, void* stream) {
    const int block = 256;
    const long long n = (long long)lanes * W;
    const long long grid = (n + block - 1) / block;
    if (grid > 0) {
        prep_alc_kernel<<<(unsigned)grid, block, 0, (cudaStream_t)stream>>>(
            (const int8_t*)slots, lanes, W, fk, (int*)out);
    }
    return (int)cudaGetLastError();
}
