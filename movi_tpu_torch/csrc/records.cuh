// Step-record bit layouts shared by the PML kernels.
//
// One-step records (movi_tpu/engine/fused.py): int2 per (run, slot),
//   x: main run id m (LF destination, or the reposition anchor run)
//   y: fa (0-11) | fb (12-23) | bump (24) | match (25) | use_lf (26)
//      | dollar_up (27) | dollar_dn (28)
// Paired records (movi_tpu/engine/fused2.py): int4 per (run, a1, a2),
//   x: T1+4096 (0-12) | match1 (13) | A_lo>>16 (14-22) | A_hi>>16 (23-31)
//   y: B_lo+4096 (0-12) | C_lo (13-24) | kind_lo (25-26) | flags_lo (27-29)
//   z: the same fields for the hi branch
//   w: A_lo & 0xFFFF (0-15) | A_hi & 0xFFFF (16-31)
// Bit 31 of x is used, so paired words are decoded from uint32.
#pragma once

#include <cstdint>

namespace movi {

constexpr int FA_MASK = 0xFFF;
constexpr int FB_SHIFT = 12;
constexpr int FB_MASK = 0xFFF;
constexpr int BIT_BUMP = 24;
constexpr int BIT_MATCH = 25;
constexpr int BIT_USE_LF = 26;
constexpr int BIT_DOLLAR_UP = 27;
constexpr int BIT_DOLLAR_DN = 28;

constexpr int BIAS = 4096;  // 13-bit biased signed fields (T1, B)
constexpr int KIND_LF2 = 0;
constexpr int KIND_MIS2 = 1;
constexpr int KIND_CONST = 2;

// One-step record fields.
struct Step1 {
    int m, fa, fb, bump, match, use_lf, d_up, d_dn;
};

__device__ __forceinline__ Step1 decode1(int2 rec) {
    const int w1 = rec.y;
    Step1 f;
    f.m = rec.x;
    f.fa = w1 & FA_MASK;
    f.fb = (w1 >> FB_SHIFT) & FB_MASK;
    f.bump = (w1 >> BIT_BUMP) & 1;
    f.match = (w1 >> BIT_MATCH) & 1;
    f.use_lf = (w1 >> BIT_USE_LF) & 1;
    f.d_up = (w1 >> BIT_DOLLAR_UP) & 1;
    f.d_dn = (w1 >> BIT_DOLLAR_DN) & 1;
    return f;
}

// The one-step PML transition (fused_step_math) from state (idx, off)
// under record fields f: writes the next (idx, off).  Either LF with a
// bounded fast-forward, or a reposition to the anchor, anchor+1 or P$.
__device__ __forceinline__ void step1(const Step1& f, int offset,
                                      int pd_run, int pd_off,
                                      int& new_idx, int& new_off) {
    if (f.use_lf) {
        const int off0 = f.fa + offset;
        const int ff = off0 >= f.fb ? 1 : 0;
        new_idx = f.m + ff;
        new_off = off0 - ff * f.fb;
    } else if (offset >= f.fb) {
        new_idx = f.d_dn ? pd_run : f.m + f.bump;
        new_off = f.d_dn ? pd_off : (f.bump ? 0 : f.fa + 1);
    } else {
        new_idx = f.d_up ? pd_run : f.m;
        new_off = f.d_up ? pd_off : f.fa;
    }
}

// One paired step decoded from the first four words of a paired record
// (fused2.py _fused2_decode): the next state, both bases' match bits, and
// the selectors the color words read (the branch bit hi, the LF2
// fast-forward ff, the MIS2 direction down, the kind).
struct PairStep {
    int nidx, noff, match1, match2, kind;
    bool hi, ff, down;
};

__device__ __forceinline__ PairStep decode_pair(int4 rec, int off,
                                                int pd_run, int pd_off) {
    const uint32_t w0 = (uint32_t)rec.x;
    const uint32_t w3 = (uint32_t)rec.w;
    const int T1 = (int)(w0 & 0x1FFFu) - BIAS;
    PairStep d;
    d.match1 = (int)((w0 >> 13) & 1u);
    d.hi = off >= T1;
    const uint32_t wb = (uint32_t)(d.hi ? rec.z : rec.y);
    const int A = d.hi ? (int)(((w3 >> 16) & 0xFFFFu)
                               | (((w0 >> 23) & 0x1FFu) << 16))
                       : (int)((w3 & 0xFFFFu)
                               | (((w0 >> 14) & 0x1FFu) << 16));
    const int B = (int)(wb & 0x1FFFu) - BIAS;
    const int C = (int)((wb >> 13) & 0xFFFu);
    d.kind = (int)((wb >> 25) & 3u);
    const int flags = (int)((wb >> 27) & 7u);
    const int off0 = B + off;
    d.ff = off0 >= C;
    d.down = off >= B;
    if (d.kind == KIND_LF2) {
        d.nidx = A + (d.ff ? 1 : 0);
        d.noff = d.ff ? off0 - C : off0;
    } else if (d.kind == KIND_MIS2) {
        const int bump = flags & 1;
        const int d_up = (flags >> 1) & 1;
        const int d_dn = (flags >> 2) & 1;
        if (d.down) {
            d.nidx = d_dn ? pd_run : A + bump;
            d.noff = d_dn ? pd_off : (bump ? 0 : C + 1);
        } else {
            d.nidx = d_up ? pd_run : A;
            d.noff = d_up ? pd_off : C;
        }
    } else {
        d.nidx = A;
        d.noff = C;
    }
    d.match2 = d.kind == KIND_MIS2 ? 0 : (flags & 1);
    return d;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
    return x < lo ? lo : (x > hi ? hi : x);
}

}  // namespace movi
