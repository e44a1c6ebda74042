// The early-stop rule of Movi Color (--early-stop,
// read_processor.cpp:240-250) as the JAX package's host rule states it
// (engine/fused_color.py _early_stop_len): after emitting the PML of
// global base step t of a read of length L, with csum the running PML sum
// through t, the read stops when p1 = L-2-t is a checkpoint (p1 >= 0,
// 2*p1 < L, p1 % 100 == 0) and 5*csum < 2*(L-p1).  csum is 64-bit: a
// 32-bit sum wraps on long exact-match reads and would stop them early.
#pragma once

namespace movi {

__device__ __forceinline__ bool es_hit(long long csum, int t, int L) {
    const int p1 = L - 2 - t;
    return p1 >= 0 && 2 * p1 < L && p1 % 100 == 0
           && 5 * csum < 2 * (long long)(L - p1);
}

}  // namespace movi
