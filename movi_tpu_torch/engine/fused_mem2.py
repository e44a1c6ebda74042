"""MEM v2: the combined 32 B record table, its step helpers, and the two
MEM tick machines (BML with ftab anchors; all-MEMs).

Port of movi_tpu/engine/fused_mem2.py.  One table holds, per (char, run),
a "down" and an "up" record (dest, LF id, cum1 | off << 16, n,
all_p[id], P_t, U_t), then one pos2rba row per BWT position (run,
all_p[run]), then, with ftab_k > 1, one anchor row per fk-mer.  A
backward step loads two rows; the bidirectional skip (P_t, U_t at
t = comp(char)) and the stepped endpoint's absolute position come with
them, so the companion interval is carried in absolute coordinates and
resolved to (run, offset) through the pos2rba rows once per window.

The ftab anchor rows are built with rc_merge=False: the JAX package's
rc_merge=True drops MEMs of reads that span a document junction of a
reference without separators (ROADMAP §3.1), and the scalar oracle keeps
them.  Every other row is byte-identical to the JAX builder's.  The
machines count a '#' inside a read toward the read's length, as the
oracle does; the JAX machines drop it (ROADMAP §3.6).

The two machines (`mem2_scan`, `all_mem2_scan`) run the hand-written CUDA
kernels of csrc/fused_mem2.cu on CUDA tensors and the plain PyTorch
versions below on CPU tensors.  The plain versions keep the JAX scans'
lockstep form (`ticks` ticks over [lanes, W(+W)]) and stop early once
every lane is done; a kernel thread loops until its lane is done.  A done
lane's tick changes nothing, so both equal the JAX package's quanta with
lane compaction, and a run split at any tick equals one pass.  A lane
that comes in at phase ENTRY (entry_state) gets its start state from its
slots inside the machine: the JAX engines' make_mem2_state and jitted
all-MEMs make_state.  A lane
still running past the JAX budget (W quanta of 2W+84 ticks for BML, of
4W+64 for all-MEMs) is an error, not a partial answer.

This module also keeps the k-mer engines' builders and read prep:
`build_ftab_rows`, `looks_rc_closed`, `MEM2_MAX_N` and `prep_alc`
(kernel 10a).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import kernels
from ..cpu_ref.native_search import build_skip_tables
from ..device import DeviceLike, resolve_device
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch, left_aligned_slots

_GUARD = 0xFFFF

# BML phases
INIT, BACK, RESOLVE, FWD, NEXT, DONE, BSCAN = 0, 1, 2, 3, 4, 5, 6
# all-MEMs phases
AM2_RIGHT, AM2_LEFT, AM2_RES, AM2_DONE = 0, 1, 2, 3
# a lane whose machine has yet to build its start state (entry_state)
ENTRY = -1
# the machines' per-lane registers, in the kernels' row order
MEM2_STATE_KEYS = kernels.MEM2_STATE_KEYS
AM2_STATE_KEYS = kernels.AM2_STATE_KEYS


def _rc_codes(fk: int) -> np.ndarray:
    """The reverse complement's code of every fk-mer code."""
    codes = np.arange(4 ** fk, dtype=np.int64)
    rc = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(fk):
        rc = (rc << 2) | (3 - (tmp & 3))
        tmp >>= 2
    return rc


def build_ftab_rows(ix: MoveIndex, fk: int,
                    rc_merge: bool = True) -> np.ndarray:
    """[4^fk, 8] int32 anchor rows per fk-mer code (kmer_to_number bit
    order): (rs, os, re, oe, abs_s, count, rc_abs_s, valid), built level
    by level with vectorized backward-search steps.  The rc interval
    start is tracked through the levels with the scalar oracle's
    bidirectional skip recurrence (junctions and all), not looked up as
    the reverse complement's own interval.  rc_merge keeps only the rows
    whose reverse-complement fk-mer also exists; the membership and MEM
    anchors pass False."""
    r, sigma = ix.r, ix.sigma
    assert sigma == 4
    nu, nd = ix.next_tables_search()
    id_a = ix.id_arr.astype(np.int64)
    off_a = ix.offset_arr.astype(np.int64)
    n_a = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    P_tab, U_tab = build_skip_tables(ix)

    def lf(run, off):
        run2 = id_a[run]
        off2 = off_a[run] + off
        ff = (off2 >= n_a[run2]) & (run2 < r - 1)  # bound_ff=1
        off2 = off2 - np.where(ff, n_a[run2], 0)
        return run2 + ff, off2

    rs = ix.first_runs[1:5].astype(np.int64).copy()
    os_ = ix.first_offsets[1:5].astype(np.int64).copy()
    re = ix.last_runs[1:5].astype(np.int64).copy()
    oe = ix.last_offsets[1:5].astype(np.int64).copy()
    # rc side init: abs of comp(a)'s init interval (init_bidirectional)
    comp_first = ix.first_runs[1:5][::-1]
    comp_foff = ix.first_offsets[1:5][::-1]
    rc_abs = (all_p[np.clip(comp_first, 0, r - 1)]
              + comp_foff).astype(np.int64)
    valid = np.ones(4, dtype=bool)
    for _level in range(2, fk + 1):
        rs_t, os_t, re_t, oe_t, v_t, ra_t = [], [], [], [], [], []
        for a in range(4):
            d = nd[a][np.clip(rs, 0, r - 1)]
            ok = valid & (d < r) & (d <= re)
            dc = np.clip(d, 0, r - 1)
            o1 = np.where(d == rs, os_, 0)
            e2 = np.clip(nu[a][np.clip(re, 0, r - 1)], 0, r - 1)
            o2 = np.where(e2 == re, oe, n_a[e2] - 1)
            nrs, nos = lf(dc, o1)
            nre, noe = lf(e2, o2)
            # extend_left's rc advance: skip over the PRE-step fw
            # interval at threshold t = comp(a)
            t = sigma - 1 - a
            rsc = np.clip(rs, 0, r - 1)
            rec = np.clip(re, 0, r - 1)
            skip = (P_tab[t][rec] + U_tab[t][rec] * (oe + 1)
                    - P_tab[t][rsc] - U_tab[t][rsc] * os_)
            rs_t.append(np.where(ok, nrs, 1))
            os_t.append(np.where(ok, nos, 0))
            re_t.append(np.where(ok, nre, 0))
            oe_t.append(np.where(ok, noe, 0))
            ra_t.append(np.where(ok, rc_abs + skip, 0))
            v_t.append(ok)
        rs, os_ = np.concatenate(rs_t), np.concatenate(os_t)
        re, oe = np.concatenate(re_t), np.concatenate(oe_t)
        rc_abs = np.concatenate(ra_t)
        valid = np.concatenate(v_t)
    fabs = np.where(valid, all_p[np.clip(rs, 0, r - 1)] + os_, 0)
    cnt = np.where(valid,
                   all_p[np.clip(re, 0, r - 1)] + oe - fabs + 1, 0)
    if rc_merge:
        valid = valid & valid[_rc_codes(fk)]
    return np.stack([rs, os_, re, oe, fabs, cnt,
                     np.where(valid, rc_abs, 0),
                     valid.astype(np.int64)], axis=1).astype(np.int32)


# past this total-position count the 32 B/position combined table does
# not fit the JAX package's chip and it falls back to the v1 MEM machines;
# the port routes the same way (the v1 machines are ROADMAP item 15, which
# re-derives the cap for the card)
MEM2_MAX_N = 1 << 28


def mem2_supported(ix: MoveIndex) -> bool:
    """True when the v2 combined table fits: ACGT alphabet and
    n <= MEM2_MAX_N."""
    return (bytes(ix.alphabet) == b"ACGT"
            and int(ix.all_p[-1]) <= MEM2_MAX_N)


def looks_rc_closed(ix: MoveIndex, fk: int = 6) -> bool:
    """Strong necessary test for reverse-complement closure: per-char
    counts are symmetric AND every fk-mer's occurrence count equals its
    reverse complement's (all 4^fk of them).  A forward-only index, or
    one that is merely count-symmetric, fails this at fk = 6 with
    overwhelming probability."""
    if bytes(ix.alphabet) != b"ACGT":
        return False
    c = ix.counts
    if int(c[0]) != int(c[3]) or int(c[1]) != int(c[2]):
        return False
    fr = build_ftab_rows(ix, fk, rc_merge=False)
    cnt = np.where(fr[:, 7] == 1, fr[:, 5], -1).astype(np.int64)
    return bool((cnt == cnt[_rc_codes(fk)]).all())


@dataclass
class FusedMem2Index:
    r: int
    sigma: int
    n: int
    # rows [0, sigma*r): "down" records; [sigma*r, 2*sigma*r): "up"
    # records; [2*sigma*r, 2*sigma*r + n): pos2rba rows (run, all_p[run]);
    # with ftab_k > 1, [.., .. + 4^ftab_k): the anchor rows
    rec_all: torch.Tensor       # int32 [2*sigma*r + n (+ 4^fk), 8]
    # init_rec6[a+1] = (rs, os, re, oe, abs_s, abs_e) of init(a)
    init_rec6: torch.Tensor     # int32 [sigma+1, 6]
    alphamap_query: np.ndarray
    ftab_k: int = 0
    # abs position of the canonical empty interval's start (run 1,
    # offset 0): the oracle keeps advancing an "empty" fw side from it
    p1: int = 1

    def to(self, device) -> "FusedMem2Index":
        return replace(self, rec_all=self.rec_all.to(device),
                       init_rec6=self.init_rec6.to(device))


def build_fused_mem2_index(ix: MoveIndex, ftab_k: int = 0
                           ) -> FusedMem2Index:
    """The combined table on the host (numpy, then host tensors)."""
    r, sigma = ix.r, ix.sigma
    assert bytes(ix.alphabet) == b"ACGT", (
        "the MEM v2 table requires the ACGT alphabet (complement is "
        "index reversal)")
    assert int(ix.n_arr[ix.end_bwt_idx]) == 1, (
        "the '$' run must be a single row")
    n_total = int(ix.all_p[-1])
    assert n_total < (1 << 31), "absolute positions are int32"
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "the MEM v2 table requires an index built with bound_ff=1")

    nus, nds = ix.next_tables_search()
    P_tab, U_tab = build_skip_tables(ix)
    rows = 2 * sigma * r + n_total + (4 ** ftab_k if ftab_k > 1 else 0)
    rec_all = np.zeros((rows, 8), dtype=np.int32)

    def records(dest_tab, base):
        # column by column into the int32 table: each word is computed in
        # int64 and wraps to int32 as the JAX builder's final cast does
        for a in range(sigma):
            dest = dest_tab[a].astype(np.int64)
            ok = dest < r
            d = np.where(ok, dest, 0)
            idd = ix.id_arr[d]
            cum1 = np.where(idd < r - 1, n64[idd], _GUARD)
            t = sigma - 1 - a
            blk = rec_all[base + a * r: base + (a + 1) * r]
            blk[:, 0] = np.where(ok, dest, r)
            blk[:, 1] = idd
            blk[:, 2] = (cum1 | (ix.offset_arr[d].astype(np.int64) << 16)
                         ).astype(np.int32)
            blk[:, 3] = n64[d]
            blk[:, 4] = ix.all_p[idd]
            blk[:, 5] = P_tab[t]
            blk[:, 6] = U_tab[t]

    records(nds, 0)
    records(nus, sigma * r)
    p2r = rec_all[2 * sigma * r: 2 * sigma * r + n_total]
    runs = np.repeat(np.arange(r, dtype=np.int64), n64)
    p2r[:, 0] = runs
    p2r[:, 1] = ix.all_p[:-1][runs]
    del runs
    if ftab_k > 1:
        rec_all[2 * sigma * r + n_total:] = build_ftab_rows(
            ix, ftab_k, rc_merge=False)

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    from ..constants import SEPARATOR
    if ix.separators:
        alphamap_query[SEPARATOR] = -1

    abs_s = ix.all_p[np.clip(ix.first_runs, 0, r - 1)] + ix.first_offsets
    abs_e = ix.all_p[np.clip(ix.last_runs, 0, r - 1)] + ix.last_offsets
    init6_tab = np.stack([ix.first_runs, ix.first_offsets, ix.last_runs,
                          ix.last_offsets, abs_s, abs_e], axis=1)
    return FusedMem2Index(
        r=r, sigma=sigma, n=n_total, rec_all=torch.from_numpy(rec_all),
        init_rec6=torch.from_numpy(init6_tab.astype(np.int32)),
        alphamap_query=alphamap_query, ftab_k=ftab_k,
        p1=int(ix.all_p[1]))


def init6(m2: FusedMem2Index, a):
    """init(a) with abs coordinates: (rs, os, re, oe, abs_s, abs_e);
    illegal chars read row 1 (the first char's), as the JAX engines do."""
    rec = m2.init_rec6[a.clamp(min=0).to(torch.int64) + 1]
    return tuple(rec[:, i] for i in range(6))


def decode_lf(rec: torch.Tensor, off_in):
    """LF + bounded ff from a wide record: (run', off', abs').  w2 packs
    offset << 16, so the offset is decoded unsigned."""
    w2 = rec[:, 2]
    off0 = ((w2 >> 16) & _GUARD) + off_in
    cum1 = w2 & _GUARD
    ff = (off0 >= cum1).to(torch.int32)
    return rec[:, 1] + ff, off0 - ff * cum1, rec[:, 4] + off0


def _step_rows(m2: FusedMem2Index, a_s, rs, re):
    """The down row of (a, rs) and the up row of (a, re)."""
    r = m2.r
    a64 = a_s.to(torch.int64)
    lo = m2.rec_all[a64 * r + rs.clamp(0, r - 1).to(torch.int64)]
    hi = m2.rec_all[(m2.sigma + a64) * r + re.clamp(0, r - 1)
                    .to(torch.int64)]
    return lo, hi


def _decode_step(m2: FusedMem2Index, lo, hi, a, rs, os_, re, oe):
    """(nrs, nos, nre, noe, nabs_s, nabs_e, skip, empty) of one backward
    step from the rows of (a, rs) and (a, re); skip is the companion's
    advance over the PRE-step interval (int32, wrapping as in JAX)."""
    drs = lo[:, 0]
    dre = hi[:, 0]
    empty = (a < 0) | (drs >= m2.r) | (drs > re)
    os1 = torch.where(drs != rs, 0, os_)
    oe1 = torch.where(dre != re, hi[:, 3] - 1, oe)
    nrs, nos, nabs_s = decode_lf(lo, os1)
    nre, noe, nabs_e = decode_lf(hi, oe1)
    skip = hi[:, 5] + hi[:, 6] * (oe + 1) - lo[:, 5] - lo[:, 6] * os_
    return nrs, nos, nre, noe, nabs_s, nabs_e, skip, empty


def mem2_step(m2: FusedMem2Index, rs, os_, re, oe, a):
    """One backward_search_step on the wide records.  Returns (nrs, nos,
    nre, noe, nabs_s, nabs_e, skip, empty); skip is valid when `a` is the
    stepped direction's char (extend_left: the fw char; extend_right:
    comp(text char) stepping the rc side)."""
    lo, hi = _step_rows(m2, a.clamp(min=0), rs, re)
    return _decode_step(m2, lo, hi, a, rs, os_, re, oe)


def mem2_resolve(m2: FusedMem2Index, abs_pos):
    """(run, offset) of absolute BWT rows via the pos2rba rows."""
    base = 2 * m2.sigma * m2.r
    row = m2.rec_all[base + abs_pos.clamp(0, m2.n - 1).to(torch.int64)]
    return row[:, 0], abs_pos - row[:, 1]


def init_pair6(m2: FusedMem2Index, c0):
    """init_bidirectional at a char: fw from c0 (the canonical empty
    interval, abs form (p1, 0), when illegal), rc from its complement
    (an unknown char other than '#' complements to 'A'); both with abs."""
    sigma = m2.sigma
    where = torch.where
    i_f = init6(m2, c0)
    legal = c0 >= 0
    fw = (where(legal, i_f[0], 1), where(legal, i_f[1], 0),
          where(legal, i_f[2], 0), where(legal, i_f[3], 0),
          where(legal, i_f[4], m2.p1), where(legal, i_f[5], 0))
    c0r = where(legal, sigma - 1 - c0, where(c0 == -1, 0, -1))
    i_r = init6(m2, c0r)
    rlegal = c0r >= 0
    rc = (where(rlegal, i_r[0], 1), where(rlegal, i_r[1], 0),
          where(rlegal, i_r[2], 0), where(rlegal, i_r[3], 0),
          where(rlegal, i_r[4], m2.p1), where(rlegal, i_r[5], 0))
    return tuple(x.to(torch.int32) for x in fw), \
        tuple(x.to(torch.int32) for x in rc)


def entry_state(keys, lanes: int, W: int, device
                ) -> Dict[str, torch.Tensor]:
    """A MEM machine's state before its first tick: phase ENTRY, every
    other register 0, no emissions.  The machine, kernel or plain, builds
    each ENTRY lane's start state from that lane's slots."""
    st = {key: torch.zeros(lanes, dtype=torch.int32, device=device)
          for key in keys}
    st["phase"].fill_(ENTRY)
    for key in ("ends", "counts"):
        st[key] = torch.zeros((lanes, W), dtype=torch.int32, device=device)
    return st


def enter(st, keys, regs) -> Dict[str, torch.Tensor]:
    """st with each ENTRY lane's registers set to regs, its start
    state."""
    entry = st["phase"] == ENTRY
    out = {key: torch.where(entry, v, st[key]).to(torch.int32)
           for key, v in zip(keys, regs)}
    out["ends"], out["counts"] = st["ends"], st["counts"]
    return out


def _enter_mem2(st, m, L: int):
    """The BML start state (fused_mem2.py make_mem2_state): INIT for a
    read at least L long, else DONE; every other register 0."""
    return enter(st, MEM2_STATE_KEYS,
                 (torch.where(m >= L, INIT, DONE),) + (0,) * 15)


def _enter_all_mem2(m2: FusedMem2Index, alphas, m, st):
    """The all-MEMs start state (the jitted make_state of fused_mem2.py
    FusedAllMem2Engine.query_batch): init_bidirectional at the first
    char, ml = 1, RIGHT (done for an empty read)."""
    fw, rc = init_pair6(m2, alphas[:, 0])
    return enter(st, AM2_STATE_KEYS,
                 (torch.where(m > 0, AM2_RIGHT, AM2_DONE), 0, 1, 0)
                 + fw + rc)


def _mem2_tick(m2: FusedMem2Index, alphas, codes, m, st, L: int,
               lane_idx, ends, counts):
    """One lockstep BML tick of every lane (fused_mem2.py _mem2_scan's
    tick, in its order); adds the emissions into ends and counts and
    returns the new registers and, per lane, the 32 B rows it needed and
    whether it loaded a step's rows ([2, lanes])."""
    sigma, r, n = m2.sigma, m2.r, m2.n
    P2R = 2 * sigma * r
    W = alphas.shape[1]
    use_ftab = codes is not None
    where = torch.where
    phase, pos, jc, end = st["phase"], st["pos"], st["jc"], st["end"]
    frs, fos, fre, foe, fas, fae = (st[k] for k in MEM2_STATE_KEYS[4:10])
    rrs, ros, rre, roe, ras, rae = (st[k] for k in MEM2_STATE_KEYS[10:])

    def char_at(p):
        return alphas[lane_idx, p.clamp(0, W - 1).to(torch.int64)]

    # ---- INIT: anchor the window, init bidirectional
    is_init = phase == INIT
    past_end = pos + L > m
    c0 = char_at(pos + L - 1)
    i_f = init6(m2, c0)
    i_r = init6(m2, where(c0 >= 0, sigma - 1 - c0, -1))
    do_init = is_init & ~past_end & (c0 >= 0)
    init_illegal = is_init & ~past_end & (c0 < 0)
    if not use_ftab:
        # anchored lanes step in the same tick (fall into BACK)
        frs, fos, fre, foe, fas, fae = (where(do_init, i, c) for i, c in
                                        zip(i_f, (frs, fos, fre, foe, fas,
                                                  fae)))
        ras = where(do_init, i_r[4], ras)
        jc = where(do_init, 0, jc)
        phase = where(do_init, BACK, phase)
    else:
        code0 = codes[lane_idx, (pos + L - 1).clamp(0, W - 1)
                      .to(torch.int64)]
    phase = where(is_init & past_end, DONE, phase)
    pos = where(init_illegal, pos + L - 1, pos)

    # ---- the tick's rows, phase-keyed
    in_back = phase == BACK
    in_resolve = phase == RESOLVE
    in_fwd = phase == FWD
    in_next = phase == NEXT
    in_bscan = (phase == BSCAN) if use_ftab else torch.zeros_like(in_back)
    backish = in_back | in_bscan
    p_step = where(backish, pos + L - 2 - jc, where(in_fwd, jc, end - 1 - jc))
    c_raw = char_at(p_step)
    c_fwd = where(c_raw >= 0, sigma - 1 - c_raw, where(c_raw == -1, 0, -1))
    a = where(in_fwd, c_fwd, c_raw)
    a = where(in_fwd & (jc >= m), -1, a)
    a_s = a.clamp(min=0).to(torch.int64)
    iv_rs = where(in_fwd, rrs, frs)
    iv_os = where(in_fwd, ros, fos)
    iv_re = where(in_fwd, rre, fre)
    iv_oe = where(in_fwd, roe, foe)
    rae_want = ras + (fae - fas)  # rc end abs = start + count - 1
    key_lo = where(in_resolve, P2R + ras.clamp(0, n - 1),
                   a_s * r + iv_rs.clamp(0, r - 1))
    key_hi = where(in_resolve, P2R + rae_want.clamp(0, n - 1),
                   (sigma + a_s) * r + iv_re.clamp(0, r - 1))
    active = backish | in_fwd | in_next
    stepped = active & (a >= 0)
    rows = where(in_resolve | stepped, 2, 0)
    if use_ftab:
        fkey = P2R + n + code0.clamp(min=0)
        key_lo = where(do_init, fkey, key_lo)
        key_hi = where(do_init, fkey, key_hi)
        # a code of -1 misses without its row
        rows = where(do_init & (code0 >= 0), 1, rows)
    lo = m2.rec_all[key_lo.to(torch.int64)]
    hi = m2.rec_all[key_hi.to(torch.int64)]
    nrs, nos, nre, noe, nas, nae, skip, empty = _decode_step(
        m2, lo, hi, a, iv_rs, iv_os, iv_re, iv_oe)
    ok = active & ~empty

    # ---- BACK/BSCAN: extend_left; rc in abs only
    back_ok = backish & ok
    frs2, fos2, fre2, foe2, fas2, fae2 = (
        where(back_ok, nv, cv) for nv, cv in
        zip((nrs, nos, nre, noe, nas, nae), (frs, fos, fre, foe, fas, fae)))
    ras2 = where(in_back & ok, ras + skip, ras)
    back_fail = backish & ~ok
    pos2 = where(back_fail, pos + L - 1 - jc, pos)
    phase2 = where(back_fail, INIT, phase)
    jc2 = where(back_ok, jc + 1, jc)
    back_done = (in_back & ok) & (jc2 >= L - 1)
    phase2 = where(back_done, RESOLVE, phase2)
    jc2 = where(back_done, pos + L, jc2)
    if use_ftab:
        # a completed BSCAN emits nothing and re-anchors one right
        bscan_done = (in_bscan & ok) & (jc2 >= L - 1)
        phase2 = where(bscan_done, INIT, phase2)
        pos2 = where(bscan_done, pos + 1, pos2)

    # ---- RESOLVE: rc abs -> (run, offset)
    rrs2 = where(in_resolve, lo[:, 0], rrs)
    ros2 = where(in_resolve, ras - lo[:, 1], ros)
    rre2 = where(in_resolve, hi[:, 0], rre)
    roe2 = where(in_resolve, rae_want - hi[:, 1], roe)
    rae2 = where(in_resolve, rae_want, rae)
    phase2 = where(in_resolve, FWD, phase2)

    # ---- FWD: plain steps on rc; emit on failure
    fwd_ok = in_fwd & ok
    rrs2, ros2, rre2, roe2, ras2, rae2 = (
        where(fwd_ok, nv, cv) for nv, cv in
        zip((nrs, nos, nre, noe, nas, nae),
            (rrs2, ros2, rre2, roe2, ras2, rae2)))
    jc2 = where(fwd_ok, jc + 1, jc2)
    fwd_fail = in_fwd & ~ok
    at = pos.clamp(0, W - 1).to(torch.int64)
    ends[lane_idx, at] += where(fwd_fail, jc, 0)
    counts[lane_idx, at] += where(fwd_fail, rae - ras + 1, 0)
    end2 = where(fwd_fail, jc, end)
    at_read_end = fwd_fail & (jc >= m)
    phase2 = where(fwd_fail, NEXT, phase2)
    phase2 = where(at_read_end, DONE, phase2)
    # NEXT init: fw = init(seq[end]), jc = 0; for these lanes p_step is
    # end2, so c_raw is seq[end2]
    go_next = fwd_fail & ~at_read_end
    nx = init6(m2, c_raw)
    frs2, fos2, fre2, foe2 = (where(go_next, nv, cv) for nv, cv in
                              zip(nx[:4], (frs2, fos2, fre2, foe2)))
    jc2 = where(go_next, 0, jc2)
    next_init_illegal = go_next & (c_raw < 0)

    # ---- NEXT: backward-scan to the next candidate
    exhausted = in_next & (jc > end - pos - 2)
    next_fail = (in_next & ~ok & ~exhausted) | next_init_illegal
    nok = in_next & ok & ~exhausted
    frs2, fos2, fre2, foe2 = (where(nok, nv, cv) for nv, cv in
                              zip((nrs, nos, nre, noe),
                                  (frs2, fos2, fre2, foe2)))
    jc2 = where(nok, jc + 1, jc2)
    stop = next_fail | exhausted
    pos2 = where(stop & in_next, end - jc, pos2)
    pos2 = where(next_init_illegal, end2, pos2)
    phase2 = where(stop | next_init_illegal, INIT, phase2)

    if use_ftab:
        # ---- ftab INIT landing (disjoint lanes)
        hit = do_init & (code0 >= 0) & (lo[:, 7] == 1)
        miss = do_init & ~hit
        frs2, fos2, fre2, foe2 = (
            where(hit, lo[:, i], where(miss, i_f[i], cv))
            for i, cv in enumerate((frs2, fos2, fre2, foe2)))
        fas2 = where(hit, lo[:, 4], fas2)
        fae2 = where(hit, lo[:, 4] + lo[:, 5] - 1, fae2)
        ras2 = where(hit, lo[:, 6], ras2)
        if m2.ftab_k >= L:
            # the ftab row covers the whole window: no BACK steps
            jc2 = where(hit, pos + L, where(miss, 0, jc2))
            phase2 = where(hit, RESOLVE, where(miss, BSCAN, phase2))
        else:
            jc2 = where(hit, m2.ftab_k - 1, where(miss, 0, jc2))
            phase2 = where(hit, BACK, where(miss, BSCAN, phase2))

    regs = (phase2, pos2, jc2, end2, frs2, fos2, fre2, foe2, fas2, fae2,
            rrs2, ros2, rre2, roe2, ras2, rae2)
    return ({key: v.to(torch.int32) for key, v in zip(MEM2_STATE_KEYS, regs)},
            torch.stack([rows, stepped.to(rows.dtype)]))


def _all_mem2_tick(m2: FusedMem2Index, alphas, m, st, lane_idx, ends,
                   counts):
    """One lockstep all-MEMs tick of every lane (fused_mem2.py
    _all_mem2_scan's tick, in its order), with _mem2_tick's tallies."""
    sigma, r, n = m2.sigma, m2.r, m2.n
    P2R = 2 * sigma * r
    W = alphas.shape[1]
    where = torch.where
    phase, s, ml, e = st["phase"], st["s"], st["ml"], st["e"]
    frs, fos, fre, foe, fas, fae = (st[k] for k in AM2_STATE_KEYS[4:10])
    rrs, ros, rre, roe, ras, rae = (st[k] for k in AM2_STATE_KEYS[10:])

    def char_at(p):
        return alphas[lane_idx, p.clamp(0, W - 1).to(torch.int64)]

    in_right = phase == AM2_RIGHT
    in_left = phase == AM2_LEFT
    in_res = phase == AM2_RES
    # one char: RIGHT at s+ml, LEFT at e-ml
    c_raw = char_at(where(in_right, s + ml, e - ml))
    a_right = where(c_raw >= 0, sigma - 1 - c_raw, where(c_raw == -1, 0, -1))
    a = where(in_right, where(s + ml < m, a_right, -1),
              where(in_left & (e - ml >= 0), c_raw, -1))
    a_s = a.clamp(min=0).to(torch.int64)
    iv_rs = where(in_right, rrs, frs)
    iv_os = where(in_right, ros, fos)
    iv_re = where(in_right, rre, fre)
    iv_oe = where(in_right, roe, foe)
    # RES uses the CARRIED rae, not ras + (fae - fas): after an illegal-
    # char re-anchor the fw side is the canonical empty interval, so the
    # count(fw) == count(rc) sync does not hold
    key_lo = where(in_res, P2R + ras.clamp(0, n - 1),
                   a_s * r + iv_rs.clamp(0, r - 1))
    key_hi = where(in_res, P2R + rae.clamp(0, n - 1),
                   (sigma + a_s) * r + iv_re.clamp(0, r - 1))
    stepping = in_right | in_left
    stepped = stepping & (a >= 0)
    rows = where(in_res | stepped, 2, 0)
    lo = m2.rec_all[key_lo.to(torch.int64)]
    hi = m2.rec_all[key_hi.to(torch.int64)]
    nrs, nos, nre, noe, nas, nae, skip, empty = _decode_step(
        m2, lo, hi, a, iv_rs, iv_os, iv_re, iv_oe)
    ok = stepping & ~empty
    right_ok = in_right & ok
    left_ok = in_left & ok
    # the stepped side takes the decode; the companion advances in abs
    rrs2, ros2, rre2, roe2 = (where(right_ok, nv, cv) for nv, cv in
                              zip((nrs, nos, nre, noe), (rrs, ros, rre, roe)))
    ras2 = where(right_ok, nas, where(left_ok, ras + skip, ras))
    rae2 = where(right_ok, nae, rae)
    frs2, fos2, fre2, foe2 = (where(left_ok, nv, cv) for nv, cv in
                              zip((nrs, nos, nre, noe), (frs, fos, fre, foe)))
    fas2 = where(left_ok, nas, where(right_ok, fas + skip, fas))
    fae2 = where(left_ok, nae,
                 where(right_ok, fas + skip + (nae - nas), fae))
    # keep the companion count in sync after a LEFT step too
    rae2 = where(left_ok, ras2 + (nae - nas), rae2)
    ml2 = where(right_ok | left_ok, ml + 1, ml)

    # RIGHT termination: emit (s, s+ml, count(fw)) at s; the count clamps
    # to 0 while the fw side is the canonical empty interval (fas > fae)
    right_stop = in_right & ~ok
    at = s.clamp(0, W - 1).to(torch.int64)
    ends[lane_idx, at] += where(right_stop, s + ml, 0)
    counts[lane_idx, at] += where(right_stop, (fae - fas + 1).clamp(min=0),
                                  0)
    e2 = where(right_stop, s + ml, e)
    at_end = right_stop & (s + ml >= m)
    phase2 = where(at_end, AM2_DONE, phase)
    # re-anchor: init at e, ml = 1, left-extend
    reanchor = right_stop & ~at_end
    ifw, irc = init_pair6(m2, char_at(e2))
    frs2, fos2, fre2, foe2, fas2, fae2 = (
        where(reanchor, iv, cv) for iv, cv in
        zip(ifw, (frs2, fos2, fre2, foe2, fas2, fae2)))
    rrs2, ros2, rre2, roe2, ras2, rae2 = (
        where(reanchor, iv, cv) for iv, cv in
        zip(irc, (rrs2, ros2, rre2, roe2, ras2, rae2)))
    ml2 = where(reanchor, 1, ml2)
    phase2 = where(reanchor, AM2_LEFT, phase2)
    # LEFT termination: s = e - ml + 1, resolve rc, back to RIGHT
    left_stop = in_left & ~ok
    s2 = where(left_stop, e - ml + 1, s)
    phase2 = where(left_stop, AM2_RES, phase2)
    # RES: rc abs -> (run, offset), then RIGHT
    rrs2 = where(in_res, lo[:, 0], rrs2)
    ros2 = where(in_res, ras - lo[:, 1], ros2)
    rre2 = where(in_res, hi[:, 0], rre2)
    roe2 = where(in_res, rae - hi[:, 1], roe2)
    phase2 = where(in_res, AM2_RIGHT, phase2)
    regs = (phase2, s2, ml2, e2, frs2, fos2, fre2, foe2, fas2, fae2,
            rrs2, ros2, rre2, roe2, ras2, rae2)
    return ({key: v.to(torch.int32) for key, v in zip(AM2_STATE_KEYS, regs)},
            torch.stack([rows, stepped.to(rows.dtype)]))


def _lockstep(tick, state, done: int, ticks: int, device):
    """Run `tick(st, ends, counts)` up to `ticks` times, stopping early
    once every lane is done (later ticks change nothing).  Returns the
    state and work int32 [3, lanes]: each lane's ticks before it was done
    and the sums of the two per-lane tallies each tick returns beside the
    state ([2, lanes]; the v2 machines: the 32 B rows loaded and the ticks
    that loaded a step's rows; the v1 machines: table bytes and
    extensions)."""
    st = {key: v.clone() for key, v in state.items()}
    ends, counts = st.pop("ends"), st.pop("counts")
    lanes = ends.shape[0]
    work = torch.zeros((3, lanes), dtype=torch.int32, device=device)
    for t in range(ticks):
        if t % 64 == 0 and bool((st["phase"] == done).all()):
            break
        live = st["phase"] != done
        st, add = tick(st, ends, counts)
        work[0] += live.to(torch.int32)
        work[1:] += torch.where(live, add, 0).to(torch.int32)
    st["ends"], st["counts"] = ends, counts
    return st, work


def _read_lengths(alphas: torch.Tensor) -> torch.Tensor:
    """m: each lane's positions that are in its read (slot != -2; the
    JAX machines count slot > -2 and so drop each '#', ROADMAP §3.6)."""
    return (alphas != -2).sum(dim=1).to(torch.int32)


def mem2_scan_plain(m2: FusedMem2Index, alc: torch.Tensor, state, L: int,
                    ticks: int, use_ftab: bool = False):
    """Plain PyTorch BML machine: the start state of each ENTRY lane,
    then `ticks` lockstep ticks from state (MEM2_STATE_KEYS, ends and
    counts) over alc, int32 [lanes, W] read-order slots (-1 illegal, -3
    '#', -2 past the read) or, with use_ftab, [lanes, 2W] slots and
    fk-mer codes (prep_alc).  Returns (state, work)."""
    W = alc.shape[1] // 2 if use_ftab else alc.shape[1]
    alphas, codes = alc[:, :W], (alc[:, W:] if use_ftab else None)
    m = _read_lengths(alphas)
    lane_idx = torch.arange(alc.shape[0], device=alc.device)
    return _lockstep(
        lambda st, ends, counts: _mem2_tick(m2, alphas, codes, m, st, L,
                                            lane_idx, ends, counts),
        _enter_mem2(state, m, L), DONE, ticks, alc.device)


def all_mem2_scan_plain(m2: FusedMem2Index, alc: torch.Tensor, state,
                        ticks: int):
    """Plain PyTorch all-MEMs machine over alc int32 [lanes, W]: the
    start state of each ENTRY lane, then `ticks` lockstep ticks from
    state (AM2_STATE_KEYS, ends and counts).  Returns (state, work)."""
    m = _read_lengths(alc)
    lane_idx = torch.arange(alc.shape[0], device=alc.device)
    return _lockstep(
        lambda st, ends, counts: _all_mem2_tick(m2, alc, m, st, lane_idx,
                                                ends, counts),
        _enter_all_mem2(m2, alc, m, state), AM2_DONE, ticks, alc.device)


def mem2_scan(m2: FusedMem2Index, alc: torch.Tensor, state, L: int,
              ticks: int, use_ftab: bool = False):
    """The BML machine: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if alc.device.type == "cuda":
        return kernels.mem2_scan(m2.rec_all, m2.init_rec6, m2.r, m2.sigma,
                                 m2.n, m2.ftab_k, alc, state, L, ticks,
                                 use_ftab)
    if alc.device.type != "cpu":
        raise ValueError(f"no scan for device {alc.device}")
    return mem2_scan_plain(m2, alc, state, L, ticks, use_ftab)


def all_mem2_scan(m2: FusedMem2Index, alc: torch.Tensor, state,
                  ticks: int):
    """The all-MEMs machine: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if alc.device.type == "cuda":
        return kernels.all_mem2_scan(m2.rec_all, m2.init_rec6, m2.r,
                                     m2.sigma, m2.n, m2.ftab_k, m2.p1, alc,
                                     state, ticks)
    if alc.device.type != "cpu":
        raise ValueError(f"no scan for device {alc.device}")
    return all_mem2_scan_plain(m2, alc, state, ticks)


def bml_tick_cap(W: int) -> int:
    """The most ticks a BML lane may take: the JAX budget of W quanta of
    2W+84 ticks."""
    return W * (2 * W + 84)


def all_mem2_tick_cap(W: int) -> int:
    """The all-MEMs budget: W quanta of 4W+64 ticks."""
    return W * (4 * W + 64)


def mem_lists(ends: np.ndarray, counts: np.ndarray
              ) -> List[List[Tuple[int, int, int]]]:
    """Per lane, (pos, end, count) of every nonzero of its ends row, in
    ascending position order."""
    lanes_i, pos_i = np.nonzero(ends)
    e = ends[lanes_i, pos_i].tolist()
    c = counts[lanes_i, pos_i].tolist()
    p = pos_i.tolist()
    bounds = np.searchsorted(lanes_i, np.arange(ends.shape[0] + 1)).tolist()
    return [list(zip(p[a:b], e[a:b], c[a:b]))
            for a, b in zip(bounds, bounds[1:])]


class _Mem2Engine:
    done_phase: int   # the machine's done phase
    what: str         # its name in a tick-budget error

    def __init__(self, m2: FusedMem2Index, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.m2 = m2.to(self.device)

    def slots(self, batch: ReadBatch, fk: int = 0) -> torch.Tensor:
        """alc on the device: int8 read-order slots ('#' -3, past the
        read -2) shipped, widened (and fk-mer codes appended) by
        prep_alc."""
        amap = self.m2.alphamap_query.copy()
        amap[ord("#")] = -3  # '#' complements to itself (never matches)
        al8 = left_aligned_slots(batch, amap).astype(np.int8)
        return prep_alc(torch.from_numpy(al8).to(self.device), fk)

    def query_batch_device(self, batch: ReadBatch):
        """(ends, counts int32 [lanes, W], work int32 [3, lanes]: each
        lane's ticks, 32 B rows and step ticks) on the device."""
        alc, state, cap = self.prepare(batch)
        st, work = self.scan(alc, state, cap)
        if bool((st["phase"] != self.done_phase).any()):
            raise RuntimeError(f"{self.what} scan did not finish within "
                               f"{cap} ticks")
        return st["ends"], st["counts"], work

    def query_batch(self, batch: ReadBatch
                    ) -> List[List[Tuple[int, int, int]]]:
        """Per read: [(pos, end, count)] in ascending position order."""
        ends, counts, _ = self.query_batch_device(batch)
        return mem_lists(ends.cpu().numpy(), counts.cpu().numpy())


class FusedMem2Engine(_Mem2Engine):
    """Batched MEMs (BML, min_mem_length >= 2) on the v2 records, with
    the table's ftab anchors when 1 < ftab_k <= L.  Results identical to
    AdvancedEngine.query_mems(seq, L)."""
    done_phase, what = DONE, "BML"

    def __init__(self, m2: FusedMem2Index, min_mem_length: int,
                 device: DeviceLike = None):
        assert min_mem_length >= 2, "use FusedAllMem2Engine for L <= 1"
        super().__init__(m2, device)
        self.L = min_mem_length
        self.use_ftab = 1 < m2.ftab_k <= self.L

    def prepare(self, batch: ReadBatch):
        """(alc, the state before entry, the tick budget) of a batch on
        the device."""
        alc = self.slots(batch, self.m2.ftab_k if self.use_ftab else 0)
        return (alc, entry_state(MEM2_STATE_KEYS, batch.lanes, batch.width,
                                 self.device), bml_tick_cap(batch.width))

    def scan(self, alc: torch.Tensor, state, cap: int):
        """The BML machine on prepare's output: (state, work)."""
        return mem2_scan(self.m2, alc, state, self.L, cap, self.use_ftab)


class FusedAllMem2Engine(_Mem2Engine):
    """Batched all-MEMs (min_mem_length <= 1) on the v2 records.  Results
    identical to AdvancedEngine.query_all_mems."""
    done_phase, what = AM2_DONE, "all-MEMs"

    def prepare(self, batch: ReadBatch):
        """(alc, the state before entry, the tick budget) of a batch on
        the device."""
        return (self.slots(batch),
                entry_state(AM2_STATE_KEYS, batch.lanes, batch.width,
                            self.device), all_mem2_tick_cap(batch.width))

    def scan(self, alc: torch.Tensor, state, cap: int):
        """The all-MEMs machine on prepare's output: (state, work)."""
        return all_mem2_scan(self.m2, alc, state, cap)


def prep_alc_plain(al8: torch.Tensor, fk: int) -> torch.Tensor:
    """Plain PyTorch prep: int8 read-order slots [lanes, W] (-1 illegal or
    past the read) -> int32 [lanes, W]; with fk > 0, [lanes, 2W] whose
    right half holds each position's fk-mer code (the chars at p-fk+1..p,
    first char most significant, two bits each), -1 where any of those
    chars is illegal or p < fk-1."""
    al = al8.to(torch.int32)
    if not fk:
        return al
    W = al.shape[1]
    code = torch.zeros_like(al)
    ok = torch.ones(al.shape, dtype=torch.bool, device=al.device)
    for j in range(fk):
        sh = fk - 1 - j
        a_sh = torch.full_like(al, -1)
        if sh < W:
            a_sh[:, sh:] = al[:, :W - sh]
        code = code * 4 + a_sh.clamp(min=0)
        ok = ok & (a_sh >= 0)
    ok = ok & (torch.arange(W, device=al.device) >= fk - 1)[None, :]
    return torch.cat([al, torch.where(ok, code, -1)], dim=1)


def prep_alc(al8: torch.Tensor, fk: int) -> torch.Tensor:
    """The batch prep: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if al8.device.type == "cuda":
        return kernels.prep_alc(al8, fk)
    if al8.device.type != "cpu":
        raise ValueError(f"no prep for device {al8.device}")
    return prep_alc_plain(al8, fk)
