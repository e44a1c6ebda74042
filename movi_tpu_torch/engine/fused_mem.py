"""MEM v1: the BML and all-MEMs tick machines on the one-step search
records, for an index past the MEM v2 table's cap (MEM2_MAX_N).

Port of movi_tpu/engine/fused_mem.py.  The table (FusedMemIndex) is the
one-step search records of engine/fused_search.py, the bidirectional skip
rows (P, U) per (threshold char, run), all_p, and, up to POS2RUN_MAX_N
BWT rows, pos2rba: each row's (run, all_p[run]), built on the device from
n_arr and all_p (kernel 13a, csrc/fused_mem.cu).  Past that size the
companion interval's reposition is a binary search over all_p.

The machines (AdvancedEngine.query_mems for L >= 2, query_all_mems
otherwise):

  INIT  anchor a length-L window at pos; bidirectional init on its last
        char
  BACK  extend_left over the remaining L-1 window chars; a failure at
        step j re-anchors at pos+L-1-j
  FWD   forward-extend to maximality: plain backward steps of the
        complemented read char on the rc interval; emit on failure
  NEXT  backward-scan from the MEM end to the next candidate left end

and all-MEMs' RIGHT (extend_right to maximality, emit) and LEFT
(left-extend from the MEM end to re-anchor).  They run the hand-written
CUDA kernels 13b and 13c on CUDA tensors and the plain PyTorch versions
below on CPU tensors.  Each machine builds its lanes' start state from
their slots (a lane in phase ENTRY, fused_mem2.entry_state), so the JAX
all-MEMs engine's jitted entry state is part of kernel 13c.  The plain
versions keep the JAX scans' lockstep form and stop once every lane is
done; a kernel thread loops until its lane is done.  A done lane's tick
changes nothing, so both equal the JAX engines' tick quanta with lane
compaction.  A lane still running past the JAX budget (W quanta of
4W+64 ticks) is an error, not a partial answer.

Two answers differ from the JAX engines', which the scalar oracle shows
wrong: the read length counts a '#' inside the read (the JAX machines
count slots > -2 and drop it, ROADMAP §3.9), and an all-MEMs emission
whose forward interval is the canonical empty one counts 0, not the
JAX engine's 1 - n_arr[0] (ROADMAP §3.10).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import kernels
from ..cpu_ref.native_search import build_skip_tables
from ..device import DeviceLike, resolve_device
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch, left_aligned_slots
from .fused_mem2 import (_lockstep, _read_lengths, enter, entry_state,
                         mem_lists)
from .fused_search import (FusedSearchIndex, build_fused_search_index,
                           fused_bs_step, init_interval)

# BML phases
INIT, BACK, FWD, NEXT, DONE = 0, 1, 2, 3, 4
# all-MEMs phases
AM_RIGHT, AM_LEFT, AM_DONE = 0, 1, 2
# the machines' per-lane registers, in the kernels' row order
MEM1_STATE_KEYS = kernels.MEM1_STATE_KEYS
AM1_STATE_KEYS = kernels.AM1_STATE_KEYS

POS2RUN_MAX_N = 1 << 27   # 1 GB of pos2rba; past this, the binary search


@dataclass
class FusedMemIndex:
    si: FusedSearchIndex
    # skip_rec[t*r + run] = (P, U): P = weighted rows before the run, U =
    # the per-row weight (comp(char(run)) < t, or the '$' run)
    skip_rec: torch.Tensor            # int32 [sigma*r, 2]
    n: int                            # BWT rows (the text's length)
    # pos2rba[row] = (the run holding BWT row `row`, all_p[run]); None
    # past POS2RUN_MAX_N rows
    pos2rba: Optional[torch.Tensor] = None   # int32 [n, 2]

    @property
    def all_p64(self) -> torch.Tensor:
        """all_p int32 [r+1], the search records' own."""
        return self.si.all_p

    def to(self, device) -> "FusedMemIndex":
        return replace(self, si=self.si.to(device),
                       skip_rec=self.skip_rec.to(device),
                       pos2rba=None if self.pos2rba is None
                       else self.pos2rba.to(device))


def pos2rba_plain(n_arr: torch.Tensor, all_p: torch.Tensor,
                  n: int) -> torch.Tensor:
    """Plain PyTorch pos2rba: repeat(arange(r), n_arr) -> int32 [n, 2] of
    (run, all_p[run])."""
    r = n_arr.shape[0]
    runs = torch.repeat_interleave(
        torch.arange(r, dtype=torch.int32, device=n_arr.device),
        n_arr.to(torch.int64), output_size=n)
    return torch.stack([runs, all_p[runs.to(torch.int64)]], dim=1)


def build_pos2rba(n_arr: torch.Tensor, all_p: torch.Tensor,
                  n: int) -> torch.Tensor:
    """pos2rba on n_arr's device: kernel 13a on CUDA, the plain version on
    the CPU."""
    if n_arr.device.type == "cuda":
        return kernels.pos2rba_build(n_arr, all_p, n)
    if n_arr.device.type != "cpu":
        raise ValueError(f"no pos2rba build for device {n_arr.device}")
    return pos2rba_plain(n_arr, all_p, n)


def build_fused_mem_index(ix: MoveIndex,
                          device: DeviceLike = None) -> FusedMemIndex:
    """The v1 table on `device`: the search records and skip rows built
    on the host and moved there, pos2rba built there (up to
    POS2RUN_MAX_N rows)."""
    dev = resolve_device(device)
    r, sigma = ix.r, ix.sigma
    assert bytes(ix.alphabet) == b"ACGT", (
        "the MEM v1 engine requires the ACGT alphabet (complement is "
        "index reversal)")
    assert int(ix.n_arr[ix.end_bwt_idx]) == 1, (
        "the '$' run must be a single row")
    n = int(ix.all_p[-1])
    assert n < (1 << 31), "absolute positions are int32"
    si = build_fused_search_index(ix).to(dev)
    P_tab, U_tab = build_skip_tables(ix)
    skip = np.stack([P_tab, U_tab.astype(np.int64)], axis=2)
    pos2rba = None
    if n <= POS2RUN_MAX_N:
        n_arr = torch.from_numpy(ix.n_arr.astype(np.int32)).to(dev)
        pos2rba = build_pos2rba(n_arr, si.all_p, n)
    return FusedMemIndex(
        si=si, n=n, pos2rba=pos2rba,
        skip_rec=torch.from_numpy(skip.reshape(sigma * r, 2)
                                  .astype(np.int32)).to(dev))


def _resolve(all_p: torch.Tensor, abs_pos: torch.Tensor):
    """(run, offset) of absolute BWT rows: searchsorted over all_p."""
    r = all_p.shape[0] - 1
    run = torch.searchsorted(all_p, abs_pos, right=True).to(torch.int32) - 1
    return run, abs_pos - all_p[run.clamp(0, r).to(torch.int64)]


def _resolve_mi(mi: FusedMemIndex, abs_pos: torch.Tensor):
    """The reposition: one pos2rba row where the table exists (rows
    clipped: lanes that do not use the result carry any position), else
    the binary search.  Returns (run, offset, bytes loaded per lane)."""
    if mi.pos2rba is not None:
        row = mi.pos2rba[abs_pos.clamp(0, mi.n - 1).to(torch.int64)]
        return row[:, 0], abs_pos - row[:, 1], 8
    run, off = _resolve(mi.all_p64, abs_pos)
    return run, off, 4 * find_run_loads(mi.si.r)


def find_run_loads(r: int) -> int:
    """The dependent loads of a binary search over all_p [r+1]: its
    halvings and the offset's row (csrc/compact.cuh find_run)."""
    loads, length = 1, r + 1
    while length > 1:
        length -= length >> 1
        loads += 1
    return loads


def _count(all_p: torch.Tensor, rs, os_, re, oe):
    r = all_p.shape[0] - 1
    return (all_p[re.clamp(0, r).to(torch.int64)] + oe
            - all_p[rs.clamp(0, r).to(torch.int64)] - os_ + 1)


def _extend_bidir(mi: FusedMemIndex, s, o, a):
    """One extend_bidirectional per lane (fused_mem.py _extend_bidir):
    backward-step the interval s with char a, advance the interval o by
    the skip count.  Returns (ok, new s, new o, table bytes a kernel
    loads: the step's two records where a is legal, and on success the
    two skip rows, three all_p rows and two repositions)."""
    si = mi.si
    sigma, r = si.sigma, si.r
    srs, sos, sre, soe = s
    ors, oos = o[0], o[1]
    nrs, nos, nre, noe, empty = fused_bs_step(si.rec_all, r, sigma, srs,
                                              sos, sre, soe, a)
    ok = ~empty
    t = (sigma - 1 - a).clamp(0, sigma - 1).to(torch.int64)
    sr_s = mi.skip_rec[t * r + srs.clamp(0, r - 1)]
    sr_e = mi.skip_rec[t * r + sre.clamp(0, r - 1)]
    skip = (sr_e[:, 0] + sr_e[:, 1] * (soe + 1)
            - sr_s[:, 0] - sr_s[:, 1] * sos)
    new_cnt = _count(mi.all_p64, nrs, nos, nre, noe)
    start = mi.all_p64[ors.clamp(0, r).to(torch.int64)] + oos + skip
    n_ors, n_oos, res_bytes = _resolve_mi(mi, start)
    n_ore, n_ooe, _ = _resolve_mi(mi, start + new_cnt - 1)
    nbytes = (torch.where(a >= 0, 32, 0)
              + torch.where(ok, 16 + 12 + 2 * res_bytes, 0))
    return ok, (nrs, nos, nre, noe), (n_ors, n_oos, n_ore, n_ooe), nbytes


def _comp(c: torch.Tensor, sigma: int) -> torch.Tensor:
    """The search char of extend_right for a read char: its complement;
    an unknown char other than '#' (-1) complements to 'A', '#' (-3) to
    none."""
    return torch.where(c >= 0, sigma - 1 - c, torch.where(c == -1, 0, -1))


def _enter_mem(st, m, L: int):
    """The BML start state (fused_mem.py make_mem_state): INIT for a read
    at least L long, else DONE; every other register 0."""
    return enter(st, MEM1_STATE_KEYS,
                 (torch.where(m >= L, INIT, DONE),) + (0,) * 11)


def init_pair(mi: FusedMemIndex, c0: torch.Tensor):
    """init_bidirectional at a char: fw from c0 (the canonical empty
    interval (1, 0, 0, 0) when illegal), rc from its complement."""
    where = torch.where
    init_rec, sigma = mi.si.init_rec, mi.si.sigma
    legal = c0 >= 0
    fw = init_interval(init_rec, c0)
    c0r = _comp(c0, sigma)
    rc = init_interval(init_rec, c0r)
    rlegal = c0r >= 0
    empty = (1, 0, 0, 0)
    return (tuple(where(legal, v, e).to(torch.int32)
                  for v, e in zip(fw, empty)),
            tuple(where(rlegal, v, e).to(torch.int32)
                  for v, e in zip(rc, empty)))


def _enter_all_mem(mi: FusedMemIndex, alphas, m, st):
    """The all-MEMs start state (the jitted make_state of fused_mem.py
    FusedAllMemEngine.query_batch): init_bidirectional at the first char,
    ml = 1, RIGHT (done for an empty read)."""
    fw, rc = init_pair(mi, alphas[:, 0])
    return enter(st, AM1_STATE_KEYS,
                 (torch.where(m > 0, AM_RIGHT, AM_DONE), 0, 1, 0) + fw + rc)


def _mem_tick(mi: FusedMemIndex, alphas, m, st, L: int, lane_idx, ends,
              counts):
    """One lockstep BML tick of every lane (fused_mem.py _mem_scan's
    tick, in its order); adds the emissions into ends and counts and
    returns the new registers and the table bytes each lane's kernel
    thread loads."""
    si = mi.si
    sigma, r = si.sigma, si.r
    W = alphas.shape[1]
    where = torch.where
    phase, pos, jc, end = st["phase"], st["pos"], st["jc"], st["end"]
    f = tuple(st[k] for k in MEM1_STATE_KEYS[4:8])
    rc = tuple(st[k] for k in MEM1_STATE_KEYS[8:])

    def char_at(p):
        return alphas[lane_idx, p.clamp(0, W - 1).to(torch.int64)]

    # ---- INIT: anchor the window, init bidirectional
    is_init = phase == INIT
    past_end = pos + L > m
    c0 = char_at(pos + L - 1)
    i_f = init_interval(si.init_rec, c0)
    i_r = init_interval(si.init_rec, where(c0 >= 0, sigma - 1 - c0, -1))
    do_init = is_init & ~past_end & (c0 >= 0)
    # an illegal window-end char: the fw init interval is empty, so the
    # first extend_left fails at j=0 and the scan re-anchors at pos+L-1
    init_illegal = is_init & ~past_end & (c0 < 0)
    f = tuple(where(do_init, i, c) for i, c in zip(i_f, f))
    rc = tuple(where(do_init, i, c) for i, c in zip(i_r, rc))
    jc = where(do_init, 0, jc)
    phase = where(do_init, BACK, phase)
    phase = where(is_init & past_end, DONE, phase)
    pos = where(init_illegal, pos + L - 1, pos)

    # ---- one backward step, phase-selected: BACK seq[pos+L-2-jc] on fw
    # (a bidirectional extension), FWD comp(seq[jc]) on rc, NEXT
    # seq[end-1-jc] on fw
    in_back = phase == BACK
    in_fwd = phase == FWD
    in_next = phase == NEXT
    c_back = char_at(pos + L - 2 - jc)
    c_fwd = where(jc >= m, -1, _comp(char_at(jc), sigma))
    # the NEXT scan is bounded: jc <= end - pos - 2
    exhausted = in_next & (jc > end - pos - 2)
    c_next = where(exhausted, -1, char_at(end - 1 - jc))
    a = where(in_back, c_back, where(in_fwd, c_fwd,
                                     where(in_next, c_next, -1)))
    iv = tuple(where(in_fwd, x, y) for x, y in zip(rc, f))
    ok, nxt, n_rc, ext_bytes = _extend_bidir(mi, iv, rc, a)
    ok = ok & (in_back | in_fwd | in_next)
    nbytes = where(in_back, ext_bytes, where(a >= 0, 32, 0))

    # ---- BACK: extend_left bookkeeping (fw steps, rc repositioned)
    back_ok = in_back & ok
    f2 = tuple(where(back_ok, n, c) for n, c in zip(nxt, f))
    rc2 = tuple(where(back_ok, n, c) for n, c in zip(n_rc, rc))
    back_fail = in_back & ~ok
    pos2 = where(back_fail, pos + L - 1 - jc, pos)
    phase2 = where(back_fail, INIT, phase)
    jc2 = where(back_ok, jc + 1, jc)
    back_done = back_ok & (jc2 >= L - 1)
    phase2 = where(back_done, FWD, phase2)
    jc2 = where(back_done, pos + L, jc2)

    # ---- FWD: plain steps on rc; emit on failure
    fwd_ok = in_fwd & ok
    rc2 = tuple(where(fwd_ok, n, c) for n, c in zip(nxt, rc2))
    jc2 = where(fwd_ok, jc + 1, jc2)
    fwd_fail = in_fwd & ~ok
    at = pos.clamp(0, W - 1).to(torch.int64)
    ends[lane_idx, at] += where(fwd_fail, jc, 0)
    counts[lane_idx, at] += where(fwd_fail, _count(mi.all_p64, *rc), 0)
    nbytes = nbytes + where(fwd_fail, 8, 0)
    end2 = where(fwd_fail, jc, end)
    at_read_end = fwd_fail & (jc >= m)
    phase2 = where(fwd_fail, NEXT, phase2)
    phase2 = where(at_read_end, DONE, phase2)
    # NEXT init: fw = init(seq[end]), jc = 0; an illegal char there makes
    # the first NEXT step fail with jc = 0, so pos = end
    go_next = fwd_fail & ~at_read_end
    c_end = char_at(end2)
    f2 = tuple(where(go_next, i, c) for i, c in
               zip(init_interval(si.init_rec, c_end), f2))
    jc2 = where(go_next, 0, jc2)
    next_init_illegal = go_next & (c_end < 0)

    # ---- NEXT: backward-scan to the next candidate
    next_ok = in_next & ok
    f2 = tuple(where(next_ok, n, c) for n, c in zip(nxt, f2))
    jc2 = where(next_ok, jc + 1, jc2)
    stop = in_next & ~ok
    pos2 = where(stop, end - jc, pos2)
    pos2 = where(next_init_illegal, end2, pos2)
    phase2 = where(stop | next_init_illegal, INIT, phase2)

    regs = (phase2, pos2, jc2, end2) + f2 + rc2
    return ({key: v.to(torch.int32) for key, v in zip(MEM1_STATE_KEYS, regs)},
            nbytes)


def _all_mem_tick(mi: FusedMemIndex, alphas, m, st, lane_idx, ends, counts):
    """One lockstep all-MEMs tick of every lane (fused_mem.py
    _all_mem_scan's tick, in its order)."""
    sigma = mi.si.sigma
    W = alphas.shape[1]
    where = torch.where
    phase, s, ml, e = st["phase"], st["s"], st["ml"], st["e"]
    f = tuple(st[k] for k in AM1_STATE_KEYS[4:8])
    rc = tuple(st[k] for k in AM1_STATE_KEYS[8:])

    def char_at(p):
        return alphas[lane_idx, p.clamp(0, W - 1).to(torch.int64)]

    in_right = phase == AM_RIGHT
    in_left = phase == AM_LEFT
    # RIGHT: extend_right(seq[s+ml]) = extend_bidirectional on rc with the
    # complemented char; LEFT: extend_left(seq[e-ml]) on fw
    a_right = where(s + ml < m, _comp(char_at(s + ml), sigma), -1)
    a_left = where(e - ml >= 0, char_at(e - ml), -1)
    a = where(in_right, a_right, where(in_left, a_left, -1))
    step = tuple(where(in_right, x, y) for x, y in zip(rc, f))
    oth = tuple(where(in_right, x, y) for x, y in zip(f, rc))
    ok, n_s, n_o, nbytes = _extend_bidir(mi, step, oth, a)
    right_ok = in_right & ok
    left_ok = in_left & ok
    f2 = tuple(where(right_ok, o, where(left_ok, x, c))
               for o, x, c in zip(n_o, n_s, f))
    rc2 = tuple(where(right_ok, x, where(left_ok, o, c))
                for o, x, c in zip(n_o, n_s, rc))
    ml2 = where(right_ok | left_ok, ml + 1, ml)

    # RIGHT termination: emit (s, s+ml, count(fw)) at s; the count is 0
    # while fw is the canonical empty interval (the oracle's count)
    right_stop = in_right & ~ok
    at = s.clamp(0, W - 1).to(torch.int64)
    ends[lane_idx, at] += where(right_stop, s + ml, 0)
    counts[lane_idx, at] += where(right_stop,
                                  _count(mi.all_p64, *f).clamp(min=0), 0)
    nbytes = nbytes + where(right_stop, 8, 0)
    e2 = where(right_stop, s + ml, e)
    at_end = right_stop & (s + ml >= m)
    phase2 = where(at_end, AM_DONE, phase)
    # re-anchor: init at e, ml = 1, left-extend
    reanchor = right_stop & ~at_end
    i_f, i_r = init_pair(mi, char_at(e2))
    f2 = tuple(where(reanchor, i, c) for i, c in zip(i_f, f2))
    rc2 = tuple(where(reanchor, i, c) for i, c in zip(i_r, rc2))
    ml2 = where(reanchor, 1, ml2)
    phase2 = where(reanchor, AM_LEFT, phase2)
    # LEFT termination: the next MEM starts at e - ml + 1
    left_stop = in_left & ~ok
    s2 = where(left_stop, e - ml + 1, s)
    phase2 = where(left_stop, AM_RIGHT, phase2)
    regs = (phase2, s2, ml2, e2) + f2 + rc2
    return ({key: v.to(torch.int32) for key, v in zip(AM1_STATE_KEYS, regs)},
            nbytes)


def mem_tick_cap(W: int) -> int:
    """The most ticks a lane may take: the JAX engines' budget of W
    quanta of 4W+64 ticks."""
    return W * (4 * W + 64)


def _require_done(st, done: int, ticks: int):
    if bool((st["phase"] != done).any()):
        raise RuntimeError(f"MEM scan did not converge within {ticks} "
                           f"ticks")


def mem_ticks_plain(mi: FusedMemIndex, alphas: torch.Tensor, state, L: int,
                    ticks: int):
    """Plain PyTorch BML machine: the start state of each ENTRY lane, then
    up to `ticks` lockstep ticks from state (MEM1_STATE_KEYS, ends and
    counts) over alphas [lanes, W] read-order slots (-1 illegal, -3 '#',
    -2 past the read).  Returns (state, work int32 [2, lanes]: each
    lane's ticks and table bytes)."""
    al = alphas.to(torch.int32)
    m = _read_lengths(al)
    lane_idx = torch.arange(al.shape[0], device=al.device)
    return _lockstep(
        lambda st, ends, counts: _mem_tick(mi, al, m, st, L, lane_idx, ends,
                                           counts),
        _enter_mem(state, m, L), DONE, ticks, al.device)


def all_mem_ticks_plain(mi: FusedMemIndex, alphas: torch.Tensor, state,
                        ticks: int):
    """Plain PyTorch all-MEMs machine: the start state of each ENTRY
    lane, then up to `ticks` lockstep ticks from state (AM1_STATE_KEYS,
    ends and counts).  Returns (state, work)."""
    al = alphas.to(torch.int32)
    m = _read_lengths(al)
    lane_idx = torch.arange(al.shape[0], device=al.device)
    return _lockstep(
        lambda st, ends, counts: _all_mem_tick(mi, al, m, st, lane_idx,
                                               ends, counts),
        _enter_all_mem(mi, al, m, state), AM_DONE, ticks, al.device)


def mem_scan_plain(mi: FusedMemIndex, alphas: torch.Tensor, state, L: int,
                   ticks: int):
    """The plain BML machine run to convergence within `ticks` ticks
    (raises past them).  Returns (state, work)."""
    st, work = mem_ticks_plain(mi, alphas, state, L, ticks)
    _require_done(st, DONE, ticks)
    return st, work


def all_mem_scan_plain(mi: FusedMemIndex, alphas: torch.Tensor, state,
                       ticks: int):
    """The plain all-MEMs machine run to convergence within `ticks`
    ticks.  Returns (state, work)."""
    st, work = all_mem_ticks_plain(mi, alphas, state, ticks)
    _require_done(st, AM_DONE, ticks)
    return st, work


def kernel_tables(mi: FusedMemIndex):
    """The table arguments of kernels 13b and 13c."""
    si = mi.si
    return (si.rec_all, si.init_rec, mi.all_p64, mi.skip_rec, mi.pos2rba,
            si.r, si.sigma, mi.n)


def mem_scan(mi: FusedMemIndex, alphas: torch.Tensor, state, L: int,
             ticks: int):
    """The BML machine to convergence: kernel 13b on a CUDA tensor, the
    plain version on a CPU tensor."""
    if alphas.device.type == "cuda":
        return kernels.mem1_scan(*kernel_tables(mi), alphas, state, L,
                                 ticks)
    if alphas.device.type != "cpu":
        raise ValueError(f"no scan for device {alphas.device}")
    return mem_scan_plain(mi, alphas, state, L, ticks)


def all_mem_scan(mi: FusedMemIndex, alphas: torch.Tensor, state,
                 ticks: int):
    """The all-MEMs machine to convergence: kernel 13c on a CUDA tensor,
    the plain version on a CPU tensor."""
    if alphas.device.type == "cuda":
        return kernels.all_mem1_scan(*kernel_tables(mi), alphas, state,
                                     ticks)
    if alphas.device.type != "cpu":
        raise ValueError(f"no scan for device {alphas.device}")
    return all_mem_scan_plain(mi, alphas, state, ticks)


class _MemEngine:
    keys: Tuple[str, ...]   # the machine's registers

    def __init__(self, mi: FusedMemIndex, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.mi = mi.to(self.device)

    def slots(self, batch: ReadBatch) -> torch.Tensor:
        """int8 read-order slots [lanes, W] on the device (-1 illegal,
        -3 '#', -2 past the read): the kernels read them as they are."""
        amap = self.mi.si.alphamap_query.copy()
        amap[ord("#")] = -3  # '#' complements to itself (never matches)
        return torch.from_numpy(left_aligned_slots(batch, amap)
                                .astype(np.int8)).to(self.device)

    def prepare(self, batch: ReadBatch):
        """(slots, the state before entry, the tick budget) of a batch on
        the device."""
        return (self.slots(batch),
                entry_state(self.keys, batch.lanes, batch.width,
                            self.device), mem_tick_cap(batch.width))

    def query_batch_device(self, batch: ReadBatch):
        """(ends, counts int32 [lanes, W], work int32 [2, lanes]: each
        lane's ticks and table bytes) on the device."""
        st, work = self.scan(*self.prepare(batch))
        return st["ends"], st["counts"], work

    def query_batch(self, batch: ReadBatch
                    ) -> List[List[Tuple[int, int, int]]]:
        """Per read: [(pos, end, count)] in ascending position order."""
        ends, counts, _ = self.query_batch_device(batch)
        return mem_lists(ends.cpu().numpy(), counts.cpu().numpy())


class FusedMemEngine(_MemEngine):
    """Batched MEMs (BML, min_mem_length >= 2) on the v1 table.  Results
    identical to AdvancedEngine.query_mems(seq, L)."""
    keys = MEM1_STATE_KEYS

    def __init__(self, mi: FusedMemIndex, min_mem_length: int,
                 device: DeviceLike = None):
        assert min_mem_length >= 2, "use FusedAllMemEngine for L <= 1"
        super().__init__(mi, device)
        self.L = min_mem_length

    def scan(self, al: torch.Tensor, state, cap: int):
        """The BML machine to convergence on prepare's output (raises past
        the budget): (state, work)."""
        return mem_scan(self.mi, al, state, self.L, cap)


class FusedAllMemEngine(_MemEngine):
    """Batched all-MEMs (min_mem_length <= 1) on the v1 table.  Results
    identical to AdvancedEngine.query_all_mems."""
    keys = AM1_STATE_KEYS

    def scan(self, al: torch.Tensor, state, cap: int):
        """The all-MEMs machine to convergence on prepare's output:
        (state, work)."""
        return all_mem_scan(self.mi, al, state, cap)
