"""K-mer membership and exact k-mer counts on the one-step search records.

Port of movi_tpu/engine/fused_kmer.py.  Membership (query_all_kmers) is a
per-lane tick machine over the search records: each lane carries its
anchor pos, cursor cur, probe cursor pc, the probe flags pok and pinit,
its phase (0 anchor, 1 extending, 2 done, 3 probing) and its interval.
One tick is a backward-search step, a re-anchor, or a probe step.  A
finished match stretch [cur, pos] emits found = pos - cur - k + 2 k-mers
at start position cur, then re-anchors at cur + k - 2.  Before anchoring
a full stretch, the look-ahead probe backward-searches from pos - step
(step = k/3); if it cannot cover k-1 positions the machine skips step+1
positions.  With ftab anchors (rows appended to the search table, engine
fused_search), stretch anchors and probe inits read the position's fk-mer
interval in one row and jump fk chars; emissions are unchanged.

Exact counts run one lane per k-mer: init from its last char, then k-1
backward-search steps.  The kernels (csrc/fused_kmer.cu) run on CUDA
tensors; the plain PyTorch versions below run on CPU tensors and keep the
JAX functions' interfaces ([lanes, W(+W)] slots and lockstep ticks for
membership, [k, nk] windows for counts) so the tests compare them with
the JAX package directly.  The membership kernel runs each lane until it
is done (a done lane's tick changes nothing, so this equals the JAX
package's lockstep scan and its compaction loop); a lane still running
after (2k+8)(2W+64) ticks is an error, not a partial answer.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..io.fastx import ReadBatch, left_aligned_slots

from .. import kernels
from ..device import DeviceLike, resolve_device
from .fused_mem2 import prep_alc
from .fused_search import (FusedSearchIndex, _lf_from_rec, fused_bs_step,
                           init_interval)

# the membership machine's per-lane registers, in the kernel's row order
KMER_STATE_KEYS = kernels.KMER_STATE_KEYS
ANCHOR, EXTEND, DONE, PROBE = 0, 1, 2, 3


def make_kmer_state(lanes: int, W: int, lengths: torch.Tensor, k: int
                    ) -> Dict[str, torch.Tensor]:
    """The machine's start state on lengths' device: every lane anchors
    at its last position, or is done when it is shorter than k."""
    pos = lengths.to(torch.int32) - 1
    st = {key: torch.zeros_like(pos) for key in KMER_STATE_KEYS}
    st["phase"] = torch.where(pos >= k - 1, ANCHOR, DONE).to(torch.int32)
    st["pos"] = pos
    st["out"] = torch.zeros((lanes, W), dtype=torch.int32,
                            device=lengths.device)
    return st


def tick_cap(k: int, W: int) -> int:
    """The most ticks a lane may take: the JAX engine's resume budget
    (2k+8 quanta of 2W+64 ticks)."""
    return (2 * k + 8) * (2 * W + 64)


def _kmer_tick(si: FusedSearchIndex, alphas, codes, st, k: int,
               lane_idx, out):
    """One lockstep tick of every lane (fused_kmer.py _kmer_scan's tick);
    returns the new registers and the record rows each lane needed (a
    step's two, an ftab row, or none), and adds the emissions into out."""
    r, sigma, fk = si.r, si.sigma, si.ftab_k
    W = alphas.shape[1]
    step = k // 3
    max_len = k - step
    where = torch.where
    phase, pos, cur, pc, pok, pinit = (st[x] for x in KMER_STATE_KEYS[:6])
    rs, os_, re, oe = (st[x] for x in KMER_STATE_KEYS[6:])

    in_anchor = phase == ANCHOR
    extending = phase == EXTEND
    probing = phase == PROBE
    pi = probing & (pinit == 1)
    # anchor char at pos, probe-init char at pc, probe step at pc-1,
    # stretch step at cur-1
    p_sel = where(in_anchor, pos, where(probing, where(pi, pc, pc - 1),
                                        cur - 1))
    p = p_sel.clamp(0, W - 1).to(torch.int64)
    c_sel = alphas[lane_idx, p]

    # anchoring lanes: decide, or start a probe
    pos1 = where(in_anchor & (c_sel < 0), pos - 1, pos)
    legal = in_anchor & (c_sel >= 0) & (pos1 >= k - 1)
    if step >= 1:
        eligible = legal & (pos1 >= k - 1 + step) & (pok == 0)
    else:
        eligible = torch.zeros_like(legal)
    anchored = legal & ~eligible
    pc1 = where(eligible, pos1 - step, pc)
    pinit1 = where(eligible, 1, pinit)
    phase1 = where(eligible, PROBE, where(anchored, EXTEND, phase))
    pok1 = where(anchored, 0, pok)
    cur1 = where(anchored, pos1, cur)
    phase1 = where((phase1 == ANCHOR) & (pos1 < k - 1), DONE, phase1)

    # the tick's record rows: a step's two, or one ftab anchor row
    can_step = extending & (cur1 > 0)
    can_pstep = probing & ~pi & (pc1 > 0)
    a_gate = where(can_step | can_pstep, c_sel, -1)
    a_s = a_gate.clamp(min=0).to(torch.int64)
    key_lo = a_s * r + rs.clamp(0, r - 1)
    key_hi = (sigma + a_s) * r + re.clamp(0, r - 1)
    rows = where(a_gate >= 0, 2, 0)
    if codes is not None:
        code_sel = codes[lane_idx, p]
        code_ok = code_sel >= 0
        ftl = (anchored | pi) & code_ok
        fkey = 2 * sigma * r + code_sel.clamp(min=0).to(torch.int64)
        key_lo = where(ftl, fkey, key_lo)
        key_hi = where(ftl, fkey, key_hi)
        rows = where(ftl, 1, rows)
    rd = si.rec_all[key_lo]
    ru = si.rec_all[key_hi]
    empty = (a_gate < 0) | (rd[:, 0] >= r) | (rd[:, 0] > re)
    os1 = where(rd[:, 0] != rs, 0, os_)
    oe1 = where(ru[:, 0] != re, ru[:, 3] - 1, oe)
    nrs, nos = _lf_from_rec(rd, os1)
    nre, noe = _lf_from_rec(ru, oe1)

    # interval init: the ftab row, or the char's init row
    irs, ios, ire, ioe = init_interval(si.init_rec, c_sel)
    if codes is not None:
        f_empty = ~((rd[:, 0] < rd[:, 2])
                    | ((rd[:, 0] == rd[:, 2]) & (rd[:, 1] <= rd[:, 3])))
        a_hit = anchored & code_ok & ~f_empty
        a_miss = anchored & code_ok & f_empty
        a_plain = anchored & ~code_ok
        p_hit = pi & code_ok & ~f_empty
        p_missf = pi & code_ok & f_empty       # the probe fails at once
        p_plain = pi & ~code_ok & (c_sel >= 0)
        do_row = a_hit | p_hit
        do_plain = a_plain | p_plain
        rs = where(do_row, rd[:, 0], where(do_plain, irs, rs))
        os_ = where(do_row, rd[:, 1], where(do_plain, ios, os_))
        re = where(do_row, rd[:, 2], where(do_plain, ire, re))
        oe = where(do_row, rd[:, 3], where(do_plain, ioe, oe))
        # a stretch hit jumps the cursor; a miss advances the anchor by
        # one (the ftab-less stretch would die inside the span and
        # re-anchor the same way)
        cur1 = where(a_hit, pos1 - fk + 1, cur1)
        pos1 = where(a_miss, pos1 - 1, pos1)
        phase1 = where(a_miss, where(pos1 >= k - 1, ANCHOR, DONE), phase1)
        pc1 = where(p_hit, pc1 - (fk - 1), pc1)
        pinit1 = where(p_hit | p_plain, 0, pinit1)
        pi_fail = (pi & (c_sel < 0)) | p_missf
    else:
        do_init = anchored | (pi & (c_sel >= 0))
        rs = where(do_init, irs, rs)
        os_ = where(do_init, ios, os_)
        re = where(do_init, ire, re)
        oe = where(do_init, ioe, oe)
        pinit1 = where(pi & (c_sel >= 0), 0, pinit1)
        pi_fail = pi & (c_sel < 0)

    # commit the step
    step_ok = can_step & ~empty
    pstep_ok = can_pstep & ~empty
    moved = step_ok | pstep_ok
    rs = where(moved, nrs, rs)
    os_ = where(moved, nos, os_)
    re = where(moved, nre, re)
    oe = where(moved, noe, oe)
    cur2 = where(step_ok, cur1 - 1, cur1)
    pc2 = where(pstep_ok, pc1 - 1, pc1)

    # probe termination (the look-ahead's backward search loop)
    plen = (pos1 - step) - pc2
    probe_end = (probing & ~pi
                 & (~can_pstep | (can_pstep & empty)
                    | (pstep_ok & (plen > max_len)))) | pi_fail
    passed = pos1 - pc2 >= k - 1
    pok2 = where(probe_end & passed, 1, pok1)
    pos2 = where(probe_end & ~passed, pos1 - step - 1, pos1)
    phase2 = where(probe_end, ANCHOR, phase1)
    phase2 = where(probe_end & ~passed & (pos2 < k - 1), DONE, phase2)

    # a stretch ends at a failed step or at position 0
    terminated = extending & ~step_ok
    matched = pos1 - cur2
    emit = terminated & (matched >= k - 1)
    out[lane_idx, cur2.clamp(0, W - 1).to(torch.int64)] += where(
        emit, matched - k + 2, 0)
    # the new anchor: cur + k - 2 after a success, pos - 1 otherwise
    new_pos = where(emit, cur2 + k - 2, pos1 - 1)
    pos2 = where(terminated, new_pos, pos2)
    phase2 = where(terminated, where(new_pos >= k - 1, ANCHOR, DONE), phase2)
    regs = (phase2, pos2, cur2, pc2, pok2, pinit1, rs, os_, re, oe)
    return ({key: v.to(torch.int32) for key, v in zip(KMER_STATE_KEYS, regs)},
            rows)


def kmer_scan_plain(si: FusedSearchIndex, alc: torch.Tensor, state,
                    k: int, ticks: int, use_ftab: bool = False):
    """Plain PyTorch membership machine: `ticks` lockstep ticks from
    state (the keys of make_kmer_state) over alc, int32 [lanes, W] slots
    or, with use_ftab, [lanes, 2W] slots and fk-mer codes (prep_alc).
    Stops early once every lane is done (later ticks change nothing).
    Returns (state, work int32 [2, lanes]: the ticks each lane ran before
    it was done and the 16 B record rows it loaded)."""
    W = alc.shape[1] // 2 if use_ftab else alc.shape[1]
    alphas, codes = alc[:, :W], (alc[:, W:] if use_ftab else None)
    lanes = alphas.shape[0]
    lane_idx = torch.arange(lanes, device=alc.device)
    st = {key: v.clone() for key, v in state.items()}
    out = st.pop("out")
    work = torch.zeros((2, lanes), dtype=torch.int32, device=alc.device)
    for t in range(ticks):
        if t % 64 == 0 and bool((st["phase"] == DONE).all()):
            break
        live = st["phase"] != DONE
        st, rows = _kmer_tick(si, alphas, codes, st, k, lane_idx, out)
        work[0] += live.to(torch.int32)
        work[1] += torch.where(live, rows, 0).to(torch.int32)
    st["out"] = out
    return st, work


def kmer_scan(si: FusedSearchIndex, alc: torch.Tensor, state, k: int,
              ticks: int, use_ftab: bool = False):
    """The membership machine: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if alc.device.type == "cuda":
        return kernels.kmer_member_scan(si.rec_all, si.init_rec, si.r,
                                        si.sigma, si.ftab_k, alc, state, k,
                                        ticks, use_ftab)
    if alc.device.type != "cpu":
        raise ValueError(f"no scan for device {alc.device}")
    return kmer_scan_plain(si, alc, state, k, ticks, use_ftab)


def count_result(all_p: torch.Tensor, rs, os_, re, oe, found):
    """(found, count): the interval's size (int32, wrapping like the JAX
    engines), 0 where the k-mer was not found."""
    r = all_p.shape[0] - 1
    cnt = (all_p[re.clamp(0, r).to(torch.int64)] + oe
           - all_p[rs.clamp(0, r).to(torch.int64)] - os_ + 1)
    return found, torch.where(found, cnt, 0).to(torch.int32)


def kmer_count_scan_plain(rec_all, init_rec, all_p, r: int, sigma: int,
                          alphas: torch.Tensor, k: int):
    """Plain PyTorch exact counts, one lane per k-mer: alphas int32
    [k, nk] in k-mer order (row 0 the first char).  Init from the last
    char, then k-1 backward-search steps.  Returns (found bool [nk],
    count int32 [nk])."""
    a = alphas.to(torch.int32)
    legal = (a >= 0).all(dim=0)
    rs, os_, re, oe = init_interval(init_rec, a[k - 1])
    dead = ~legal
    for j in range(k - 2, -1, -1):
        nrs, nos, nre, noe, empty = fused_bs_step(rec_all, r, sigma, rs, os_,
                                                  re, oe, a[j])
        ok = ~dead & ~empty
        rs, os_, re, oe = (torch.where(ok, n, c) for n, c in
                           zip((nrs, nos, nre, noe), (rs, os_, re, oe)))
        dead = dead | empty
    return count_result(all_p, rs, os_, re, oe, ~dead & legal)


def kmer_windows(slots: torch.Tensor, lane: torch.Tensor,
                 start: torch.Tensor, k: int) -> torch.Tensor:
    """int32 [k, nk]: the chars of each k-mer, slots[lane, start + j]."""
    j = torch.arange(k, device=slots.device)[:, None]
    return slots[lane.to(torch.int64)[None, :],
                 start.to(torch.int64)[None, :] + j].to(torch.int32)


def kmer_count_scan(si: FusedSearchIndex, slots: torch.Tensor,
                    lane: torch.Tensor, start: torch.Tensor, k: int):
    """Exact counts of the k-mers at (lane, start) of the read-order
    slots int8 [lanes, W]: the CUDA kernel on a CUDA tensor (which reads
    each window from the slots), the plain version over the [k, nk]
    windows on a CPU tensor.  Returns (found, count)."""
    if slots.device.type == "cuda":
        return kernels.kmer_count_scan(si.rec_all, si.init_rec, si.all_p,
                                       si.r, si.sigma, slots, lane, start, k)
    if slots.device.type != "cpu":
        raise ValueError(f"no scan for device {slots.device}")
    return kmer_count_scan_plain(si.rec_all, si.init_rec, si.all_p, si.r,
                                 si.sigma, kmer_windows(slots, lane, start, k),
                                 k)


def kmer_starts(batch: ReadBatch, amap, k: int):
    """(read-order slots int32 [lanes, W] with -1 past each read, owner
    lane, start) of every k-mer window of the batch, or None when it has
    none."""
    W = batch.width
    if W < k:
        return None
    al = left_aligned_slots(batch, amap, fill=-1)
    starts = np.arange(W - k + 1, dtype=np.int64)[None, :]
    valid = starts + k <= batch.lengths.astype(np.int64)[:, None]
    own, pos = np.nonzero(valid)
    if len(own) == 0:
        return None
    return al, own, pos


def batch_kmer_windows(batch: ReadBatch, amap, k: int):
    """([k, nk] int32 window chars, [nk] owner lanes) of every k-mer
    window, as the JAX package's batch_kmer_windows gives them, or
    (None, None)."""
    found = kmer_starts(batch, amap, k)
    if found is None:
        return None, None
    al, own, pos = found
    w = np.lib.stride_tricks.sliding_window_view(al, k, axis=1)
    return np.ascontiguousarray(w[own, pos].T).astype(np.int32), own


def count_kmers(batch: ReadBatch, amap, k: int, device: torch.device,
                scan) -> List[Tuple[int, int]]:
    """Per read (found k-mers, total occurrences): scan(slots, lane,
    start) counts every window on `device`; the per-read sums are int64."""
    found = kmer_starts(batch, amap, k)
    if found is None:
        return [(0, 0)] * batch.lanes
    al, own, pos = found

    def up(x, dtype):
        return torch.from_numpy(x.astype(dtype)).to(device)

    lane = up(own, np.int32)
    hit, cnt = scan(up(al, np.int8), lane, up(pos, np.int32))
    sums = torch.zeros((2, batch.lanes), dtype=torch.int64, device=device)
    sums[0].index_add_(0, lane, hit.to(torch.int64))
    sums[1].index_add_(0, lane, cnt.to(torch.int64))
    f, t = sums.tolist()
    return list(zip(f, t))


class FusedKmerCountEngine:
    """Exact k-mer counts, one lane per k-mer, on the one-step search
    records.  Results identical to AdvancedEngine.count_kmers_bidirectional."""

    def __init__(self, si: FusedSearchIndex, k: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.si = si.to(self.device)
        self.k = k

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        """Per read: (found_kmers, total_counts)."""
        return count_kmers(
            batch, self.si.alphamap_query, self.k, self.device,
            lambda s, l, p: kmer_count_scan(self.si, s, l, p, self.k))


def kmer_spans(out: np.ndarray) -> List[List[Tuple[int, int]]]:
    """Per lane, the (start position, found count) of every nonzero of
    its emission row, in descending position order."""
    lanes_i, pos_i = np.nonzero(out)
    vals = out[lanes_i, pos_i].tolist()
    bounds = np.searchsorted(lanes_i, np.arange(out.shape[0] + 1)).tolist()
    pos_l = pos_i.tolist()
    return [list(zip(pos_l[a:b][::-1], vals[a:b][::-1]))
            for a, b in zip(bounds, bounds[1:])]


class FusedKmerEngine:
    """K-mer membership (query_all_kmers) on the one-step search records,
    with ftab anchors when the index carries them and fk <= k - k/3 (the
    bound under which a probe whose fk-suffix is absent can fail at
    once)."""

    def __init__(self, si: FusedSearchIndex, k: int,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.si = si.to(self.device)
        self.k = k
        fk = si.ftab_k
        self.use_ftab = 1 < fk <= k - k // 3

    def prepare(self, batch: ReadBatch):
        """(alc, start state) on the device: int8 slots shipped, widened
        (and fk-mer codes appended) by prep_alc."""
        al8 = left_aligned_slots(batch, self.si.alphamap_query,
                                 fill=-1).astype(np.int8)
        alc = prep_alc(torch.from_numpy(al8).to(self.device),
                       self.si.ftab_k if self.use_ftab else 0)
        lengths = torch.from_numpy(batch.lengths.astype(np.int32))
        return alc, make_kmer_state(batch.lanes, batch.width,
                                    lengths.to(self.device), self.k)

    def query_batch_device(self, batch: ReadBatch):
        """(emissions int32 [lanes, W], work int32 [2, lanes]: ticks and
        record rows per lane) on the device."""
        alc, state = self.prepare(batch)
        cap = tick_cap(self.k, batch.width)
        st, work = kmer_scan(self.si, alc, state, self.k, cap,
                             self.use_ftab)
        if bool((st["phase"] != DONE).any()):
            raise RuntimeError(f"k-mer membership scan did not finish "
                               f"within {cap} ticks")
        return st["out"], work

    def query_batch(self, batch: ReadBatch) -> List[List[Tuple[int, int]]]:
        """Per read: [(kmer_start_pos, found_count)] in descending
        position order, identical to AdvancedEngine.query_all_kmers."""
        return kmer_spans(self.query_batch_device(batch)[0].cpu().numpy())
