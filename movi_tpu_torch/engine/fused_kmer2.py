"""Exact k-mer counts on the bidirectional k/2 cache: the reference's
query_kmers_from_bidirectional as two straight-line device passes.

Port of movi_tpu/engine/fused_kmer2.py.  One bidirectional chain per
group of p = k/2 consecutive window ends, anchored at the group's
rightmost window's left end, extends RIGHT k-1 times on the MEM v2
records (kernel 11a, `kmer2_right_scan`), keeping each prefix's fw
interval in absolute coordinates.  Each window of the group then pays
only its own LEFT extensions: the depth-d partial (the window whose left
end is d chars left of the anchor) resolves its absolute interval to
(run, offset) through the pos2rba rows and takes ceil(d/2) paired left
extensions on the paired search records (kernel 11b, `kmer2_left_scan`).
Counts equal the per-window definition for any p: each group's windows
are counted once, and a chain that dies at j kills exactly the windows
containing j.

The kernels read each group's chars from the int8 read slots by (lane,
anchor), and kernel 11b's threads cover every (depth, group): a thread
whose partial is dead or past the group's windows returns at once, so no
alive flags cross to the host.  The plain PyTorch versions below keep the
JAX functions' forms ([k, G] chain chars; flat [M] partial lanes) and run
for CPU tensors.  The engine sums (found, total) per read on the device in
int64.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from ..io.fastx import ReadBatch, left_aligned_slots
from .fused_kmer import count_result, kmer_windows
from .fused_mem2 import FusedMem2Index, init6, mem2_resolve, mem2_step
from .fused_search2 import (FusedSearch2Index, bs2_decode, fused2_bs_step,
                            one_row_rule)


def kmer2_right_scan_plain(m2: FusedMem2Index, rchars: torch.Tensor,
                           k: int):
    """Phase R: per group, init at rchars[0] and extend_right with
    rchars[1..k-1] (int32 [k, G]).  Returns (alive bool [k-1, G],
    fw_abs_s, fw_abs_e int32 [k-1, G])."""
    sigma = m2.sigma
    where = torch.where
    a0 = rchars[0]
    i_f = init6(m2, a0)
    i_r = init6(m2, where(a0 >= 0, sigma - 1 - a0, -1))
    rrs, ros, rre, roe = i_r[:4]
    fas, fae = i_f[4], i_f[5]
    alive = a0 >= 0
    outs = ([], [], [])
    for c in rchars[1:]:
        a = where(c >= 0, sigma - 1 - c, -1)
        nrs, nos, nre, noe, nas, nae, skip, empty = mem2_step(
            m2, rrs, ros, rre, roe, a)
        ok = alive & ~empty
        fas2 = where(ok, fas + skip, fas)
        fae = fas2 + where(ok, nae - nas, fae - fas)
        fas = fas2
        rrs, ros, rre, roe = (where(ok, nv, cv) for nv, cv in
                              zip((nrs, nos, nre, noe), (rrs, ros, rre, roe)))
        alive = ok
        for out, v in zip(outs, (ok, fas, fae)):
            out.append(v)
    alives, fs, fe = (torch.stack(o) for o in outs)
    return alives, fs.to(torch.int32), fe.to(torch.int32)


def kmer2_left_flat_plain(m2: FusedMem2Index, s2: FusedSearch2Index, fsd,
                          fed, al, lane_own, lane_anchor, lane_depth,
                          flat_idx, S: int):
    """Phase L over flat lanes (partials of any depth): each resolves its
    abs interval (fsd, fed [k-1, G] at flat_idx) and takes S paired left
    steps over its chars al[own, anchor-1-j], padded with the -2 no-op
    sentinel past its depth; -1 (an illegal char) kills the window.  Pad
    lanes carry depth -1 (dead from the start).  Returns (found bool [M],
    count int32 [M])."""
    W = al.shape[1]
    fi = flat_idx.to(torch.int64)
    rs, os_ = mem2_resolve(m2, fsd.reshape(-1)[fi])
    re, oe = mem2_resolve(m2, fed.reshape(-1)[fi])
    dead = lane_depth < 0
    alf = al.reshape(-1).to(torch.int32)
    own_base = lane_own.to(torch.int64) * W

    def char_j(j):
        col = lane_anchor - 1 - j
        c = alf[own_base + col.clamp(0, W - 1).to(torch.int64)]
        return torch.where((j < lane_depth) & (col >= 0), c, -2)

    for jp in range(S):
        a1 = char_j(2 * jp)
        a2 = char_j(2 * jp + 1)
        l2 = a2 >= 0
        # -2 pads (a lane whose depth is shorter coasts); -1 is an
        # illegal read char, which kills the window
        pad1 = a1 == -2
        kill2 = a2 == -1
        mid, fin, e1, e2 = fused2_bs_step(
            s2.rec_all, s2.r, s2.sigma, rs, os_, re, oe,
            a1.clamp(min=0) * s2.sigma + a2.clamp(min=0), a1 >= 0, l2)
        alive = ~dead
        ok1 = alive & ~e1 & ~pad1
        ok2 = ok1 & ~e2
        dead = dead | (alive & ((~pad1 & e1) | (l2 & ~e1 & e2)
                                | (~e1 & kill2)))
        rs, os_, re, oe = (torch.where(ok2, f, torch.where(ok1, mv, cv))
                           for cv, mv, f in zip((rs, os_, re, oe), mid, fin))
    return count_result(s2.all_p, rs, os_, re, oe, ~dead)


def left_steps(p: int) -> int:
    """The paired steps of phase L: depth p-1 needs ceil((p-1)/2)."""
    return p // 2 if p > 1 else 1


def kmer2_right_scan(m2: FusedMem2Index, slots: torch.Tensor,
                     own: torch.Tensor, anchor: torch.Tensor, k: int):
    """Phase R for the groups at (own, anchor) int32 [G] of the read-order
    slots int8 [lanes, W]: the CUDA kernel on a CUDA tensor, the plain
    version over the [k, G] chain chars on a CPU tensor.  Returns (alive,
    fw_abs_s, fw_abs_e), each [k-1, G]."""
    if slots.device.type == "cuda":
        return kernels.kmer2_right_scan(m2.rec_all, m2.init_rec6, m2.r,
                                        m2.sigma, m2.n, m2.ftab_k, slots,
                                        own, anchor, k)
    if slots.device.type != "cpu":
        raise ValueError(f"no scan for device {slots.device}")
    return kmer2_right_scan_plain(m2, kmer_windows(slots, own, anchor, k), k)


def kmer2_left_scan_plain(m2: FusedMem2Index, s2: FusedSearch2Index,
                          alive, fs, fe, slots: torch.Tensor,
                          own: torch.Tensor, anchor: torch.Tensor, k: int,
                          p: int):
    """Phase L for every (depth d < p, group) through the flat form: the
    partial is live when its chain was alive after step k-2-d and
    d < p_eff = min(p, anchor+1) (the group's windows); the others are
    pad lanes.  Returns (found bool, count int32), each [p, G]."""
    G = own.shape[0]
    d = torch.arange(p, dtype=torch.int32, device=own.device)[:, None]
    live = alive.flip(0)[:p] & (d <= anchor[None, :])  # d < p_eff
    g = torch.arange(G, dtype=torch.int32, device=own.device)
    found, cnt = kmer2_left_flat_plain(
        m2, s2, fs, fe, slots, own.repeat(p), anchor.repeat(p),
        torch.where(live, d, -1).reshape(-1),
        ((k - 2 - d) * G + g).reshape(-1), left_steps(p))
    return found.reshape(p, G), cnt.reshape(p, G)


def kmer2_left_rows_plain(m2: FusedMem2Index, s2: FusedSearch2Index,
                          alive, fs, fe, slots: torch.Tensor,
                          own: torch.Tensor, anchor: torch.Tensor, k: int,
                          p: int):
    """The rows kernel 11b's pair steps need: kmer2_left_scan_plain with
    each pair step decided by kernel 7b's one-row rule.  A first char -2
    is a no-op; -1 in either char kills the partial before any row.  Where
    the interval lies in one run (rs == re) the down row alone where
    one_row_rule says it is enough (the step empty, or the end decoded from
    it) or where the second char is the pad and the first micro-step keeps
    its run (only the mid interval is kept, its end from words 0 and 3);
    else the up row too.  Returns (found bool, count int32, rows int32: the
    24 B rows each partial's pair steps need, steps int32: its pair steps),
    each [p, G].  The kernel loads both rows of every step, which was
    timed faster; chip_smoke.py counts its bound's bytes from these rows.
    Nothing on the card's path calls it."""
    G = own.shape[0]
    dev = own.device
    d = torch.arange(p, device=dev)[:, None].expand(p, G)
    live = alive.flip(0)[:p] & (d <= anchor[None, :].to(torch.int64))
    g = torch.arange(G, device=dev)[None, :].expand(p, G)
    row = ((k - 2 - d) * G + g).reshape(-1)
    rs, os_ = mem2_resolve(m2, fs.reshape(-1)[row])
    re, oe = mem2_resolve(m2, fe.reshape(-1)[row])
    W = slots.shape[1]
    base = own.to(torch.int64).repeat(p) * W
    anc = anchor.to(torch.int64).repeat(p)
    depth = d.reshape(-1)
    chars = slots.reshape(-1).to(torch.int32)
    dead = ~live.reshape(-1)
    rows = torch.zeros(p * G, dtype=torch.int32, device=dev)
    steps = torch.zeros_like(rows)
    r, sigma = s2.r, s2.sigma
    S2 = sigma * sigma

    def char_j(j):
        c = chars[base + (anc - 1 - j).clamp(min=0)]
        return torch.where(j < depth, c, -2)

    for j in range(0, p - 1, 2):
        a1, a2 = char_j(j), char_j(j + 1)
        act = ~dead & (a1 != -2)
        kill = act & ((a1 < 0) | (a2 == -1))
        step = act & ~kill
        l2 = a2 >= 0
        a12 = (a1.clamp(min=0) * sigma + a2.clamp(min=0)).to(torch.int64)
        one = rs == re
        rd = s2.rec_all[rs.clamp(0, r - 1).to(torch.int64) * S2 + a12]
        empty, stand_in = one_row_rule(rd, oe)
        stand_in = one & (stand_in | (~empty & ~l2))
        empty = one & empty
        ru = torch.where(stand_in[:, None], rd, s2.rec_all[
            (r + re.clamp(0, r - 1).to(torch.int64)) * S2 + a12])
        mid, fin, e1, e2 = bs2_decode(rd, ru, os_, oe, a1 >= 0, l2)
        e1 = e1 | empty
        rows += torch.where(step, torch.where(empty | stand_in, 1, 2), 0
                            ).to(torch.int32)
        steps += step.to(torch.int32)
        die = step & (e1 | (l2 & e2))
        keep = step & ~die
        rs, os_, re, oe = (torch.where(keep & l2, f,
                                       torch.where(keep, mv, cv))
                           for cv, mv, f in zip((rs, os_, re, oe), mid, fin))
        dead = dead | kill | die
    found, cnt = count_result(s2.all_p, rs, os_, re, oe, ~dead)
    return tuple(x.reshape(p, G) for x in (found, cnt, rows, steps))


def kmer2_left_scan(m2: FusedMem2Index, s2: FusedSearch2Index, alive, fs,
                    fe, slots: torch.Tensor, own: torch.Tensor,
                    anchor: torch.Tensor, k: int, p: int):
    """Phase L: the CUDA kernel on a CUDA tensor, the plain flat version on
    a CPU tensor.  Returns (found bool, count int32), each [p, G]."""
    if slots.device.type == "cuda":
        return kernels.kmer2_left_scan(
            m2.rec_all, m2.r, m2.sigma, m2.n, m2.ftab_k, s2.rec_all,
            s2.all_p, slots, own, anchor, alive, fs, fe, k, p)
    if slots.device.type != "cpu":
        raise ValueError(f"no scan for device {slots.device}")
    return kmer2_left_scan_plain(m2, s2, alive, fs, fe, slots, own, anchor,
                                 k, p)


def kmer2_groups(lengths: np.ndarray, k: int, p: int):
    """(owner lane, anchor) int64 of every group: read i has
    ceil((len-k+1)/p) groups, group j's rightmost window ending at
    len-1-j*p and its chain anchored at that window's left end."""
    lens = lengths.astype(np.int64)
    ng = -(-np.maximum(lens - k + 1, 0) // p)
    own = np.repeat(np.arange(len(lens)), ng)
    gi = np.arange(len(own)) - np.repeat(np.cumsum(ng) - ng, ng)
    return own, lens[own] - 1 - gi * p - k + 1


class FusedKmer2CountEngine:
    """Exact per-read k-mer (found, total) on the bidirectional cache.
    Results identical to Fused2KmerCountEngine and
    AdvancedEngine.count_kmers_bidirectional on a reverse-complement
    closed index."""

    def __init__(self, m2: FusedMem2Index, s2: FusedSearch2Index, k: int,
                 p: int = 0, device: DeviceLike = None):
        assert k >= 2
        self.device = resolve_device(device)
        self.m2 = m2.to(self.device)
        self.s2 = s2.to(self.device)
        self.k = k
        # block size: k/2 as the reference; any p gives identical counts
        # (it only moves work between the shared right chain and the
        # per-window left chains)
        self.p = min(p or k // 2, k - 1) or 1

    def prepare(self, batch: ReadBatch):
        """(slots int8 [lanes, W], own, anchor int32 [G]) on the device,
        or None when the batch has no window."""
        own, anchor = kmer2_groups(batch.lengths, self.k, self.p)
        if len(own) == 0:
            return None
        al = left_aligned_slots(batch, self.m2.alphamap_query, fill=-1)
        return tuple(torch.from_numpy(x.astype(d)).to(self.device) for x, d
                     in ((al, np.int8), (own, np.int32), (anchor, np.int32)))

    def query_batch_device(self, batch: ReadBatch):
        """int64 [2, lanes] (found, total) per read on the device."""
        sums = torch.zeros((2, batch.lanes), dtype=torch.int64,
                           device=self.device)
        prep = self.prepare(batch)
        if prep is None:
            return sums
        slots, own, anchor = prep
        alive, fs, fe = kmer2_right_scan(self.m2, slots, own, anchor, self.k)
        found, cnt = kmer2_left_scan(self.m2, self.s2, alive, fs, fe, slots,
                                     own, anchor, self.k, self.p)
        lane = own.repeat(self.p)
        sums[0].index_add_(0, lane, found.reshape(-1).to(torch.int64))
        sums[1].index_add_(0, lane, cnt.reshape(-1).to(torch.int64))
        return sums

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        """Per read: (found_kmers, total_counts)."""
        f, t = self.query_batch_device(batch).tolist()
        return list(zip(f, t))
