"""SA entries (query --pml --sa-entries): each base's PML and its
suffix-array value.

Port of movi_tpu/engine/fused_sa.py.  The reference emits one SA value per
base: after the match/reposition step and BEFORE the LF step, it LF-walks
from the current (run, offset) to the nearest sampled row and adds the
walk distance (get_SA_entries, move_structure.cpp:35-48).  The value is
path-dependent (a walk crossing the '$' row keeps adding distance, so
values can exceed n), so bit-exactness needs the same pre-LF state:
`pre_tab` gives the reposition target before its LF per (run, char), and
on the match and illegal paths the pre-LF state is the carry itself.

Kernels 8a and 8b (csrc/fused_sa.cu) on a CUDA tensor, their plain
PyTorch versions below on a CPU tensor:
  - 8a, the pre-state scan: the one-step PML scan that also emits each
    base's pre-LF (run, offset);
  - 8b, the SA pass (`sa_entries`): the SA value of a (run, offset) is its
    LF walk to a row whose absolute position is a multiple of `rate`, the
    sampled SA there plus the steps (`sa_walk_steps_plain`, the flat walk
    of every element, defines it).  The carry after step t is LF(pre_t),
    and a step t+1 on the LF path (ml[t+1] > 0, or the illegal code
    sigma) walks from it, so where row(pre_t) is not sampled SA(t) =
    SA(t+1) + 1.  Three launches: `sa_mark` (sampled rows, links, and a
    list of the other elements, the anchors), `sa_walk` over the anchors
    only, `sa_fill` (each link from its successor, backward along t).
Positions and SA values are int64 throughout (`all_p`, `sampled`, the
walk's output), so they do not wrap for texts of 2^31 bases and more.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .. import kernels
from ..device import DeviceLike, resolve_device
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch, make_batches
from .fused import (BIT_USE_LF, FA_MASK, FB_MASK, FB_SHIFT, FusedIndex,
                    FusedPMLEngine, fused_step_math, initial_state)

SA_LINK = -2    # the steps sa_mark gives an element its successor resolves
SA_ANCHOR = -3  # ... and an element the walk resolves


@dataclass
class FusedSAIndex:
    fi: FusedIndex
    # pre_tab[i*slots + a] = (up_run, dn_run, n[up_run] - 1): the
    # reposition target BEFORE its LF; the slot-sigma row is unused
    # (illegal chars keep the carry state)
    pre_tab: torch.Tensor       # int32 [r*(sigma+1), 3]
    all_p: torch.Tensor         # int64 [r]: each run's first position
    sampled: torch.Tensor       # int64 [n/rate + 1]: SA at p % rate == 0
    rate: int
    n: int

    def to(self, device) -> "FusedSAIndex":
        return replace(self, fi=self.fi.to(device),
                       pre_tab=self.pre_tab.to(device),
                       all_p=self.all_p.to(device),
                       sampled=self.sampled.to(device))


def build_fused_sa_index(ix: MoveIndex, fi: FusedIndex) -> FusedSAIndex:
    """The side tables of the SA path (numpy; the same pre_tab bytes as
    the JAX builder's), as host tensors beside `fi`."""
    assert ix.sampled_SA is not None, "index has no sampled SA"
    r, sigma = ix.r, ix.sigma
    slots = sigma + 1
    nu, nd = ix.next_tables()
    n64 = ix.n_arr.astype(np.int64)
    pre = np.zeros((r, slots, 3), dtype=np.int64)
    for a in range(sigma):
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[a, :-1]
        dn[:-1] = nd[a, 1:]
        up_c = np.where(up < r, up, 0)
        dn_c = np.where(dn < r, dn, 0)
        pre[:, a, 0] = up_c
        pre[:, a, 1] = dn_c
        pre[:, a, 2] = n64[up_c] - 1
    return FusedSAIndex(
        fi=fi,
        pre_tab=torch.from_numpy(pre.reshape(r * slots, 3).astype(np.int32)),
        all_p=torch.from_numpy(ix.all_p[:-1].astype(np.int64)),
        sampled=torch.from_numpy(np.asarray(ix.sampled_SA, dtype=np.int64)),
        rate=int(ix.sa_sample_rate), n=int(ix.length))


def pml_pre_state_scan_plain(records: torch.Tensor, pre_tab: torch.Tensor,
                             slots: int, p_dollar, alphas_t: torch.Tensor,
                             state):
    """Plain PyTorch pre-state scan over alphas_t [W, lanes] (slots) from
    state (idx, off, ml) int32 [lanes].  Returns (state, ml, pre_idx,
    pre_off), the last three int32 [W, lanes]."""
    W, lanes = alphas_t.shape
    dev = alphas_t.device
    ml, pre_idx, pre_off = (torch.empty((W, lanes), dtype=torch.int32,
                                        device=dev) for _ in range(3))
    alphas = alphas_t.to(torch.int64)
    for t in range(W):
        idx, off, _ = state
        key = idx.to(torch.int64) * slots + alphas[t]
        rec = records[key]
        pt = pre_tab[key]
        fb = (rec[:, 1] >> FB_SHIFT) & FB_MASK
        lf_path = ((rec[:, 1] >> BIT_USE_LF) & 1) == 1
        down = off >= fb
        rep_idx = torch.where(down, pt[:, 1], pt[:, 0])
        rep_off = torch.where(down, 0, pt[:, 2])
        pre_idx[t] = torch.where(lf_path, idx, rep_idx)
        pre_off[t] = torch.where(lf_path, off, rep_off)
        state, ml[t] = fused_step_math(rec, state, p_dollar)
    return state, ml, pre_idx, pre_off


def pml_pre_state_scan(records: torch.Tensor, pre_tab: torch.Tensor,
                       slots: int, p_dollar, alphas_t: torch.Tensor, state):
    """The pre-state scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if records.device.type == "cuda":
        return kernels.fused_sa_pre_scan(records, pre_tab, slots, p_dollar,
                                         alphas_t, state)
    if records.device.type != "cpu":
        raise ValueError(f"no scan for device {records.device}")
    return pml_pre_state_scan_plain(records, pre_tab, slots, p_dollar,
                                    alphas_t, state)


def sa_walk_steps_plain(records: torch.Tensor, slots: int,
                        all_p: torch.Tensor, sampled: torch.Tensor, rate: int,
                        max_steps: int, idx: torch.Tensor, off: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch SA walk: every flat (run, offset) int32 takes plain LF
    steps with a bounded fast-forward (the illegal-char record slot) until
    its absolute position is a multiple of rate.  Returns the int64 SA
    values sampled[pos / rate] + steps, and the steps.  Each pass steps
    only the elements still walking.  From a valid state the LF cycle
    reaches row 0 within the text length, so a walk past max_steps (a bad
    state) stops with the value -1, as in the kernel."""
    sigma = slots - 1
    idx = idx.to(torch.int64, copy=True)
    off = off.to(torch.int64, copy=True)
    dist = torch.zeros_like(idx)
    live = torch.arange(idx.numel(), device=idx.device)
    while live.numel():
        walking = ((all_p[idx[live]] + off[live]) % rate != 0) & \
            (dist[live] < max_steps)
        live = live[walking]
        if not live.numel():
            break
        rec = records[idx[live] * slots + sigma].to(torch.int64)
        fa = rec[:, 1] & FA_MASK
        fb = (rec[:, 1] >> FB_SHIFT) & FB_MASK
        off0 = fa + off[live]
        ff = (off0 >= fb).to(torch.int64)
        idx[live] = rec[:, 0] + ff
        off[live] = off0 - ff * fb
        dist[live] += 1
    pos = all_p[idx] + off
    sa = torch.where(pos % rate == 0, sampled[pos // rate] + dist, -1)
    return sa, dist


def sa_walk_plain(records: torch.Tensor, slots: int, all_p: torch.Tensor,
                  sampled: torch.Tensor, rate: int, max_steps: int,
                  idx: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """The plain SA walk's values (sa_walk_steps_plain without the steps)."""
    return sa_walk_steps_plain(records, slots, all_p, sampled, rate,
                               max_steps, idx, off)[0]


def sa_mark_plain(all_p: torch.Tensor, sampled: torch.Tensor, rate: int,
                  pre_idx: torch.Tensor, pre_off: torch.Tensor,
                  ml: torch.Tensor, codes: torch.Tensor, sigma: int):
    """Plain version of kernel 8b's element pass over [W, lanes]: returns
    (out int64, sampled[row / rate] where the row is sampled and 0
    elsewhere; steps int64: 0 sampled, SA_LINK where step t+1 matched or
    read sigma, SA_ANCHOR elsewhere; the anchors' flat indices int64, in
    order)."""
    row = all_p[pre_idx.to(torch.int64)] + pre_off
    hit = row % rate == 0
    nxt = torch.zeros_like(hit)
    nxt[:-1] = (ml[1:] > 0) | (codes[1:].to(torch.int64) == sigma)
    out = torch.where(hit, sampled[torch.where(hit, row // rate, 0)], 0)
    dist = torch.where(hit, 0, torch.where(nxt, SA_LINK, SA_ANCHOR))
    return out, dist, torch.nonzero(dist.reshape(-1) == SA_ANCHOR)[:, 0]


def sa_fill_plain(out: torch.Tensor, dist: torch.Tensor,
                  max_steps: int) -> torch.Tensor:
    """Plain version of kernel 8b's fill: each element takes the value
    and steps of the first element at or after it (along t) that is no
    link, plus the distance; -1 where those steps are -1 or pass
    max_steps.  Step W-1 is never a link."""
    W, lanes = dist.shape
    t = torch.arange(W, device=dist.device).unsqueeze(1).expand(W, lanes)
    end = torch.where(dist == SA_LINK, W, t)
    end = torch.flip(torch.cummin(torch.flip(end, [0]), 0).values, [0])
    gap = end - t
    d = dist.gather(0, end)
    return torch.where((d < 0) | (d + gap > max_steps), -1,
                       out.gather(0, end) + gap)


def sa_entries_plain(records: torch.Tensor, slots: int, all_p: torch.Tensor,
                     sampled: torch.Tensor, rate: int, max_steps: int,
                     pre_idx: torch.Tensor, pre_off: torch.Tensor,
                     ml: torch.Tensor, codes: torch.Tensor
                     ) -> Tuple[torch.Tensor, Dict[str, int]]:
    """Plain version of kernel 8b's three launches on kernel 8a's [W,
    lanes] outputs: the SA values int64 [W, lanes], equal to
    sa_walk_steps_plain's on every element, and the tallies {elements,
    sampled, links, anchors, anchor_steps, longest} (longest: the
    longest anchor walk)."""
    out, dist, anchors = sa_mark_plain(all_p, sampled, rate, pre_idx,
                                       pre_off, ml, codes, slots - 1)
    vals, steps = sa_walk_steps_plain(
        records, slots, all_p, sampled, rate, max_steps,
        pre_idx.reshape(-1)[anchors], pre_off.reshape(-1)[anchors])
    out.view(-1)[anchors] = vals
    dist.view(-1)[anchors] = torch.where(vals == -1, -1, steps)
    tally = {"elements": dist.numel(), "sampled": int((dist == 0).sum()),
             "links": int((dist == SA_LINK).sum()),
             "anchors": anchors.numel(), "anchor_steps": int(steps.sum()),
             "longest": int(steps.max()) if anchors.numel() else 0}
    return sa_fill_plain(out, dist, max_steps), tally


def sa_entries(records: torch.Tensor, slots: int, all_p: torch.Tensor,
               sampled: torch.Tensor, rate: int, max_steps: int,
               pre_idx: torch.Tensor, pre_off: torch.Tensor, ml: torch.Tensor,
               codes: torch.Tensor) -> torch.Tensor:
    """The SA values int64 [W, lanes] of kernel 8a's outputs pre_idx,
    pre_off, ml int32 and the codes uint8 [W, lanes]: kernel 8b's mark,
    walk and fill on a CUDA tensor (no host sync), the plain version on a
    CPU tensor."""
    if records.device.type == "cuda":
        marked = kernels.sa_mark(all_p, sampled, rate, pre_idx, pre_off, ml,
                                 codes, slots - 1)
        kernels.sa_walk(records, slots, all_p, sampled, rate, max_steps,
                        pre_idx, pre_off, marked)
        return kernels.sa_fill(marked[0], marked[1], max_steps)
    if records.device.type != "cpu":
        raise ValueError(f"no SA pass for device {records.device}")
    return sa_entries_plain(records, slots, all_p, sampled, rate, max_steps,
                            pre_idx, pre_off, ml, codes)[0]


class FusedSAEngine:
    """Batched PMLs and per-base SA entries on one device: a pre-state
    scan and an SA pass (mark, anchor walk, fill) per batch."""

    def __init__(self, fi: FusedIndex, ix: MoveIndex,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.sx = build_fused_sa_index(ix, fi).to(self.device)
        self.pml = FusedPMLEngine(self.sx.fi, self.device)

    def query_batch_device(self, batch: ReadBatch
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ml int32, sa int64), each [W, lanes], padding included."""
        sx, fi = self.sx, self.sx.fi
        slots = fi.sigma + 1
        alphas_t = self.pml.prepare(batch)
        state = initial_state(fi, alphas_t.shape[1], self.device)
        _, ml, pre_idx, pre_off = pml_pre_state_scan(
            fi.records, sx.pre_tab, slots, fi.p_dollar, alphas_t, state)
        return ml, sa_entries(fi.records, slots, sx.all_p, sx.sampled,
                              sx.rate, sx.n, pre_idx, pre_off, ml, alphas_t)

    def query_batch(self, batch: ReadBatch
                    ) -> List[Tuple[List[int], List[int]]]:
        ml, sa = self.query_batch_device(batch)
        ml = ml.cpu().numpy()
        sa = sa.cpu().numpy()
        return [(ml[:int(L), lane].tolist(), sa[:int(L), lane].tolist())
                for lane, L in enumerate(batch.lengths)]

    def query(self, reads: Sequence[Tuple[str, bytes]], lanes: int = 8192
              ) -> List[Tuple[str, Tuple[List[int], List[int]]]]:
        """[(name, (pmls, sas))] for (name, seq) reads, in batches of
        `lanes` as wide as their longest read."""
        out = []
        for batch in make_batches(list(reads), lanes=lanes,
                                  bucket_widths=False):
            out.extend(zip(batch.names, self.query_batch(batch)))
        return out
