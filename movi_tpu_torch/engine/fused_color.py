"""One-step Movi Color: PML plus each base's color id, and the host tally.

Port of movi_tpu/engine/fused_color.py.  Multi-class classification
(move_structure_query.cpp:373-470, read_processor.cpp:122-186) votes, per
base, for the documents of the run the LF step lands on.  The device scan
emits each base's matching length and that run's color id; the host
tallies the votes per read and formats the CSV cell.

Record layout (int32 [r*(sigma+1), 3], built only when C+1 <= 0xFFFF for
C kept doc sets): words 0-1 are the one-step PML record of engine/fused.py,
word 2 packs the color ids of the two possible destinations, lo (bits
0-15: the LF target m, or the reposition-up target) and hi (bits 16-31:
m+1 after a fast-forward, or the reposition-down target).  The selector
takes hi when `fa + offset >= fb` on the LF path or `offset >= fb` on the
reposition path, with the offset from before the step.  Bit 31 of word 2
is set once a color id reaches 2^15: decodes mask after every shift.
Without the 3-word records (more kept sets than 16 bits hold) the scan
reads the 8 B PML record and then `doc_set_inds[new_idx]`.

The scan runs the hand-written CUDA kernel (csrc/fused_color.cu) on a
CUDA tensor and the plain PyTorch version below on a CPU tensor.  Early
stop (--early-stop, read_processor.cpp:240-250) runs inside the scan: a
lane carries (csum, stop) and leaves its loop at the reference's stop
point or at its read's end; rows past that are zero.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from movi_tpu.color import ColorTable, format_multiclass_cell
from movi_tpu.index.structure import MoveIndex
from movi_tpu.io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .fused import (BIT_BUMP, BIT_DOLLAR_DN, BIT_DOLLAR_UP, BIT_USE_LF,
                    FA_MASK, FB_MASK, FB_SHIFT, FusedIndex,
                    build_fused_index, fused_step_math, initial_state)

LOG4 = math.log(4)
MAX_PACKED_COLORS = 0xFFFF  # C+1 must fit 16 bits for packed color ids


@dataclass
class FusedColorIndex:
    fi: FusedIndex
    doc_set_inds: torch.Tensor  # int32 [r], clamped to C
    num_colors: int             # C, the kept unique doc sets
    # int32 [r*(sigma+1), 3]; None when C+1 exceeds 16 bits
    records3: Optional[torch.Tensor] = None

    def to(self, device) -> "FusedColorIndex":
        return replace(self, fi=self.fi.to(device),
                       doc_set_inds=self.doc_set_inds.to(device),
                       records3=(None if self.records3 is None
                                 else self.records3.to(device)))


def build_fused_color_index(ix: MoveIndex, ct: ColorTable,
                            fi: Optional[FusedIndex] = None
                            ) -> FusedColorIndex:
    """The 3-word color records (numpy, the same bytes as movi_tpu's
    build_fused_color_index) on the host; fi's records may lie on any
    device."""
    if fi is None:
        fi = build_fused_index(ix)
    C = len(ct.unique_doc_sets)
    cids = np.minimum(ct.doc_set_inds, C).astype(np.int64)
    records3 = None
    if C + 1 <= MAX_PACKED_COLORS:
        r, slots = ix.r, ix.sigma + 1
        rec = fi.records.cpu().numpy().astype(np.int64).reshape(r, slots, 2)
        w0, w1 = rec[:, :, 0], rec[:, :, 1]
        use_lf = (w1 >> BIT_USE_LF) & 1
        bump = (w1 >> BIT_BUMP) & 1
        d_up = (w1 >> BIT_DOLLAR_UP) & 1
        d_dn = (w1 >> BIT_DOLLAR_DN) & 1
        pd_run = fi.p_dollar[0]
        lo = np.where(use_lf == 1, w0, np.where(d_up == 1, pd_run, w0))
        hi = np.where(use_lf == 1, w0 + 1,
                      np.where(d_dn == 1, pd_run, w0 + bump))
        # unreachable candidates may be out of range: clip, never selected
        wc = (cids[np.clip(lo, 0, r - 1)]
              | (cids[np.clip(hi, 0, r - 1)] << 16))
        rec3 = np.concatenate([rec, wc[:, :, None]], axis=2)
        records3 = torch.from_numpy(
            rec3.reshape(r * slots, 3).astype(np.int32))
    return FusedColorIndex(fi=fi,
                           doc_set_inds=torch.from_numpy(
                               cids.astype(np.int32)),
                           num_colors=C, records3=records3)


def es_update(csum: torch.Tensor, live: torch.Tensor, ml: torch.Tensor, t,
              lens: torch.Tensor):
    """One base of the early-stop rule for the live lanes: add the
    emitted ml (int64 csum) and, at the reference's checkpoints (past the
    midpoint, every 100 bases), retire a lane whose running PML mean is
    below the classification threshold.  t is the global base step (int
    or int64 [lanes]).  Returns (csum, hit)."""
    csum = torch.where(live, csum + ml.to(torch.int64), csum)
    L = lens.to(torch.int64)
    p1 = L - 2 - t
    chk = (p1 >= 0) & (2 * p1 < L) & (p1 % 100 == 0)
    return csum, live & chk & (5 * csum < 2 * (L - p1))


def color_state(fi, lanes: int, device, early_stop: bool):
    """The scan state at the start of every read: (idx, off, ml), plus
    (csum int64, stop int32) under early stop."""
    st = initial_state(fi, lanes, device)
    if not early_stop:
        return st
    return st + (torch.zeros((lanes,), dtype=torch.int64, device=device),
                 torch.zeros((lanes,), dtype=torch.int32, device=device))


def fused_color_scan_plain(records: torch.Tensor, slots: int, p_dollar,
                           alphas_t: torch.Tensor, state, cids=None,
                           lens=None, t0: int = 0):
    """Plain PyTorch one-step color scan over alphas_t [W, lanes].
    records: int32 [rows, 3], or the [rows, 2] PML records with cids
    int32 [r].  state: (idx, off, ml), plus (csum, stop) with lens (int32
    [lanes], early stop; t0 is the global step of row 0, stop the rows a
    retired lane scanned, 0 while it runs).  Returns (state, ml, cid),
    both [W, lanes] int32."""
    W, lanes = alphas_t.shape
    dev = alphas_t.device
    es = lens is not None
    fill = torch.zeros if es else torch.empty
    ml = fill((W, lanes), dtype=torch.int32, device=dev)
    cid = fill((W, lanes), dtype=torch.int32, device=dev)
    alphas = alphas_t.to(torch.int64)
    core = tuple(state[:3])
    if es:
        csum, stop = state[3], state[4]
    for t in range(W):
        idx, offset, _ = core
        rec = records[idx.to(torch.int64) * slots + alphas[t]]
        new_core, m = fused_step_math(rec, core, p_dollar)
        if cids is None:
            w1 = rec[:, 1]
            fa = w1 & FA_MASK
            fb = (w1 >> FB_SHIFT) & FB_MASK
            hi = torch.where(((w1 >> BIT_USE_LF) & 1) == 1,
                             fa + offset >= fb, offset >= fb)
            wc = rec[:, 2]
            c = torch.where(hi, (wc >> 16) & 0xFFFF, wc & 0xFFFF)
        else:
            c = cids[new_core[0].to(torch.int64)]
        if not es:
            core = new_core
            ml[t], cid[t] = m, c
            continue
        live = (stop == 0) & (t0 + t < lens)
        core = tuple(torch.where(live, n, o) for n, o in zip(new_core, core))
        ml[t] = torch.where(live, m, 0)
        cid[t] = torch.where(live, c, 0)
        csum, hit = es_update(csum, live, m, t0 + t, lens)
        stop = torch.where(hit, t0 + t + 1, stop).to(torch.int32)
    state = core + ((csum, stop) if es else ())
    return state, ml, cid


def fused_color_scan(records: torch.Tensor, slots: int, p_dollar,
                     alphas_t: torch.Tensor, state, cids=None, lens=None,
                     t0: int = 0):
    """The one-step color scan: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if records.device.type == "cuda":
        return kernels.fused_color_scan(records, slots, p_dollar, alphas_t,
                                        state, cids, lens, t0)
    if records.device.type != "cpu":
        raise ValueError(f"no scan for device {records.device}")
    return fused_color_scan_plain(records, slots, p_dollar, alphas_t, state,
                                  cids, lens, t0)


def early_stop_len(pmls: np.ndarray, L: int) -> int:
    """Bases processed under the reference's early-stop rule (the host
    rule of the JAX package, in int64): past the read midpoint, every 100
    bases, stop when the running PML mean is below the classification
    threshold.  Step t reads position L-1-t; the check uses p1 = L-2-t."""
    if L <= 0:
        return L
    csum = np.cumsum(pmls.astype(np.int64))
    t = np.arange(L)
    p1 = L - 2 - t
    chk = (p1 >= 0) & (2 * p1 < L) & (p1 % 100 == 0)
    hits = np.flatnonzero(chk & (5 * csum < 2 * (L - p1)))
    return int(hits[0]) + 1 if len(hits) else L


class ColorTally:
    """The host half of Movi Color: per read, the vote tally over the
    emitted (ml, color id) streams and the CSV cell (a numpy copy of the
    JAX package's FusedColorEngine._tally).  The reference's online
    (best, second) tracking is order-dependent under ties; it is rebuilt
    from each document's final count and the global step of its last vote
    (step = base * max_set_width + member position)."""

    def __init__(self, ct: ColorTable, min_match_len: int = 0,
                 pvalue_scoring: bool = False, report_all: bool = False,
                 min_diff_frac: float = 0.05, min_score_frac: float = 0.0,
                 early_stop: bool = False):
        self.ct = ct
        self.min_match_len = min_match_len
        self.pvalue_scoring = pvalue_scoring
        self.report_all = report_all
        self.min_diff_frac = min_diff_frac
        self.min_score_frac = min_score_frac
        self.early_stop = early_stop
        self.di = ct.doc_info
        self.C = len(ct.unique_doc_sets)
        self.max_w = max((len(s) for s in ct.unique_doc_sets), default=1)
        # padded member table; row C is the compressed-away sentinel
        self.set_tab = np.full((self.C + 1, self.max_w), -1, dtype=np.int32)
        for i, s in enumerate(ct.unique_doc_sets):
            self.set_tab[i, :len(s)] = s

    def results(self, ml: torch.Tensor, color: torch.Tensor,
                batch: ReadBatch) -> List[Tuple[List[int], str, List[int]]]:
        """Per lane: (pmls, csv_cell, color ids for --report-colors), the
        streams truncated at the early-stop point when it is on."""
        ml = ml.cpu().numpy()
        color = color.cpu().numpy()
        out = []
        for lane in range(batch.lanes):
            L = int(batch.lengths[lane])
            pmls = ml[:L, lane]
            cids = color[:L, lane]
            if self.early_stop:
                n = early_stop_len(pmls, L)
                pmls, cids = pmls[:n], cids[:n]
            cell, rep_colors = self.tally(pmls, cids, L)
            out.append((pmls.tolist(), cell, rep_colors))
        return out

    def tally(self, pmls: np.ndarray, cids: np.ndarray, L: int
              ) -> Tuple[str, List[int]]:
        S = self.di.num_species
        counted = pmls >= self.min_match_len
        colors_count = int(np.count_nonzero(counted))
        kept = counted & (cids < self.C)
        steps = np.flatnonzero(kept)
        # kept color id per counted base, sentinel C for skipped bases,
        # nothing for compressed-away ones (read_processor.cpp:128-186)
        rep_colors = np.where(kept, cids, self.C)[kept | ~counted].tolist()
        members = self.set_tab[cids[steps]]           # [votes, max_w]
        valid = members >= 0
        docs = members[valid]
        pos_steps = ((steps * self.max_w)[:, None]
                     + np.arange(self.max_w)[None, :])
        vote_steps = np.broadcast_to(pos_steps, members.shape)[valid]

        if self.pvalue_scoring:
            mls_per_vote = np.broadcast_to(
                pmls[steps][:, None], members.shape)[valid]
            val = mls_per_vote - self.di.log_lens[docs] / LOG4
            w = np.where(val >= 0, np.minimum(val, 1.0), 0.0)
            vals = np.zeros(S)
            np.add.at(vals, docs, w)
            # scores grow only on val >= 0 votes: `last` is the final
            # score-raising vote
            last = np.full(S, -1, dtype=np.int64)
            np.maximum.at(last, docs[val >= 0], vote_steps[val >= 0])
            voted = vals > 0
        else:
            vals = np.zeros(S, dtype=np.int64)
            np.add.at(vals, docs, 1)
            last = np.full(S, -1, dtype=np.int64)
            np.maximum.at(last, docs, vote_steps)
            voted = vals > 0

        best = second = -1
        if voted.any():
            M = vals[voted].max()
            cand = np.flatnonzero(voted & (vals == M))
            best = int(cand[np.argmin(last[cand])])
            rest = voted.copy()
            rest[best] = False
            if rest.any():
                M2 = vals[rest].max()
                cand2 = np.flatnonzero(rest & (vals == M2))
                second = int(cand2[np.argmin(last[cand2])])

        pml_mean = float(pmls.sum()) / max(L, 1)
        cell = format_multiclass_cell(
            vals, best, second, colors_count, pml_mean, self.di,
            report_all=self.report_all, min_diff_frac=self.min_diff_frac,
            min_score_frac=self.min_score_frac)
        return cell, rep_colors


def scanned_rows(state, lens: torch.Tensor, W: int) -> int:
    """The most rows any lane scanned under early stop: a retired lane's
    stop count, else its read length, at most W."""
    stop = state[4]
    rows = torch.where(stop > 0, stop, lens)
    return min(int(rows.max()), W) if rows.numel() else 0


class FusedColorEngine:
    """Batched multi-class classification at one record load per base
    (two dependent loads without the 3-word records); a batch of any
    width is one scan."""

    def __init__(self, ci: FusedColorIndex, ct: ColorTable,
                 device: DeviceLike = None, **color_kw):
        self.device = resolve_device(device)
        self.ci = ci.to(self.device)
        self.host = ColorTally(ct, **color_kw)
        self.last_scanned_rows = 0

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Read slots in scan order as uint8 [W, lanes] on the device."""
        alphas = self.ci.fi.alphamap_query[batch.seqs[:, ::-1]]
        return torch.from_numpy(
            np.ascontiguousarray(alphas.T).astype(np.uint8)).to(self.device)

    def scan_args(self, batch: ReadBatch):
        """(records, slots, p_dollar, alphas_t, state, cids, lens) of the
        batch's scan from the start of every read."""
        ci = self.ci
        alphas_t = self.prepare(batch)
        es = self.host.early_stop
        lens = (torch.from_numpy(batch.lengths.astype(np.int32))
                .to(self.device) if es else None)
        state = color_state(ci.fi, alphas_t.shape[1], self.device, es)
        if ci.records3 is not None:
            records, cids = ci.records3, None
        else:
            records, cids = ci.fi.records, ci.doc_set_inds
        return (records, ci.fi.sigma + 1, ci.fi.p_dollar, alphas_t, state,
                cids, lens)

    def query_batch_device(self, batch: ReadBatch):
        """(ml, color) int32 [W, lanes] on the device."""
        args = self.scan_args(batch)
        state, ml, color = fused_color_scan(*args)
        W = ml.shape[0]
        self.last_scanned_rows = (scanned_rows(state, args[-1], W)
                                  if self.host.early_stop else W)
        return ml, color

    def query_batch(self, batch: ReadBatch):
        """Per lane: (pmls, csv_cell, per-base color ids)."""
        return self.host.results(*self.query_batch_device(batch), batch)
