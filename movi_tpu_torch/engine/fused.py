"""One-step PML layout: one 8 B step record per (run, read slot).

Port of movi_tpu/engine/fused.py.  The record builder is numpy and writes
the same bytes as the JAX package's, and the `fused_records.npz` cache is
the same format, so both packages share one cache.  The scan runs the
hand-written CUDA kernel (csrc/fused_pml.cu) on a CUDA tensor and the
plain PyTorch version below on a CPU tensor.

Record layout (int32 [r*(sigma+1), 2]):
  w0: main run id m -- the LF destination (match/illegal) or the
      reposition anchor run (mismatch)
  w1: fa (bits 0-11) | fb (12-23) | bump (24) | is_match (25)
      | use_lf (26) | dollar_up (27) | dollar_dn (28)
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch

from ..constants import ALPHAMAP_3, SEPARATOR
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device

FA_MASK = 0xFFF          # bits 0-11
FB_SHIFT = 12            # bits 12-23
FB_MASK = 0xFFF
BIT_BUMP = 24
BIT_MATCH = 25
BIT_USE_LF = 26
BIT_DOLLAR_UP = 27
BIT_DOLLAR_DN = 28
CUM_GUARD = 0xFFF        # fb value meaning "no fast forward" (id == r-1)
# fields are 12-bit; run lengths, offsets and thresholds stay under this
MAX_FIELD_N = 2047


@dataclass
class FusedIndex:
    r: int
    sigma: int
    records: torch.Tensor       # int32 [r*(sigma+1), 2]
    start_idx: int              # initial run (r-1)
    start_offset: int           # initial offset (n[r-1]-1)
    p_dollar: Tuple[int, int]   # (run, offset) after repositioning onto
                                # the '$' run + LF+ff (static per index)
    alphamap_query: np.ndarray  # host-side: byte -> slot (sigma = illegal)

    def to(self, device) -> "FusedIndex":
        return replace(self, records=self.records.to(device))


def is_bounded(ix: MoveIndex) -> bool:
    """True when every LF fast-forward is at most one run (bound_ff=1)."""
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
    e = lf_abs + ix.n_arr - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    return int((id_end - ix.id_arr).max()) <= 1


def build_thr_full(ix: MoveIndex) -> np.ndarray:
    """Dense per-(row, read-char) threshold table: bakes in ALPHAMAP_3 slot
    selection, the '$' row (end_bwt_idx_thresholds) and separator rows.
    Same table as movi_tpu/engine/device_index.py build_thr_full."""
    r, sigma = ix.r, ix.sigma
    thr_full = np.zeros((r, sigma), dtype=np.int32)
    c_eff = ix.c_arr.astype(np.int64)
    sep_index = int(ix.alphamap[SEPARATOR]) if ix.separators else -1
    for a in range(sigma):
        if ix.separators:
            if a == sep_index:
                continue  # never queried (check_alphabet rejects '%')
            slot_of_row = ALPHAMAP_3[np.maximum(c_eff - 1, 0), a - 1]
        else:
            slot_of_row = ALPHAMAP_3[c_eff, a]
        vals = np.where(slot_of_row < 3,
                        np.take_along_axis(
                            ix.thr, np.minimum(slot_of_row, 2)[:, None],
                            axis=1).ravel(),
                        0)
        thr_full[:, a] = vals
    # '$' row
    e = ix.end_bwt_idx
    for a in range(sigma):
        ai = a - 1 if ix.separators else a
        if ix.separators and a == sep_index:
            continue
        if 0 <= ai < len(ix.end_bwt_idx_thresholds):
            thr_full[e, a] = ix.end_bwt_idx_thresholds[ai]
    # separator rows (the '$' row's thresholds live in
    # end_bwt_idx_thresholds)
    if ix.separators and ix.sep_row_map:
        for row, k in ix.sep_row_map.items():
            if row == ix.end_bwt_idx:
                continue
            for a in range(sigma):
                if a == sep_index:
                    continue
                thr_full[row, a] = ix.sep_thresholds[k][a - 1]
    return thr_full


def build_fused_index(ix: MoveIndex) -> FusedIndex:
    """Precompute the per-(run, char) step records on the host (records
    come back as a CPU tensor).  Requires an index built with bound_ff=1
    (NT splitting) and thresholds."""
    assert ix.thr is not None, "fused engine requires a thresholds mode"
    r, sigma = ix.r, ix.sigma
    n64 = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    lf_abs = all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)

    # verify the bound_ff=1 invariant
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "fused engine requires an index built with bound_ff=1")
    # 12-bit field invariants (reference `large`/`split` indexes allow
    # runs up to 65535; they must be re-split before fusing)
    assert int(n64.max()) <= MAX_FIELD_N, (
        f"fused records pack 12-bit fields; max run length {int(n64.max())} "
        f"exceeds {MAX_FIELD_N} -- rebuild the index with NT splitting")
    assert int(ix.offset_arr.max()) <= MAX_FIELD_N

    thr_full = build_thr_full(ix)          # [r, sigma]
    assert int(thr_full.max()) <= MAX_FIELD_N
    nu, nd = ix.next_tables()              # query tables ('$' row = slot 0)

    def resolve(abs_pos):
        run = np.searchsorted(all_p[:-1], abs_pos, side="right") - 1
        return run, abs_pos - all_p[run]

    ebw = ix.end_bwt_idx
    assert int(n64[ebw]) == 1, "the '$' run must have length 1"
    # P$: reposition onto the '$' run (up and down land on its one row),
    # then LF+ff
    pd_run, pd_off = resolve(int(lf_abs[ebw]))
    p_dollar = (int(pd_run), int(pd_off))

    slots = sigma + 1
    w0 = np.zeros((r, slots), dtype=np.int64)
    w1 = np.zeros((r, slots), dtype=np.int64)

    lf_off = ix.offset_arr.astype(np.int64)
    # LF_move only fast-forwards while idx < r-1
    cum1 = np.where(ix.id_arr < r - 1, n64[ix.id_arr], CUM_GUARD)
    f_id = ix.id_arr.astype(np.int64)
    w1_lf = lf_off | (cum1 << FB_SHIFT)

    sep_index = int(ix.alphamap[SEPARATOR]) if ix.separators else -1

    for a in range(sigma):
        if a == sep_index:
            # '%' slot: reads never map here; plain LF like the illegal slot
            w0[:, a] = f_id
            w1[:, a] = w1_lf | (1 << BIT_USE_LF)
            continue
        # reposition targets from the current run (reposition_up/down
        # start scanning at idx -/+ 1)
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[a, :-1]
        dn[:-1] = nd[a, 1:]
        up_dollar = up == ebw
        dn_dollar = dn == ebw
        have_up = (up < r) & ~up_dollar
        have_dn = (dn < r) & ~dn_dollar
        up_c = np.where(have_up, up, 0)
        dn_c = np.where(have_dn, dn, 0)
        # exact final state after reposition + LF + ff, per side
        up_abs = all_p[ix.id_arr[up_c]] + ix.offset_arr[up_c] + n64[up_c] - 1
        dn_abs = all_p[ix.id_arr[dn_c]] + ix.offset_arr[dn_c]
        # on mismatch rows the two neighbours' LF images are consecutive
        # occurrences of `a`: the 8-byte encoding rests on this adjacency
        is_match = (ix.c_arr.astype(np.int64) == a)
        both = have_up & have_dn & ~is_match
        assert np.all(dn_abs[both] == up_abs[both] + 1), (
            "LF adjacency violated -- index is corrupt")
        up_run, up_off = resolve(up_abs)

        # anchor: the up final when a real up exists; otherwise dn-1
        dn_run, dn_off = resolve(dn_abs)
        roll = (dn_off == 0).astype(np.int64)
        alt_m = dn_run - roll
        alt_fa = np.maximum(dn_off - 1, 0)
        m = np.where(have_up, up_run, alt_m)
        fa = np.where(have_up, up_off, alt_fa)
        bump = np.where(have_up,
                        (up_off + 1 == n64[np.minimum(up_run, r - 1)]),
                        roll).astype(np.int64)
        # with no up run at all, reposition must always go down
        no_up = ~have_up & ~up_dollar & ~is_match
        assert np.all(thr_full[no_up, a] == 0), \
            "threshold nonzero for a run with no up-neighbor"
        no_dn = ~have_dn & ~dn_dollar & ~is_match
        assert np.all(thr_full[no_dn, a].astype(np.int64) >= n64[no_dn]), \
            "threshold allows down for a run with no down-neighbor"

        w0[:, a] = np.where(is_match, f_id, m)
        w1_mis = (fa | (thr_full[:, a].astype(np.int64) << FB_SHIFT)
                  | (bump << BIT_BUMP)
                  | (up_dollar.astype(np.int64) << BIT_DOLLAR_UP)
                  | (dn_dollar.astype(np.int64) << BIT_DOLLAR_DN))
        w1_mat = w1_lf | (1 << BIT_MATCH) | (1 << BIT_USE_LF)
        w1[:, a] = np.where(is_match, w1_mat, w1_mis)

    # illegal slot: plain LF, no match
    w0[:, sigma] = f_id
    w1[:, sigma] = w1_lf | (1 << BIT_USE_LF)

    alphamap_query = np.full(256, sigma, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = sigma

    rec = np.stack([w0.reshape(-1), w1.reshape(-1)], axis=1)
    return FusedIndex(
        r=r, sigma=sigma,
        records=torch.from_numpy(rec.astype(np.int32)),
        start_idx=r - 1,
        start_offset=int(ix.n_arr[r - 1]) - 1,
        p_dollar=p_dollar,
        alphamap_query=alphamap_query,
    )


_FUSED_FMT = 2  # on-disk cache format, shared with movi_tpu


def save_fused_index(fi: FusedIndex, path: str):
    """Write fused_records.npz in the JAX package's format 2."""
    np.savez(path, records=fi.records.cpu().numpy(),
             meta=np.array([fi.r, fi.sigma, fi.start_idx, fi.start_offset,
                            fi.p_dollar[0], fi.p_dollar[1], _FUSED_FMT],
                           dtype=np.int64),
             alphamap_query=fi.alphamap_query)


def load_fused_index(path: str) -> FusedIndex:
    """Read fused_records.npz (format 2) into host tensors."""
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 7 or meta[6] != _FUSED_FMT:
        raise ValueError(
            f"{path}: stale fused-record cache (format "
            f"{meta[6] if len(meta) > 6 else 1}, need {_FUSED_FMT}); "
            f"rebuild with `build --fused-cache`")
    r, sigma, start_idx, start_offset, pd_run, pd_off = meta[:6]
    return FusedIndex(r=r, sigma=sigma,
                      records=torch.from_numpy(z["records"]),
                      start_idx=start_idx, start_offset=start_offset,
                      p_dollar=(pd_run, pd_off),
                      alphamap_query=z["alphamap_query"])


def fused_step_math(rec: torch.Tensor, state, p_dollar):
    """The PML step on an already-gathered record [lanes, 2]: LF with a
    bounded fast-forward, or a reposition to the anchor, anchor+1 or P$.
    Returns (state, ml)."""
    idx, offset, ml = state
    m = rec[:, 0]
    w1 = rec[:, 1]
    fa = w1 & FA_MASK
    fb = (w1 >> FB_SHIFT) & FB_MASK
    is_match = (w1 >> BIT_MATCH) & 1
    use_lf = (w1 >> BIT_USE_LF) & 1

    # LF path (match / illegal): bounded fast-forward via cum1 (= fb)
    off0 = fa + offset
    ff = (off0 >= fb).to(torch.int32)
    c1_run = m + ff
    c1_off = off0 - ff * fb

    # reposition path: offset >= threshold (= fb) goes down
    down = offset >= fb
    bump = (w1 >> BIT_BUMP) & 1
    d_up = (w1 >> BIT_DOLLAR_UP) & 1
    d_dn = (w1 >> BIT_DOLLAR_DN) & 1
    pd_run, pd_off = p_dollar
    up_run = torch.where(d_up == 1, pd_run, m)
    up_off = torch.where(d_up == 1, pd_off, fa)
    dn_run = torch.where(d_dn == 1, pd_run, m + bump)
    dn_off = torch.where(d_dn == 1, pd_off,
                         torch.where(bump == 1, 0, fa + 1))
    c2_run = torch.where(down, dn_run, up_run)
    c2_off = torch.where(down, dn_off, up_off)

    lf_path = use_lf == 1
    new_idx = torch.where(lf_path, c1_run, c2_run)
    new_off = torch.where(lf_path, c1_off, c2_off)
    new_ml = torch.where(is_match == 1, ml + 1, 0)
    return (new_idx, new_off, new_ml), new_ml


def fused_pml_scan_plain(records: torch.Tensor, slots: int, p_dollar,
                         alphas_t: torch.Tensor, state):
    """Plain PyTorch scan: one indexed record load per base per lane.
    alphas_t [W, lanes] slots; state (idx, off, ml) int32 [lanes].
    Returns (state, ml [W, lanes])."""
    ml = torch.empty(alphas_t.shape, dtype=torch.int32,
                     device=alphas_t.device)
    alphas = alphas_t.to(torch.int64)
    for t in range(alphas_t.shape[0]):
        rec = records[state[0].to(torch.int64) * slots + alphas[t]]
        state, ml[t] = fused_step_math(rec, state, p_dollar)
    return state, ml


def fused_pml_scan(records: torch.Tensor, slots: int, p_dollar,
                   alphas_t: torch.Tensor, state):
    """The one-step scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if records.device.type == "cuda":
        return kernels.fused_pml_scan(records, slots, p_dollar, alphas_t,
                                      state)
    if records.device.type != "cpu":
        raise ValueError(f"no scan for device {records.device}")
    return fused_pml_scan_plain(records, slots, p_dollar, alphas_t, state)


def initial_state(fi, lanes: int, device):
    """(idx, off, ml) at the start of every read."""
    return (torch.full((lanes,), fi.start_idx, dtype=torch.int32,
                       device=device),
            torch.full((lanes,), fi.start_offset, dtype=torch.int32,
                       device=device),
            torch.zeros((lanes,), dtype=torch.int32, device=device))


def trim(ml: torch.Tensor, batch: ReadBatch) -> List[List[int]]:
    """Per-read ml lists from a [W, lanes] batch result (one copy to the
    host per batch)."""
    ml = ml.cpu().numpy()
    return [ml[:int(L), lane].tolist()
            for lane, L in enumerate(batch.lengths)]


class FusedPMLEngine:
    """Batched PML at one 8 B record load per base; a batch of any width
    is one scan."""

    def __init__(self, fi: FusedIndex, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fi = fi.to(self.device)

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Read slots in scan order (right to left) as uint8 [W, lanes] on
        the device."""
        alphas = self.fi.alphamap_query[batch.seqs[:, ::-1]]  # [lanes, W]
        return torch.from_numpy(
            np.ascontiguousarray(alphas.T).astype(np.uint8)).to(self.device)

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        fi = self.fi
        slots = fi.sigma + 1
        alphas_t = self.prepare(batch)
        state = initial_state(fi, alphas_t.shape[1], self.device)
        return fused_pml_scan(fi.records, slots, fi.p_dollar, alphas_t,
                              state)[1]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)
