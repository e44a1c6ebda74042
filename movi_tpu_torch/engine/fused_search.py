"""One-step backward-search layout: count and ZML at two 16 B record loads
per base.

Port of movi_tpu/engine/fused_search.py.  The record builder is numpy and
writes the same bytes as the JAX package's.  The scans run the
hand-written CUDA kernel (csrc/fused_search.cu) on a CUDA tensor and the
plain PyTorch versions below on a CPU tensor.

Record layout (int32 [2*sigma*r, 4]): rows [0, sigma*r) are the "down"
records (interval start), rows [sigma*r, 2*sigma*r) the "up" records
(interval end).  rec[a*r + i] describes the first run >= i (down) or the
last run <= i (up) whose get_char() is a:
  w0: that run (r when there is none)
  w1: its LF destination run id
  w2: cum1 (bits 0-15, 0xFFFF when the destination is the last run)
      | its LF offset << 16
  w3: its length n
With ftab_k > 1, 4^ftab_k anchor rows follow at row 2*sigma*r: the
backward-search interval (rs, os, re, oe) of each fk-mer code, (1, 0, 0,
0) when it is absent (the k-mer membership machine's anchors).

Scan state, int32 [6, lanes]: rows (rs, os, re, oe) are the interval;
rows 4-5 are (matched, done) for count and (have, ml) for ZML.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..constants import SEPARATOR
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .fused import trim

_GUARD = 0xFFFF
BEYOND = -2          # char code past a read's end (count's -2 sentinel)


@dataclass
class FusedSearchIndex:
    r: int
    sigma: int
    rec_all: torch.Tensor       # int32 [2*sigma*r (+ 4^ftab_k), 4]
    # init_rec[a+1] = (first_run, first_offset, last_run, last_offset)
    init_rec: torch.Tensor      # int32 [sigma+1, 4]
    all_p: torch.Tensor         # int32 [r+1] (final interval counts)
    alphamap_query: np.ndarray  # host-side: byte -> char (-1 = illegal)
    ftab_k: int = 0             # anchor rows appended to rec_all if > 1

    def to(self, device) -> "FusedSearchIndex":
        return replace(self, rec_all=self.rec_all.to(device),
                       init_rec=self.init_rec.to(device),
                       all_p=self.all_p.to(device))


def search_alphamap(ix: MoveIndex) -> np.ndarray:
    """byte -> char index for backward search: illegal bytes and the
    separator map to -1 (not to sigma, as the PML slots do)."""
    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = -1
    return alphamap_query


def init_records(ix: MoveIndex) -> np.ndarray:
    """int32 [sigma+1, 4]: initialize_backward_search per char."""
    return np.stack([ix.first_runs, ix.first_offsets,
                     ix.last_runs, ix.last_offsets],
                    axis=1).astype(np.int32)


def build_fused_search_index(ix: MoveIndex,
                             ftab_k: int = 0) -> FusedSearchIndex:
    """The search records on the host (CPU tensors).  Requires an index
    built with bound_ff=1.  With ftab_k > 1 the 4^ftab_k anchor rows
    (fw-only validity, absent fk-mers canonical-empty) are appended."""
    r, sigma = ix.r, ix.sigma
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "fused search requires an index built with bound_ff=1")

    nus, nds = ix.next_tables_search()  # inclusive; '$' matches nothing

    def records(dest_tab):
        rec = np.zeros((sigma, r, 4), dtype=np.int64)
        for a in range(sigma):
            dest = dest_tab[a].astype(np.int64)
            ok = dest < r
            d = np.where(ok, dest, 0)
            idd = ix.id_arr[d]
            cum1 = np.where(idd < r - 1, n64[idd], _GUARD)
            rec[a, :, 0] = np.where(ok, dest, r)
            rec[a, :, 1] = idd
            rec[a, :, 2] = cum1 | (ix.offset_arr[d].astype(np.int64) << 16)
            rec[a, :, 3] = n64[d]
        return rec.reshape(sigma * r, 4).astype(np.int32)

    parts = [records(nds), records(nus)]
    if ftab_k > 1:
        from .fused_mem2 import build_ftab_rows

        fr = build_ftab_rows(ix, ftab_k, rc_merge=False)
        parts.append(np.where((fr[:, 7] == 1)[:, None], fr[:, 0:4],
                              np.array([[1, 0, 0, 0]], np.int32))
                     .astype(np.int32))
    return FusedSearchIndex(
        r=r, sigma=sigma,
        rec_all=torch.from_numpy(np.concatenate(parts)),
        init_rec=torch.from_numpy(init_records(ix)),
        all_p=torch.from_numpy(ix.all_p.astype(np.int32)),
        alphamap_query=search_alphamap(ix), ftab_k=ftab_k)


def _lf_from_rec(rec: torch.Tensor, offset: torch.Tensor):
    """LF + bounded ff from a search record and an in-dest offset."""
    f2 = rec[:, 2]
    off0 = (f2 >> 16) + offset
    cum1 = f2 & 0xFFFF
    ff = (off0 >= cum1).to(torch.int32)
    return rec[:, 1] + ff, off0 - ff * cum1


def fused_bs_step(rec_all: torch.Tensor, r: int, sigma: int, rs, os_, re,
                  oe, a):
    """backward_search_step: returns (rs', os', re', oe', empty).  The
    down record is read at (a, rs) and the up record at (a, re)."""
    a_s = a.clamp(min=0).to(torch.int64)
    rd = rec_all[a_s * r + rs.clamp(0, r - 1)]
    ru = rec_all[(sigma + a_s) * r + re.clamp(0, r - 1)]
    return step_decode(rd, ru, r, rs, os_, re, oe, a)


def step_decode(rd, ru, r: int, rs, os_, re, oe, a):
    """The step's result from its down row rd and up row ru [lanes, 4]:
    (rs', os', re', oe', empty)."""
    drs = rd[:, 0]
    dre = ru[:, 0]
    empty = (a < 0) | (drs >= r) | (drs > re)
    os1 = torch.where(drs != rs, 0, os_)
    oe1 = torch.where(dre != re, ru[:, 3] - 1, oe)
    nrs, nos = _lf_from_rec(rd, os1)
    nre, noe = _lf_from_rec(ru, oe1)
    return nrs, nos, nre, noe, empty


def init_interval(init_rec: torch.Tensor, a: torch.Tensor):
    """initialize_backward_search: the rows of init_rec for chars a
    (illegal chars read row 1, as the JAX engines do)."""
    rec = init_rec[a.clamp(min=0).to(torch.int64) + 1]
    return rec[:, 0], rec[:, 1], rec[:, 2], rec[:, 3]


def count_init(init_rec: torch.Tensor, a0: torch.Tensor) -> torch.Tensor:
    """Count state [6, lanes] after the first char."""
    legal = (a0 >= 0).to(torch.int32)
    return torch.stack([*init_interval(init_rec, a0), legal, 1 - legal])


def interval_count(all_p: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Occurrences of the matched suffix: the interval's size, 0 for a
    read whose first char was illegal."""
    rs, os_, re, oe, matched = (state[i] for i in range(5))
    r = all_p.shape[0] - 1
    abs_s = all_p[rs.clamp(0, r).to(torch.int64)] + os_
    abs_e = all_p[re.clamp(0, r).to(torch.int64)] + oe
    return torch.where(matched > 0, abs_e - abs_s + 1, 0).to(torch.int32)


def _require_first_char(chars: torch.Tensor):
    if chars.shape[0] == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")


def fused_count_scan_plain(rec_all, init_rec, all_p, r: int, sigma: int,
                           alphas_t: torch.Tensor,
                           state: Optional[torch.Tensor] = None):
    """Plain PyTorch count scan over alphas_t [W, lanes] (int8 chars,
    -1 illegal, -2 past the read).  state None starts from row 0's char;
    otherwise the scan continues from state.  Returns (state, count)."""
    a = alphas_t.to(torch.int32)
    t0 = 0
    if state is None:
        _require_first_char(a)
        state, t0 = count_init(init_rec, a[0]), 1
    rs, os_, re, oe, matched, done = state.unbind(0)
    done = done == 1
    for t in range(t0, a.shape[0]):
        nrs, nos, nre, noe, empty = fused_bs_step(rec_all, r, sigma, rs,
                                                  os_, re, oe, a[t])
        alive = ~done
        ok = alive & ~empty
        rs = torch.where(ok, nrs, rs)
        os_ = torch.where(ok, nos, os_)
        re = torch.where(ok, nre, re)
        oe = torch.where(ok, noe, oe)
        matched = matched + ok.to(torch.int32)
        done = done | (alive & empty)
    state = torch.stack([rs, os_, re, oe, matched, done.to(torch.int32)])
    return state, interval_count(all_p, state)


def fused_zml_scan_plain(rec_all, init_rec, r: int, sigma: int,
                         alphas_t: torch.Tensor,
                         state: Optional[torch.Tensor] = None):
    """Plain PyTorch ZML scan over alphas_t [W, lanes] (int8 chars).
    Row t of ml is the match length after char t.  state None starts
    from row 0's char.  Returns (state, ml [W, lanes])."""
    a = alphas_t.to(torch.int32)
    W, lanes = a.shape
    ml_out = torch.empty((W, lanes), dtype=torch.int32, device=a.device)
    t0 = 0
    if state is None:
        _require_first_char(a)
        legal = (a[0] >= 0).to(torch.int32)
        state = torch.stack([*init_interval(init_rec, a[0]), legal,
                             torch.zeros_like(legal)])
        ml_out[0] = 0
        t0 = 1
    rs, os_, re, oe, have, ml = state.unbind(0)
    have = have == 1
    for t in range(t0, W):
        nrs, nos, nre, noe, empty = fused_bs_step(rec_all, r, sigma, rs,
                                                  os_, re, oe, a[t])
        ext_ok = have & ~empty
        irs, ios, ire, ioe = init_interval(init_rec, a[t])
        rs = torch.where(ext_ok, nrs, irs)
        os_ = torch.where(ext_ok, nos, ios)
        re = torch.where(ext_ok, nre, ire)
        oe = torch.where(ext_ok, noe, ioe)
        have = ext_ok | (a[t] >= 0)
        ml = torch.where(ext_ok, ml + 1, 0)
        ml_out[t] = torch.where(have, ml, 0)
    state = torch.stack([rs, os_, re, oe, have.to(torch.int32), ml])
    return state, ml_out


def fused_count_scan(rec_all, init_rec, all_p, r: int, sigma: int,
                     alphas_t: torch.Tensor,
                     state: Optional[torch.Tensor] = None):
    """The one-step count scan: the CUDA kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if rec_all.device.type == "cuda":
        return kernels.fused_count_scan(rec_all, init_rec, all_p, r, sigma,
                                        alphas_t, state)
    if rec_all.device.type != "cpu":
        raise ValueError(f"no scan for device {rec_all.device}")
    return fused_count_scan_plain(rec_all, init_rec, all_p, r, sigma,
                                  alphas_t, state)


def fused_zml_scan(rec_all, init_rec, r: int, sigma: int,
                   alphas_t: torch.Tensor,
                   state: Optional[torch.Tensor] = None):
    """The one-step ZML scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if rec_all.device.type == "cuda":
        return kernels.fused_zml_scan(rec_all, init_rec, r, sigma, alphas_t,
                                      state)
    if rec_all.device.type != "cpu":
        raise ValueError(f"no scan for device {rec_all.device}")
    return fused_zml_scan_plain(rec_all, init_rec, r, sigma, alphas_t,
                                state)


def search_chars(alphamap_query: np.ndarray, batch: ReadBatch,
                 mark_beyond: bool) -> np.ndarray:
    """Chars in scan order (right to left) as int32 [lanes, W]; with
    mark_beyond, columns past a read's end hold -2."""
    alphas = alphamap_query[batch.seqs[:, ::-1]]
    if mark_beyond:
        t_idx = np.arange(batch.width)[None, :]
        alphas = np.where(t_idx >= batch.lengths[:, None], BEYOND, alphas)
    return alphas


def count_results(batch: ReadBatch, matched: torch.Tensor,
                  count: torch.Tensor) -> List[Tuple[int, int]]:
    """(pos_on_r, match_count) per read, as query_backward_search."""
    pos = batch.lengths.astype(np.int64) - matched.cpu().numpy()
    return list(zip(pos.tolist(), count.cpu().numpy().tolist()))


class _SearchEngine:
    def __init__(self, si: FusedSearchIndex, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.si = si.to(self.device)

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Chars in scan order as int8 [W, lanes] on the device."""
        alphas = search_chars(self.si.alphamap_query, batch,
                              mark_beyond=self.mark_beyond)
        return torch.from_numpy(
            np.ascontiguousarray(alphas.T).astype(np.int8)).to(self.device)


class FusedCountEngine(_SearchEngine):
    """Count queries (query_backward_search) at two record loads per
    base; a batch of any width is one scan."""

    mark_beyond = True

    def query_batch_device(self, batch: ReadBatch):
        """(matched, count) int32 [lanes] on the device."""
        si = self.si
        state, count = fused_count_scan(si.rec_all, si.init_rec, si.all_p,
                                        si.r, si.sigma, self.prepare(batch))
        return state[4], count

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        return count_results(batch, *self.query_batch_device(batch))


class FusedZMLEngine(_SearchEngine):
    """ZML at two record loads per base; a batch of any width is one
    scan."""

    mark_beyond = False

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        si = self.si
        return fused_zml_scan(si.rec_all, si.init_rec, si.r, si.sigma,
                              self.prepare(batch))[1]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)
