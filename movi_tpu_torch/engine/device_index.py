"""The compact index: the move structure's run tables, one row per run.

Port of movi_tpu/engine/device_index.py.  The builder is numpy and gives
the same arrays as the JAX package's.  The compact engines (engine/pml.py,
engine/search.py) run on it where the record layouts cannot: an index not
built with bound_ff=1, an index without thresholds, and an index whose
record tables do not fit the device (the "compact" rung of
engine/select.py).  An engine moves to its device only the tables its scan
reads (PML_TABLES or SEARCH_TABLES).

Tables (run ids i < r; absolute BWT positions as int32, so the text must
stay under 2^31 bases):
  n[i]        run length                                   int32 [r]
  lf_abs[i]   absolute position of the LF image of the run head
              (all_p[id[i]] + offset[i])                   int32 [r]
  all_p[i]    run head positions, all_p[r] = n             int32 [r+1]
  c[i]        stored run char (the '$' row holds 0)        uint8 [r]
  thr_full[i, a]   the threshold for read char a, '$' and separator rows
              baked in (None without thresholds)           int32 [r, sigma]
  rep_up[a, i] / rep_down[a, i]   the run a mismatch on char a
              repositions to, up or down (r: none)         int32 [sigma, r]
  c_search[i] the search char (-1 for the '$' row)         int32 [r]
  ch_up_s[a, i] / ch_down_s[a, i]   last run <= i / first run >= i whose
              search char is a (r: none)                   int32 [sigma, r]
  first_runs/first_offsets/last_runs/last_offsets   the interval of each
              char (initialize_backward_search)            int32 [sigma+1]
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence

import numpy as np
import torch

from ..constants import SEPARATOR
from ..index.structure import MoveIndex
from .fused import build_thr_full

PML_TABLES = ("n", "lf_abs", "all_p", "c", "thr_full", "rep_up", "rep_down")
SEARCH_TABLES = ("n", "lf_abs", "all_p", "c_search", "ch_up_s", "ch_down_s",
                 "first_runs", "first_offsets", "last_runs", "last_offsets")


@dataclass
class DeviceIndex:
    mode: str
    r: int
    length: int
    end_bwt_idx: int
    sigma: int
    n: torch.Tensor
    lf_abs: torch.Tensor
    all_p: torch.Tensor
    c: torch.Tensor
    thr_full: Optional[torch.Tensor]
    rep_up: torch.Tensor
    rep_down: torch.Tensor
    first_runs: torch.Tensor
    first_offsets: torch.Tensor
    last_runs: torch.Tensor
    last_offsets: torch.Tensor
    alphamap_query: np.ndarray  # host-side: byte -> char (-1 illegal)
    c_search: torch.Tensor
    ch_up_s: torch.Tensor
    ch_down_s: torch.Tensor

    def tables(self) -> Sequence[str]:
        return [f.name for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device, tables: Sequence[str] = None) -> "DeviceIndex":
        """The index with `tables` (default: all) on device; the others
        stay where they are."""
        names = self.tables() if tables is None else tables
        return replace(self, **{k: getattr(self, k).to(device) for k in names
                                if getattr(self, k) is not None})

    def hbm_bytes(self, tables: Sequence[str] = None) -> int:
        names = self.tables() if tables is None else tables
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, k) for k in names)
                   if t is not None)


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def build_device_index(ix: MoveIndex) -> DeviceIndex:
    """The compact tables on the host (CPU tensors)."""
    r, sigma = ix.r, ix.sigma
    assert ix.length < 2**31, "single-shard index limited to 2^31 bases"

    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    thr_full = build_thr_full(ix) if ix.thr is not None else None

    # reposition tables by the current run, with the reference's edges
    # (reposition_up/down start at idx -/+ 1; idx 0 / r-1 give none)
    nu, nd = ix.next_tables()           # the '$' row matches alphabet[0]
    nus, nds = ix.next_tables_search()  # the '$' row matches nothing
    rep_up = np.full((sigma, r), r, dtype=np.int64)
    rep_down = np.full((sigma, r), r, dtype=np.int64)
    rep_up[:, 1:] = nu[:, :-1]
    rep_down[:, :-1] = nd[:, 1:]

    c_search = ix.c_arr.astype(np.int32)
    c_search[ix.end_bwt_idx] = -1

    alphamap_query = np.full(256, -1, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = -1  # check_alphabet rejects separators

    i32 = lambda a: _t(np.asarray(a).astype(np.int32))  # noqa: E731
    return DeviceIndex(
        mode=ix.mode, r=r, length=ix.length, end_bwt_idx=ix.end_bwt_idx,
        sigma=sigma, n=i32(ix.n_arr), lf_abs=i32(lf_abs),
        all_p=i32(ix.all_p), c=_t(ix.c_arr),
        thr_full=None if thr_full is None else _t(thr_full),
        rep_up=i32(rep_up), rep_down=i32(rep_down),
        first_runs=i32(ix.first_runs), first_offsets=i32(ix.first_offsets),
        last_runs=i32(ix.last_runs), last_offsets=i32(ix.last_offsets),
        alphamap_query=alphamap_query, c_search=_t(c_search),
        ch_up_s=i32(nus), ch_down_s=i32(nds))
