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
  run_dir[k]  the row -> run directory: the run holding row k << dir_shift
              for k < K = ((n-1) >> dir_shift) + 1, run_dir[K] = r
                                                           int32 [K+1]

The directory is the port's own (the JAX package searches all of all_p).
Every LF maps lf_abs[idx] + off back to (run, offset) through it: the run
holding row x lies in [run_dir[k], run_dir[k+1]] for k = x >> dir_shift,
and a binary search of that span (at most dir_shift + 1 halvings, one or
two on most buckets) replaces the search of all of all_p.  dir_shift is
the smallest shift that keeps the directory no larger than all_p
(run_dir_shift).  The directory always lives on all_p's device and is
built there from all_p: by kernel 13d (csrc/fused_mem.cu) on the card,
by run_dir_plain on the CPU; it is never copied from the host.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Optional, Sequence

import numpy as np
import torch

from .. import kernels
from ..constants import SEPARATOR
from ..index.structure import MoveIndex
from .fused import build_thr_full

PML_TABLES = ("n", "lf_abs", "all_p", "c", "thr_full", "rep_up", "rep_down",
              "run_dir")
SEARCH_TABLES = ("n", "lf_abs", "all_p", "c_search", "ch_up_s", "ch_down_s",
                 "first_runs", "first_offsets", "last_runs", "last_offsets",
                 "run_dir")


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
    run_dir: Optional[torch.Tensor] = None  # int32 [K+1], on all_p's device
    dir_shift: int = 0

    def tables(self) -> Sequence[str]:
        return [f.name for f in fields(self)
                if isinstance(getattr(self, f.name), torch.Tensor)]

    def to(self, device, tables: Sequence[str] = None) -> "DeviceIndex":
        """The index with `tables` (default: all) on device; the others
        stay where they are.  The directory is not copied: where all_p
        lands on another device than the directory's, it is built there
        from all_p."""
        names = self.tables() if tables is None else tables
        out = replace(self, **{k: getattr(self, k).to(device) for k in names
                               if k != "run_dir"
                               and getattr(self, k) is not None})
        if out.run_dir is None or out.run_dir.device != out.all_p.device:
            out = out.with_run_dir(None if out.run_dir is None
                                   else out.dir_shift)
        return out

    def with_run_dir(self, b: Optional[int] = None) -> "DeviceIndex":
        """The index with its row -> run directory at shift b (by default
        run_dir_shift's), built from all_p on all_p's device."""
        if b is None:
            b = run_dir_shift(self.length, self.r)
        return replace(self, dir_shift=b,
                       run_dir=build_run_dir(self.all_p, self.length, b))

    def hbm_bytes(self, tables: Sequence[str] = None) -> int:
        names = self.tables() if tables is None else tables
        return sum(t.numel() * t.element_size()
                   for t in (getattr(self, k) for k in names)
                   if t is not None)


def run_dir_shift(n: int, r: int) -> int:
    """b of the row -> run directory: the smallest b >= 0 with ((n-1) >>
    b) + 2 <= r + 1, so that its K+1 entries (K = ((n-1) >> b) + 1) take
    no more than all_p's r+1."""
    b = 0
    while ((n - 1) >> b) + 2 > r + 1:
        b += 1
    return b


def run_dir_plain(all_p: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """Plain PyTorch directory: searchsorted(all_p, arange(K) << b,
    right) - 1 with r appended, int32 [K+1]."""
    r = all_p.shape[0] - 1
    rows = torch.arange(kernels.run_dir_size(n, b) - 1, dtype=torch.int32,
                        device=all_p.device) << b
    runs = torch.searchsorted(all_p, rows, right=True, out_int32=True) - 1
    return torch.cat([runs, runs.new_tensor([r])])


def build_run_dir(all_p: torch.Tensor, n: int, b: int) -> torch.Tensor:
    """The directory on all_p's device: kernel 13d on CUDA, the plain
    version on the CPU."""
    if all_p.device.type == "cuda":
        return kernels.run_dir_build(all_p, n, b)
    if all_p.device.type != "cpu":
        raise ValueError(f"no directory build for device {all_p.device}")
    return run_dir_plain(all_p, n, b)


def resolve_dir(all_p: torch.Tensor, run_dir: torch.Tensor, b: int,
                x: torch.Tensor):
    """The directory search of csrc/compact.cuh find_run_dir, lane by
    lane: the run holding each row of x (int32; find_run's answer, so 0
    for x < 0 and r for x >= n), all_p[run], and the halvings each lane
    took (ceil(log2(dir[k+1] - dir[k] + 1)) for its bucket k).  A bucket
    of 2^b rows spans at most 2^b + 1 runs, so b + 1 rounds end every
    search."""
    k = (x >> b).clamp(0, run_dir.shape[0] - 2).to(torch.int64)
    base = run_dir[k]
    length = run_dir[k + 1] - base + 1
    halvings = torch.zeros_like(x)
    for _ in range(b + 1):
        live = length > 1
        half = length >> 1
        v = all_p[(base + half).to(torch.int64)]
        base = torch.where(live & (v <= x), base + half, base)
        length = length - half
        halvings += live.to(halvings.dtype)
    return base, all_p[base.to(torch.int64)], halvings


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def build_device_index(ix: MoveIndex) -> DeviceIndex:
    """The compact tables on the host (CPU tensors), the directory at
    run_dir_shift's shift."""
    r, sigma = ix.r, ix.sigma
    assert ix.length < 2**31, "single-shard index limited to 2^31 bases"
    assert int(ix.all_p[r]) == ix.length, "all_p[r] is the text length"

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
        ch_up_s=i32(nus), ch_down_s=i32(nds)).with_run_dir()
