"""Compact PML: PMLs on the run tables of engine/device_index.py.

Port of movi_tpu/engine/pml.py.  Each base loads the row's char; on a
mismatch it repositions by threshold (or, with random_repositioning, by
the reference's offset rule, query --rpml) through rep_up/rep_down; then
LF with an unbounded fast-forward: the absolute destination lf_abs[idx] +
off mapped back to (run, offset) by a binary search over all_p.  The scan
runs the hand-written CUDA kernel (csrc/compact_pml.cu) on a CUDA tensor
and the plain PyTorch version below on a CPU tensor.

Scan state (idx, off, ml) int32 [lanes] comes in and goes out, so a scan
split into pieces equals one pass.  Chars are int8 [W, lanes] in scan
order: 0..sigma-1, -1 illegal.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .device_index import PML_TABLES, DeviceIndex
from .fused import trim

NOT_FOUND = kernels.NOT_FOUND  # ScalarEngine's message, both directions r


def lf_step(di: DeviceIndex, idx: torch.Tensor, off: torch.Tensor):
    """LF_move with the unbounded fast-forward: (run, offset) of
    lf_abs[idx] + off, found in all_p."""
    abs_dest = di.lf_abs[idx.to(torch.int64)] + off
    new_idx = torch.searchsorted(di.all_p, abs_dest, right=True) - 1
    return new_idx.to(torch.int32), abs_dest - di.all_p[new_idx]


def pml_step(di: DeviceIndex, state, a: torch.Tensor,
             random_repositioning: bool, tally=None):
    """One base for every lane (make_pml_step's body): returns (state,
    ml, lanes whose reposition found no run).  tally: see
    compact_pml_scan_plain."""
    idx, off, ml = state
    r, sigma = di.r, di.sigma
    i64 = idx.to(torch.int64)
    legal = a >= 0
    a_s = a.clamp(min=0).to(torch.int64)
    case1 = legal & (di.c[i64].to(torch.int32) == a_s)
    case2 = legal & ~case1

    up = di.rep_up.reshape(-1)[a_s * r + i64]
    down = di.rep_down.reshape(-1)[a_s * r + i64]
    if random_repositioning:
        first_up = 2 * off < di.n[i64]
        first_up = torch.where(idx == r - 1, True, first_up)
        first_up = torch.where(idx == 0, False, first_up)
        # the other direction when the first finds no run
        go_up = torch.where(first_up & (up >= r), False, first_up)
        go_up = torch.where(~go_up & (down >= r), True, go_up)
    else:
        go_up = off < di.thr_full.reshape(-1)[i64 * sigma + a_s]
    if tally is not None:
        tally[0] += (case2 & go_up).sum()
        if random_repositioning:
            tally[1] += (case2 & (torch.where(first_up, up, down) >= r)).sum()
    dest = torch.where(go_up, up, down)
    missing = case2 & (dest >= r)
    dest = dest.clamp(max=r - 1)  # a missing lane raises after the scan
    rep_off = torch.where(go_up, di.n[dest.to(torch.int64)] - 1, 0)

    new_idx = torch.where(case2, dest, idx)
    new_off = torch.where(case2, rep_off, off)
    # a mismatch or an illegal char zeroes ml; an illegal one keeps the
    # position, and LF runs either way
    new_ml = torch.where(case1, ml + 1, 0)
    lf_idx, lf_off = lf_step(di, new_idx, new_off)
    return (lf_idx, lf_off, new_ml), new_ml, missing


def compact_pml_scan_plain(di: DeviceIndex, codes: torch.Tensor, state,
                           random_repositioning: bool = False, tally=None):
    """Plain PyTorch scan over codes [W, lanes].  Returns (state, ml [W,
    lanes]); raises where a reposition finds no run.  tally, where given
    (int64 [2]), gains the mismatches that repositioned upward and those
    that tried the other direction: the kernel's loads that depend on the
    data besides a mismatch's own two."""
    if not random_repositioning and di.thr_full is None:
        raise ValueError("threshold repositioning needs an index with "
                         "thresholds")
    a = codes.to(torch.int32)
    ml = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    missing = torch.zeros(a.shape[1], dtype=torch.bool, device=a.device)
    for t in range(a.shape[0]):
        state, ml[t], miss = pml_step(di, state, a[t], random_repositioning,
                                      tally)
        missing |= miss
    if bool(missing.any()):
        raise AssertionError(NOT_FOUND)
    return state, ml


def compact_pml_scan(di: DeviceIndex, codes: torch.Tensor, state,
                     random_repositioning: bool = False):
    """The compact PML scan: the CUDA kernel on CUDA tables, the plain
    version on CPU tables."""
    if di.lf_abs.device.type == "cuda":
        return kernels.compact_pml_scan(
            di.n, di.lf_abs, di.all_p, di.c, di.thr_full, di.rep_up,
            di.rep_down, di.r, di.sigma, codes, state, random_repositioning)
    if di.lf_abs.device.type != "cpu":
        raise ValueError(f"no scan for device {di.lf_abs.device}")
    return compact_pml_scan_plain(di, codes, state, random_repositioning)


def initial_state(di: DeviceIndex, lanes: int, device):
    """(idx, off, ml) at the start of every read: the last run's last
    row."""
    last = int(di.n[di.r - 1])
    return (torch.full((lanes,), di.r - 1, dtype=torch.int32, device=device),
            torch.full((lanes,), last - 1, dtype=torch.int32, device=device),
            torch.zeros((lanes,), dtype=torch.int32, device=device))


def scan_codes(alphamap_query: np.ndarray, batch: ReadBatch,
               device) -> torch.Tensor:
    """Chars in scan order (right to left) as int8 [W, lanes] on device;
    padding before a read's start is illegal (-1)."""
    alphas = alphamap_query[batch.seqs[:, ::-1]]
    return torch.from_numpy(
        np.ascontiguousarray(alphas.T).astype(np.int8)).to(device)


class PMLEngine:
    """PML on the compact tables, repositioning by threshold or, with
    random_repositioning, by query --rpml's rule; a batch of any width is
    one scan."""

    def __init__(self, di: DeviceIndex, random_repositioning: bool = False,
                 device: DeviceLike = None):
        if not random_repositioning and di.thr_full is None:
            raise ValueError("threshold repositioning needs an index with "
                             "thresholds")
        self.device = resolve_device(device)
        self.di = di.to(self.device, PML_TABLES)
        self.random_repositioning = random_repositioning

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        return scan_codes(self.di.alphamap_query, batch, self.device)

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        codes = self.prepare(batch)
        state = initial_state(self.di, codes.shape[1], self.device)
        return compact_pml_scan(self.di, codes, state,
                                self.random_repositioning)[1]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        """Per-read PMLs in processing order (right to left)."""
        return trim(self.query_batch_device(batch), batch)
