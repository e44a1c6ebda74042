"""Compact backward search: count queries and ZML on the run tables of
engine/device_index.py.

Port of movi_tpu/engine/search.py.  Each lane carries an interval (rs:os,
re:oe); a step moves its ends to the nearest runs with the char through
ch_down_s/ch_up_s (update_interval), then takes LF on both ends with the
unbounded fast-forward of engine/pml.py, through the row -> run
directory.  The scans run the hand-written CUDA kernel
(csrc/compact_search.cu) on CUDA tensors and the plain PyTorch versions
below on CPU tensors.

Chars are int8 [W, lanes] in scan order: 0..sigma-1, -1 illegal, -2 past a
read's start (count).  Scan state, int32 [6, lanes]: rows (rs, os, re, oe)
are the interval, rows 4-5 (matched, done) for count and (have, ml) for
ZML.  A state of None starts from the first row of chars.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .device_index import SEARCH_TABLES, DeviceIndex
from .fused import trim
from .fused_search import count_results, search_chars
from .pml import lf_step


def _interval_update(di: DeviceIndex, rs, os_, re, oe, a):
    """update_interval through the nearest-run tables, clamped where the
    JAX engine clamps.  a must be legal (>= 0).  Returns (rs', os', re',
    oe', empty, the lanes whose start and whose end moved to a nearest run
    [2, lanes])."""
    r, sigma = di.r, di.sigma
    a_flat = a.to(torch.int64) * r
    move_s = di.c_search[rs.to(torch.int64)] != a
    rs1 = torch.where(move_s, di.ch_down_s.reshape(-1)[
        (a_flat + rs).clamp(max=sigma * r - 1)], rs)
    os1 = torch.where(move_s, 0, os_)
    empty = (rs1 >= r) | (rs1 > re)

    re_safe = re.clamp(max=r - 1)
    move_e = di.c_search[re_safe.to(torch.int64)] != a
    re1 = torch.where(move_e, di.ch_up_s.reshape(-1)[
        (a_flat + re_safe).clamp(max=sigma * r - 1)], re_safe)
    re1 = re1.clamp(max=r - 1)  # a safe load where the interval is empty
    oe1 = torch.where(move_e, di.n[re1.to(torch.int64)] - 1, oe)
    return rs1, os1, re1, oe1, empty, torch.stack([move_s, move_e])


def _bs_step(di: DeviceIndex, rs, os_, re, oe, a):
    """backward_search_step: the interval update and LF on both ends.
    Lanes with an illegal char or an empty result report empty; their
    interval is then unspecified.  Also returns the work of a kernel's
    step, int64 [pml.TALLY_ROWS, lanes]: whether the start and whether the
    end moved to a nearest run (_interval_update), the halvings of the two
    LF searches, and the dependent loads the step adds to its lane's chain
    past its first load and its directory pairs: the two searches run
    interleaved (max(1, the longer's halvings)), and an end that moves
    loads its nearest-run row, then its new run's rows (2 more)."""
    rs1, os1, re1, oe1, empty, moves = _interval_update(
        di, rs, os_, re, oe, a.clamp(min=0))
    rs2, os2, hs = lf_step(di, rs1.clamp(max=di.r - 1), os1)
    re2, oe2, he = lf_step(di, re1, oe1)
    chain = torch.maximum(hs, he).clamp(min=1) + 2 * (moves[0] | moves[1])
    work = torch.cat([moves, torch.stack([hs + he, chain])]).to(torch.int64)
    return rs2, os2, re2, oe2, empty | (a < 0), work


def _init_interval(di: DeviceIndex, a):
    """initialize_backward_search from the first/last run tables (an
    illegal char reads the first char's row, as the JAX engine does)."""
    a1 = a.clamp(min=0).to(torch.int64) + 1
    return (di.first_runs[a1], di.first_offsets[a1], di.last_runs[a1],
            di.last_offsets[a1])


def _first_step(codes: torch.Tensor):
    if codes.shape[0] == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")


def compact_count_scan_plain(di: DeviceIndex, codes: torch.Tensor,
                             state: Optional[torch.Tensor] = None,
                             tally: Optional[torch.Tensor] = None):
    """Plain PyTorch count scan over codes [W, lanes].  Returns (state,
    count [lanes]); matched is state[4].  tally, where given (int64
    [pml.TALLY_ROWS, lanes]), gains per lane the work of _bs_step over the
    steps its kernel takes (a lane's, until it is done, past the read
    none): the kernel's loads that depend on the data."""
    a = codes.to(torch.int32)
    t0 = 0
    if state is None:
        _first_step(a)
        legal = (a[0] >= 0).to(torch.int32)
        # a lane whose last char is illegal never starts
        state, t0 = torch.stack([*_init_interval(di, a[0]), legal,
                                 1 - legal]), 1
    rs, os_, re, oe, matched, done = state.unbind(0)
    done = done == 1
    for t in range(t0, a.shape[0]):
        alive = ~done & (a[t] != -2)
        nrs, nos, nre, noe, empty, work = _bs_step(di, rs, os_, re, oe,
                                                   a[t])
        if tally is not None:
            tally += work * alive
        ok = alive & ~empty
        rs = torch.where(ok, nrs, rs)
        os_ = torch.where(ok, nos, os_)
        re = torch.where(ok, nre, re)
        oe = torch.where(ok, noe, oe)
        matched = matched + ok.to(torch.int32)
        done = done | (alive & empty)
    state = torch.stack([rs, os_, re, oe, matched, done.to(torch.int32)])
    # the last non-empty interval's size through all_p
    abs_s = di.all_p[rs.to(torch.int64)] + os_
    abs_e = di.all_p[re.to(torch.int64)] + oe
    return state, torch.where(matched > 0, abs_e - abs_s + 1, 0)


def compact_zml_scan_plain(di: DeviceIndex, codes: torch.Tensor,
                           state: Optional[torch.Tensor] = None,
                           tally: Optional[torch.Tensor] = None):
    """Plain PyTorch ZML scan over codes [W, lanes]: row t of ml is the
    match length after char t (0 without an interval).  Returns (state,
    ml [W, lanes]).  tally: as in compact_count_scan_plain."""
    a = codes.to(torch.int32)
    W, lanes = a.shape
    ml_out = torch.empty((W, lanes), dtype=torch.int32, device=a.device)
    t0 = 0
    if state is None:
        _first_step(a)
        legal = (a[0] >= 0).to(torch.int32)
        state = torch.stack([*_init_interval(di, a[0]), legal,
                             torch.zeros_like(legal)])
        ml_out[0] = 0
        t0 = 1
    rs, os_, re, oe, have, ml = state.unbind(0)
    have = have == 1
    for t in range(t0, W):
        nrs, nos, nre, noe, empty, work = _bs_step(di, rs, os_, re, oe,
                                                   a[t])
        if tally is not None:
            tally += work
        ext_ok = have & ~empty
        irs, ios, ire, ioe = _init_interval(di, a[t])
        rs = torch.where(ext_ok, nrs, irs)
        os_ = torch.where(ext_ok, nos, ios)
        re = torch.where(ext_ok, nre, ire)
        oe = torch.where(ext_ok, noe, ioe)
        have = ext_ok | (a[t] >= 0)
        ml = torch.where(ext_ok, ml + 1, 0)
        ml_out[t] = torch.where(have, ml, 0)
    return torch.stack([rs, os_, re, oe, have.to(torch.int32), ml]), ml_out


def _dispatch(kernel, plain, di: DeviceIndex, codes, state):
    if di.lf_abs.device.type == "cuda":
        return kernel(di.n, di.lf_abs, di.all_p, di.c_search, di.ch_up_s,
                      di.ch_down_s, di.first_runs, di.first_offsets,
                      di.last_runs, di.last_offsets, di.run_dir,
                      di.dir_shift, di.length, di.r, di.sigma, codes, state)
    if di.lf_abs.device.type != "cpu":
        raise ValueError(f"no scan for device {di.lf_abs.device}")
    return plain(di, codes, state)


def compact_count_scan(di: DeviceIndex, codes: torch.Tensor,
                       state: Optional[torch.Tensor] = None):
    """The compact count scan: the CUDA kernel on CUDA tables, the plain
    version on CPU tables."""
    return _dispatch(kernels.compact_count_scan, compact_count_scan_plain,
                     di, codes, state)


def compact_zml_scan(di: DeviceIndex, codes: torch.Tensor,
                     state: Optional[torch.Tensor] = None):
    """The compact ZML scan: the CUDA kernel on CUDA tables, the plain
    version on CPU tables."""
    return _dispatch(kernels.compact_zml_scan, compact_zml_scan_plain, di,
                     codes, state)


class _CompactSearchEngine:
    def __init__(self, di: DeviceIndex, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.di = di.to(self.device, SEARCH_TABLES)

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Chars in scan order as int8 [W, lanes] on the device."""
        alphas = search_chars(self.di.alphamap_query, batch,
                              mark_beyond=self.mark_beyond)
        return torch.from_numpy(
            np.ascontiguousarray(alphas.T).astype(np.int8)).to(self.device)


class CountEngine(_CompactSearchEngine):
    """Count queries (query_backward_search) on the compact tables."""

    mark_beyond = True

    def query_batch_device(self, batch: ReadBatch):
        """(matched, count) int32 [lanes] on the device."""
        state, count = compact_count_scan(self.di, self.prepare(batch))
        return state[4], count

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        """Per read: (pos_on_r, match_count)."""
        return count_results(batch, *self.query_batch_device(batch))


class ZMLEngine(_CompactSearchEngine):
    """ZML on the compact tables."""

    mark_beyond = False

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        return compact_zml_scan(self.di, self.prepare(batch))[1]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)
