"""Dense-automaton PML: one 4 B table load per base.

Port of movi_tpu/engine/dense.py.  The PML step (move_structure_query.cpp
:234-361) is a deterministic function of (BWT position p, read slot a),
stored as a transition table

    dense[p * (sigma+1) + a] = next_p | (is_match << 31)

so a step is one load and two integer operations.  Slot sigma (illegal
characters) is plain LF with no match.  The table costs (sigma+1)*4 B per
BWT row (20 B a base for DNA), against the run-record layouts' bytes per
run (engine/fused.py): it suits small indexes and serves as a check on
the record engines.  build_dense_index is numpy and writes the JAX package's
bytes.  The scan runs the hand-written CUDA kernel (csrc/dense_pml.cu) on
a CUDA tensor and the plain PyTorch version below on a CPU tensor; both
index the table in 64 bits (the JAX package's int32 index wraps at
n*(sigma+1) >= 2^31, ROADMAP §3).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List

import numpy as np
import torch

from .. import kernels
from ..constants import SEPARATOR
from ..device import DeviceLike, resolve_device
from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch
from .fused import build_thr_full, trim

_MATCH_BIT = np.int64(1) << 31
POS_MASK = (1 << 31) - 1


@dataclass
class DenseIndex:
    n: int
    sigma: int
    table: torch.Tensor         # int32 [n * (sigma+1)]
    start_pos: int              # n - 1
    alphamap_query: np.ndarray  # host-side: byte -> slot (sigma = illegal)

    def to(self, device) -> "DenseIndex":
        return replace(self, table=self.table.to(device))


def build_dense_index(ix: MoveIndex) -> DenseIndex:
    """Evaluate the PML step at every (position, slot): the transition
    table (a CPU tensor)."""
    assert ix.thr is not None, "dense engine requires a thresholds mode"
    assert ix.length < 2**31
    r, sigma, n = ix.r, ix.sigma, ix.length
    n64 = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    lf_abs = all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)

    thr_full = build_thr_full(ix)  # [r, sigma]
    nu, nd = ix.next_tables()      # '$' row matches alphabet[0] (reference)

    row_of_p = np.repeat(np.arange(r, dtype=np.int64), n64)
    off_of_p = np.arange(n, dtype=np.int64) - all_p[row_of_p]
    lf_of_p = lf_abs[row_of_p] + off_of_p  # LF in absolute position space

    slots = sigma + 1
    table = np.empty((n, slots), dtype=np.int32)
    table[:, sigma] = lf_of_p  # illegal char: plain LF, no match bit

    c_row = ix.c_arr.astype(np.int64)
    for a in range(sigma):
        # reposition targets per run (scan starts one row up/down)
        up = np.full(r, r, dtype=np.int64)
        dn = np.full(r, r, dtype=np.int64)
        up[1:] = nu[a, :-1]
        dn[:-1] = nd[a, 1:]
        up_c = np.minimum(up, r - 1)
        dn_c = np.minimum(dn, r - 1)
        up_dest = lf_abs[up_c] + n64[up_c] - 1  # (up_run, n-1) then LF
        dn_dest = lf_abs[dn_c]                  # (dn_run, 0) then LF

        is_match_row = c_row == a
        go_down = off_of_p >= thr_full[row_of_p, a]
        case2 = np.where(go_down, dn_dest[row_of_p], up_dest[row_of_p])
        nxt = np.where(is_match_row[row_of_p], lf_of_p | _MATCH_BIT, case2)
        table[:, a] = nxt.astype(np.int64).astype(np.int32)

    alphamap_query = np.full(256, sigma, dtype=np.int32)
    for a, ch in enumerate(ix.alphabet):
        alphamap_query[ch] = a
    if ix.separators:
        alphamap_query[SEPARATOR] = sigma

    return DenseIndex(n=n, sigma=sigma,
                      table=torch.from_numpy(table.reshape(-1)),
                      start_pos=n - 1, alphamap_query=alphamap_query)


def dense_pml_scan_plain(table, slots: int, codes: torch.Tensor, state):
    """Plain PyTorch scan: one table load per base per lane, the index in
    int64.  codes [W, lanes] slots; state (p, ml) int32 [lanes].  Returns
    (state, ml [W, lanes])."""
    p, m = state
    ml = torch.empty(codes.shape, dtype=torch.int32, device=codes.device)
    a = codes.to(torch.int64)
    for t in range(codes.shape[0]):
        w = table[p.to(torch.int64) * slots + a[t]]
        m = torch.where(w < 0, m + 1, 0).to(torch.int32)
        p = (w & POS_MASK).to(torch.int32)
        ml[t] = m
    return (p, m), ml


def dense_pml_scan(table: torch.Tensor, slots: int, codes: torch.Tensor,
                   state):
    """The dense scan: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if table.device.type == "cuda":
        return kernels.dense_pml_scan(table, slots, codes, state)
    if table.device.type != "cpu":
        raise ValueError(f"no scan for device {table.device}")
    return dense_pml_scan_plain(table, slots, codes, state)


def initial_state(di: DenseIndex, lanes: int, device):
    """(p, ml) at the start of every read."""
    return (torch.full((lanes,), di.start_pos, dtype=torch.int32,
                       device=device),
            torch.zeros((lanes,), dtype=torch.int32, device=device))


class DensePMLEngine:
    """Batched PML at one table load per base; a batch of any width is
    one scan."""

    def __init__(self, di: DenseIndex, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.di = di.to(self.device)

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Read slots in scan order (right to left) as uint8 [W, lanes] on
        the device."""
        alphas = self.di.alphamap_query[batch.seqs[:, ::-1]]
        return torch.from_numpy(
            np.ascontiguousarray(alphas.T).astype(np.uint8)).to(self.device)

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        di = self.di
        codes = self.prepare(batch)
        state = initial_state(di, codes.shape[1], self.device)
        return dense_pml_scan(di.table, di.sigma + 1, codes, state)[1]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)
