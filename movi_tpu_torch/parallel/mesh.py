"""Data-parallel query engines over a mesh of ranks.

Port of movi_tpu/parallel/mesh.py.  The reference parallelises with
OpenMP threads over one BatchLoader (movi.cpp:274-301); the JAX package
shards the read lanes of a batch over the 'data' axis of a device mesh.
Here every rank holds the whole index on its device and runs the port's
single-device kernels on its slice of the lanes (parallel.Mesh
.lane_slice): there is no collective in the query loop.  Each engine
returns this rank's shard; `gather` (an all_gather over 'data') gives
callers the whole batch.

The PML engine classifies on the device (kernel 1 or 3, then kernel 16a,
csrc/classify.cu): the binned maxima of the processing-order matching
lengths with the last short region merged into the previous bin, and the
vote against max_value_thr (classifier.cpp:99-143).  Its ml stays int32:
the JAX engine returns it cast to uint16, which wraps a PML past 65,535
(an exact read longer than that; ROADMAP §3).  The MEM engine runs the
v1 machines (engine/fused_mem.py); kernel 13c builds the all-MEMs entry
state of `_sharded_all_mem_state` itself, for each lane at phase ENTRY.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..engine.fused import FusedIndex, fused_pml_scan, initial_state
from ..engine.fused2 import build_fused2_index, fused2_pml_scan, pack_pairs
from ..engine.fused_color import color_state, fused_color_scan
from ..engine.fused_kmer import kmer_count_scan
from ..engine.fused_mem import FusedAllMemEngine, FusedMemEngine
from ..engine.fused_search import (BEYOND, fused_count_scan,
                                   fused_zml_scan)
from ..engine.fused_search2 import (fused2_count_scan, fused2_zml_scan,
                                    pack_search_pairs)
from ..io.fastx import ReadBatch
from . import Mesh, make_mesh


def classify_from_ml_plain(ml: torch.Tensor, lengths: torch.Tensor,
                           bin_width: int, max_value_thr: int):
    """Binned maxima and threshold vote over ml [W, lanes], vectorised
    over the read lengths [lanes] as the JAX version is: positions past a
    read are -1, the naive bins are ceil(W / bin_width), B =
    max(L // bin_width, 1) true bins, the bins before B-1 vote one each
    and the maximum over bins B-1 to the end votes once.  Returns (found
    bool, above, below int32)."""
    W, lanes = ml.shape
    nb = -(-W // bin_width)
    t_idx = torch.arange(W, device=ml.device)[:, None]
    masked = torch.where(t_idx < lengths[None, :].to(torch.int64),
                         ml.to(torch.int32), -1)
    pad = torch.full((nb * bin_width - W, lanes), -1, dtype=torch.int32,
                     device=ml.device)
    naive = torch.cat([masked, pad]).reshape(nb, bin_width, lanes) \
        .amax(dim=1)
    B = torch.clamp(lengths.to(torch.int64) // bin_width, min=1)
    b_idx = torch.arange(nb, device=ml.device)[:, None]
    pre = (b_idx < B[None, :] - 1) & (naive >= max_value_thr)
    tail = torch.where(b_idx >= B[None, :] - 1, naive, -1).amax(dim=0)
    above = pre.sum(dim=0) + (tail >= max_value_thr).to(torch.int64)
    return (2 * above > B, above.to(torch.int32),
            (B - above).to(torch.int32))


def classify_from_ml(ml: torch.Tensor, lengths: torch.Tensor,
                     bin_width: int, max_value_thr: int):
    """The classification: kernel 16a on a CUDA tensor, the plain version
    on a CPU tensor."""
    if ml.device.type == "cuda":
        return kernels.classify_from_ml(ml, lengths, bin_width,
                                        max_value_thr)
    if ml.device.type != "cpu":
        raise ValueError(f"no classification for device {ml.device}")
    return classify_from_ml_plain(ml, lengths, bin_width, max_value_thr)


class _DataParallel:
    """An engine whose index is whole on every rank of `mesh` (default:
    every rank of the process group) and whose lanes split over 'data'."""

    def __init__(self, mesh: Optional[Mesh]):
        self.mesh = mesh or make_mesh()
        self.device = self.mesh.device

    def _up(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a).astype(dtype)) \
            .to(self.device)

    def gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole batch of a lane-sharded result (lanes on `dim`)."""
        return self.mesh.gather(t, dim)


class ShardedPMLEngine(_DataParallel):
    """Data-parallel PML with on-device classification, on the one-step or
    (paired=True) the paired records."""

    def __init__(self, fi: FusedIndex, mesh: Optional[Mesh] = None,
                 bin_width: int = 150, max_value_thr: int = 4,
                 paired: bool = False):
        super().__init__(mesh)
        self.bin_width = bin_width
        self.max_value_thr = max_value_thr
        self.paired = paired
        fi = fi.to(self.device)
        # the paired records are composed on this rank's device
        self.fi = build_fused2_index(fi) if paired else fi
        self.alphamap_query = self.fi.alphamap_query

    def query_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """seqs: uint8 [lanes, W] right-aligned; lanes must divide by the
        'data' axis.  Returns this rank's (ml int32 [W, lanes/data],
        found bool, above, below int32 [lanes/data])."""
        sl = self.mesh.lane_slice(seqs.shape[0])
        fi = self.fi
        slots = fi.sigma + 1
        alphas = self.alphamap_query[seqs[sl, ::-1]]
        lens = self._up(lengths[sl], np.int32)
        state = initial_state(fi, alphas.shape[0], self.device)
        if self.paired:
            a12, W = pack_pairs(alphas, fi.sigma)
            ml = fused2_pml_scan(fi.records, slots, fi.p_dollar,
                                 self._up(a12, a12.dtype), state)[1][:W]
        else:
            ml = fused_pml_scan(fi.records, slots, fi.p_dollar,
                                self._up(alphas.T, np.uint8), state)[1]
        return (ml, *classify_from_ml(ml, lens, self.bin_width,
                                      self.max_value_thr))


class ShardedSearchEngine(_DataParallel):
    """Data-parallel count / ZML on the one-step or (paired=True) the
    paired search records."""

    def __init__(self, si, mesh: Optional[Mesh] = None,
                 paired: bool = False):
        super().__init__(mesh)
        self.paired = paired
        self.si = si.to(self.device)

    def _alphas(self, seqs: np.ndarray, lengths: np.ndarray):
        """This rank's chars in scan order [lanes, W], -2 past a read."""
        sl = self.mesh.lane_slice(seqs.shape[0])
        alphas = self.si.alphamap_query[seqs[sl, ::-1]].astype(np.int32)
        t_idx = np.arange(seqs.shape[1])[None, :]
        return np.where(t_idx >= lengths[sl, None], BEYOND, alphas)

    def count_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """This rank's (matched, count) int32 [lanes/data]."""
        si = self.si
        alphas = self._alphas(seqs, lengths)
        if self.paired:
            pairs, _ = pack_search_pairs(alphas[:, 1:], si.sigma)
            state, count = fused2_count_scan(
                si.rec_all, si.init_rec, si.all_p, si.r, si.sigma,
                self._up(pairs, np.uint8),
                a0=self._up(alphas[:, 0], np.int8))
        else:
            state, count = fused_count_scan(
                si.rec_all, si.init_rec, si.all_p, si.r, si.sigma,
                self._up(alphas.T, np.int8))
        return state[4], count

    def zml_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """This rank's ml int32 [W, lanes/data]."""
        si = self.si
        alphas = self._alphas(seqs, lengths)
        if self.paired:
            pairs, W = pack_search_pairs(alphas, si.sigma)
            return fused2_zml_scan(si.rec_all, si.init_rec, si.restart_rec,
                                   si.r, si.sigma,
                                   self._up(pairs, np.uint8))[1][:W]
        return fused_zml_scan(si.rec_all, si.init_rec, si.r, si.sigma,
                              self._up(alphas.T, np.int8))[1]


class ShardedColorEngine(_DataParallel):
    """Data-parallel Movi Color scan: index and color ids on every rank,
    lanes sharded; the vote tally runs on the host after gathering
    (engine/fused_color.py)."""

    def __init__(self, ci, mesh: Optional[Mesh] = None):
        super().__init__(mesh)
        self.ci = ci.to(self.device)

    def query_batch_device(self, seqs: np.ndarray):
        """This rank's (ml, color id) int32 [W, lanes/data]."""
        ci = self.ci
        sl = self.mesh.lane_slice(seqs.shape[0])
        alphas_t = self._up(ci.fi.alphamap_query[seqs[sl, ::-1]].T,
                            np.uint8)
        state = color_state(ci.fi, alphas_t.shape[1], self.device, False)
        if ci.records3 is not None:
            records, cids = ci.records3, None
        else:
            records, cids = ci.fi.records, ci.doc_set_inds
        _, ml, cid = fused_color_scan(records, ci.fi.sigma + 1,
                                      ci.fi.p_dollar, alphas_t, state, cids)
        return ml, cid


class ShardedKmerEngine(_DataParallel):
    """Data-parallel exact k-mer counts: search records on every rank,
    one lane per k-mer window, windows sharded over 'data'."""

    def __init__(self, si, k: int, mesh: Optional[Mesh] = None):
        super().__init__(mesh)
        self.si = si.to(self.device)
        self.k = k

    def count_windows_device(self, windows: np.ndarray):
        """windows: int32 [k, nk] slots in k-mer order; nk must divide by
        the 'data' axis (pad with illegal -1 columns).  Returns this
        rank's (found bool, count int32) [nk/data]."""
        sl = self.mesh.lane_slice(windows.shape[1])
        slots = self._up(windows[:, sl].T, np.int8)   # [nk/data, k]
        nk = slots.shape[0]
        lane = torch.arange(nk, dtype=torch.int32, device=self.device)
        start = torch.zeros(nk, dtype=torch.int32, device=self.device)
        return kmer_count_scan(self.si, slots, lane, start, self.k)


class ShardedMemEngine(_DataParallel):
    """Data-parallel MEM finding on the v1 table (engine/fused_mem.py):
    the BML machine for min_mem_length >= 2, else all-MEMs, on this
    rank's lanes."""

    def __init__(self, mi, min_mem_length: int = 0,
                 mesh: Optional[Mesh] = None):
        super().__init__(mesh)
        self.L = min_mem_length
        self.engine = (FusedMemEngine(mi, min_mem_length, self.device)
                       if min_mem_length >= 2
                       else FusedAllMemEngine(mi, self.device))

    def query_batch_device(self, seqs: np.ndarray, lengths: np.ndarray):
        """seqs: uint8 [lanes, W] right-aligned.  Returns this rank's
        machine state with ends and counts int32 [lanes/data, W]."""
        sl = self.mesh.lane_slice(seqs.shape[0])
        part = seqs[sl]
        batch = ReadBatch([""] * part.shape[0], part,
                          lengths[sl].astype(np.int32))
        return self.engine.scan(*self.engine.prepare(batch))[0]
