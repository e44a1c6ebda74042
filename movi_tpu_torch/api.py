"""High-level API, the PML, count, ZML and Movi Color surface of
movi_tpu/api.py.

    from movi_tpu_torch import Index

    index = Index.build("ref.fasta")                    # or Index.load(dir)
    index.save("idx_dir")
    res = index.query_pml(reads)                        # [(name, pmls)]
    res = index.query_count(reads)           # [(name, (pos_on_r, count))]
    res = index.query_zml(reads)                        # [(name, zmls)]
    res = index.multi_classify(reads, color_table)      # [(name, cell)]

Reads are (name, bytes) pairs or a fasta/fastq path.  Queries run on the
device passed in (default CUDA; without a card that raises unless the
caller names the CPU).  The other query methods of the JAX API (MEMs,
k-mers, SA entries) are not yet ported and are absent.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

from movi_tpu.build.prepare_ref import prepare_ref
from movi_tpu.build.suffix import build_bwt_runs
from movi_tpu.index.structure import MoveIndex, build_move_index
from movi_tpu.io.fastx import batches_from_file, make_batches

from .convert import load_engine_caches
from .device import DeviceLike, resolve_device
from .engine.fused import (FusedPMLEngine, build_fused_index, is_bounded,
                           save_fused_index)
from .engine.fused2 import (Fused2ColorEngine, Fused2PMLEngine,
                            build_fused2_color_index, build_fused2_index,
                            save_fused2_index)
from .engine.fused_color import FusedColorEngine, build_fused_color_index
from .engine.fused_search import (FusedCountEngine, FusedZMLEngine,
                                  build_fused_search_index)
from .engine.fused_search2 import (Fused2CountEngine, Fused2ZMLEngine,
                                   build_fused_search2_index,
                                   save_fused_search2_index)
from .engine.select import pick_backend

Reads = Union[str, Sequence[Tuple[str, bytes]]]


def _as_batches(reads: Reads, lanes: int):
    """Batches as wide as their longest read: the kernels take any width,
    so the JAX package's width buckets (which bound its jit compiles)
    would only add padded steps to every lane."""
    if isinstance(reads, (str, os.PathLike)):
        yield from batches_from_file(str(reads), lanes=lanes,
                                     bucket_widths=False)
    else:
        yield from make_batches(list(reads), lanes=lanes,
                                bucket_widths=False)


class Index:
    def __init__(self, ix: MoveIndex):
        self.ix = ix
        self._fused = None    # FusedIndex (host or device tensors)
        self._paired = None   # Fused2Index
        self._search = None   # FusedSearchIndex
        self._paired_search = None  # FusedSearch2Index
        self._color = None    # (ColorTable, FusedColorIndex)
        self._paired_color = None   # (ColorTable, Fused2ColorIndex)
        self._bounded = None

    @classmethod
    def build(cls, fasta: Union[str, Sequence[str]],
              mode: str = "regular-thresholds", rc: bool = True,
              separators: bool = False, bound_ff: Optional[int] = 1,
              ) -> "Index":
        ref = prepare_ref(fasta, rc=rc, separators=separators)
        ix = build_move_index(build_bwt_runs(ref.text), mode,
                              separators=separators, bound_ff=bound_ff)
        return cls(ix)

    def save(self, index_dir: str, engine_caches: bool = True):
        """index.npz plus the record caches, in the JAX package's formats
        (either package loads what the other saved)."""
        os.makedirs(index_dir, exist_ok=True)
        self.ix.save(os.path.join(index_dir, "index.npz"))
        if not engine_caches:
            return
        if self._fused is None and self._pml_ported():
            self._fused = build_fused_index(self.ix)
        if self._fused is not None:
            save_fused_index(self._fused,
                             os.path.join(index_dir, "fused_records.npz"))
        if self._paired is not None:
            save_fused2_index(self._paired,
                              os.path.join(index_dir, "paired_records.npz"))
        if self._paired_search is not None:
            save_fused_search2_index(
                self._paired_search,
                os.path.join(index_dir, "paired_search_records.npz"))

    @classmethod
    def load(cls, index_dir: str, ix: Optional[MoveIndex] = None
             ) -> "Index":
        """The index of `index_dir` with its record caches.  `ix` is the
        index already loaded by another loader (the CLI's, which also
        reads reference-built index.movi files); by default index.npz."""
        if ix is None:
            ix = MoveIndex.load(os.path.join(index_dir, "index.npz"))
        self = cls(ix)
        self._fused, self._paired, self._paired_search = \
            load_engine_caches(index_dir)
        return self

    def _is_bounded(self) -> bool:
        if self._bounded is None:
            self._bounded = is_bounded(self.ix)
        return self._bounded

    def _pml_ported(self) -> bool:
        return self.ix.thr is not None and self._is_bounded()

    def engine(self, paired: Optional[bool] = None,
               device: DeviceLike = None):
        """The PML engine on `device`: paired=True forces the paired
        records, False the one-step layout, None picks by capacity."""
        if not self._pml_ported():
            raise NotImplementedError(
                "PML on an index without thresholds or not built with "
                "bound_ff=1 (the compact engine) is not yet ported")
        dev = resolve_device(device)
        backend = pick_backend(self.ix.r, self.ix.sigma, "pml",
                               force_paired=paired, device=dev)
        if backend == "compact":
            raise NotImplementedError(
                f"index (r={self.ix.r}) exceeds the device's record-table "
                f"budget; the compact engine is not yet ported")
        if self._fused is None:
            self._fused = build_fused_index(self.ix)
        self._fused = self._fused.to(dev)
        if backend == "paired":
            if self._paired is None:
                self._paired = build_fused2_index(self._fused)
            self._paired = self._paired.to(dev)
            return Fused2PMLEngine(self._paired, dev)
        return FusedPMLEngine(self._fused, dev)

    def search_engine(self, kind: str, paired: Optional[bool] = None,
                      device: DeviceLike = None):
        """The count (kind="count") or ZML ("zml") engine on `device`:
        paired=True forces the paired search records, False the one-step
        layout, None picks by capacity.  Needs an index built with
        bound_ff=1 (thresholds are not used)."""
        if kind not in ("count", "zml"):
            raise ValueError(f"unknown search query {kind!r}")
        if not self._is_bounded():
            raise NotImplementedError(
                f"{kind} on an index not built with bound_ff=1 (the compact "
                f"engine) is not yet ported")
        dev = resolve_device(device)
        backend = pick_backend(self.ix.r, self.ix.sigma, "search",
                               force_paired=paired, device=dev)
        if backend == "compact":
            raise NotImplementedError(
                f"index (r={self.ix.r}) exceeds the device's record-table "
                f"budget; the compact engine is not yet ported")
        if backend == "paired":
            if self._paired_search is None:
                self._paired_search = build_fused_search2_index(self.ix, dev)
            self._paired_search = self._paired_search.to(dev)
            cls = Fused2CountEngine if kind == "count" else Fused2ZMLEngine
            return cls(self._paired_search, dev)
        if self._search is None:
            self._search = build_fused_search_index(self.ix)
        self._search = self._search.to(dev)
        cls = FusedCountEngine if kind == "count" else FusedZMLEngine
        return cls(self._search, dev)

    def color_engine(self, color_table, paired: Optional[bool] = None,
                     device: DeviceLike = None, **color_kw):
        """The Movi Color engine on `device` for `color_table`: paired=True
        forces the paired 32 B records (when the kept doc sets fit 16-bit
        color ids, else the one-step records), False the one-step layout,
        None picks by capacity.  color_kw: min_match_len, pvalue_scoring,
        report_all, min_diff_frac, min_score_frac, early_stop."""
        if not self._pml_ported():
            raise NotImplementedError(
                "multi-class classification on an index without thresholds "
                "or not built with bound_ff=1 (the scalar ColorEngine) is "
                "not yet ported")
        dev = resolve_device(device)
        backend = pick_backend(self.ix.r, self.ix.sigma, "color",
                               force_paired=paired, device=dev,
                               num_sets=len(color_table.unique_doc_sets))
        if backend == "compact":
            raise NotImplementedError(
                f"index (r={self.ix.r}) exceeds the device's record-table "
                f"budget; the compact engine is not yet ported")
        if self._fused is None:
            self._fused = build_fused_index(self.ix)
        self._fused = self._fused.to(dev)
        if backend == "paired":
            if self._paired_color is None or \
                    self._paired_color[0] is not color_table:
                self._paired_color = None  # free the old table first
                self._paired_color = (color_table, build_fused2_color_index(
                    self._fused, color_table))
            return Fused2ColorEngine(self._paired_color[1], color_table, dev,
                                     **color_kw)
        if self._color is None or self._color[0] is not color_table:
            self._color = (color_table, build_fused_color_index(
                self.ix, color_table, self._fused))
        self._color = (color_table, self._color[1].to(dev))
        return FusedColorEngine(self._color[1], color_table, dev,
                                **color_kw)

    @staticmethod
    def _run(eng, reads: Reads, lanes: int):
        out = []
        for batch in _as_batches(reads, lanes):
            out.extend(zip(batch.names, eng.query_batch(batch)))
        return out

    def query_pml(self, reads: Reads, lanes: int = 8192,
                  paired: Optional[bool] = None, device: DeviceLike = None):
        """[(name, pmls)] with pmls in processing (right-to-left) order."""
        return self._run(self.engine(paired, device), reads, lanes)

    def query_count(self, reads: Reads, lanes: int = 8192,
                    paired: Optional[bool] = None,
                    device: DeviceLike = None):
        """[(name, (pos_on_r, match_count))] as query_backward_search."""
        return self._run(self.search_engine("count", paired, device), reads,
                         lanes)

    def query_zml(self, reads: Reads, lanes: int = 8192,
                  paired: Optional[bool] = None, device: DeviceLike = None):
        """[(name, zmls)] with zmls in processing (right-to-left) order."""
        return self._run(self.search_engine("zml", paired, device), reads,
                         lanes)

    def query_multiclass(self, reads: Reads, color_table, lanes: int = 8192,
                         paired: Optional[bool] = None,
                         device: DeviceLike = None, **color_kw):
        """[(name, (pmls, csv_cell, colors))]: the per-base PMLs and color
        ids (the `--report-colors` stream: the kept color id of each
        counted base, the sentinel C for a skipped one), truncated at the
        early-stop point when early_stop is on, in processing order."""
        return self._run(self.color_engine(color_table, paired, device,
                                           **color_kw), reads, lanes)

    def multi_classify(self, reads: Reads, color_table, lanes: int = 8192,
                       paired: Optional[bool] = None,
                       device: DeviceLike = None, **color_kw):
        """Movi Color multi-class classification: [(name, csv_cell)]."""
        return [(name, cell) for name, (_, cell, _) in self.query_multiclass(
            reads, color_table, lanes, paired, device, **color_kw)]


def build_index(fasta, **kw) -> Index:
    return Index.build(fasta, **kw)
