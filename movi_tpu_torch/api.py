"""High-level API, the PML, count, ZML, k-mer and Movi Color surface of
movi_tpu/api.py.

    from movi_tpu_torch import Index

    index = Index.build("ref.fasta")                    # or Index.load(dir)
    index.save("idx_dir")
    res = index.query_pml(reads)                        # [(name, pmls)]
    res = index.query_count(reads)           # [(name, (pos_on_r, count))]
    res = index.query_zml(reads)                        # [(name, zmls)]
    res = index.query_kmers(reads, k=31)     # [(name, [(start, found)])]
    res = index.query_kmers(reads, k=31, counts=True)
                                             # [(name, (found, total))]
    res = index.query_mems(reads, min_mem_length=20)
                                             # [(name, [(pos, end, count)])]
    res = index.multi_classify(reads, color_table)      # [(name, cell)]
    found = index.classify(reads, nulldb)               # [(name, found)]

Reads are (name, bytes) pairs or a fasta/fastq path.  Queries run on the
device passed in (default CUDA; without a card that raises unless the
caller names the CPU).  Routes follow movi_tpu/api.py: the record engines
on an index built with bound_ff=1 (PML and color also need thresholds),
the compact engines past the card's budget for their records, and the
scalar oracles (`Index.scalar`, color.ColorEngine) otherwise or with
jax=False, as the JAX package names that choice.  MEMs run on the MEM v2
table up to MEM2_MAX_N positions and on the v1 machines past it
(engine/fused_mem.py).  SA entries are FusedSAEngine's
(engine/fused_sa.py).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

from .build.prepare_ref import prepare_ref
from .build.suffix import build_bwt_runs
from .index.structure import MoveIndex, build_move_index
from .io.fastx import batches_from_file, iter_fastx, make_batches

from .convert import load_engine_caches
from .device import DeviceLike, resolve_device
from .engine.device_index import (PML_TABLES, SEARCH_TABLES,
                                  build_device_index)
from .engine.fused import (FusedPMLEngine, build_fused_index, is_bounded,
                           save_fused_index)
from .engine.fused2 import (Fused2ColorEngine, Fused2PMLEngine,
                            build_fused2_color_index, build_fused2_index,
                            save_fused2_index)
from .engine.fused_color import FusedColorEngine, build_fused_color_index
from .engine.fused_kmer import FusedKmerCountEngine, FusedKmerEngine
from .engine.fused_kmer2 import FusedKmer2CountEngine
from .engine.fused_mem import (FusedAllMemEngine, FusedMemEngine,
                               build_fused_mem_index)
from .engine.fused_mem2 import (FusedAllMem2Engine, FusedMem2Engine,
                                build_fused_mem2_index, looks_rc_closed,
                                mem2_supported)
from .engine.fused_search import (FusedCountEngine, FusedZMLEngine,
                                  build_fused_search_index)
from .engine.fused_search2 import (Fused2CountEngine, Fused2KmerCountEngine,
                                   Fused2ZMLEngine,
                                   build_fused_search2_index,
                                   save_fused_search2_index)
from .engine.pml import PMLEngine
from .engine.search import CountEngine, ZMLEngine
from .engine.select import pick_backend

Reads = Union[str, Sequence[Tuple[str, bytes]]]


def _as_reads(reads: Reads):
    if isinstance(reads, (str, os.PathLike)):
        return list(iter_fastx(str(reads)))
    return list(reads)


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


def _color_needs_thresholds(ix):
    """The scalar ColorEngine repositions by threshold: on an index
    without thresholds movi_tpu's fails with a TypeError (ROADMAP §3.7);
    the port says why."""
    if ix.thr is None:
        raise ValueError("multi-class classification needs an index with "
                         "thresholds (the scalar ColorEngine repositions "
                         "by threshold)")


class Index:
    def __init__(self, ix: MoveIndex, bwt_runs=None):
        self.ix = ix
        self._runs = bwt_runs  # kept, as movi_tpu keeps them; unread
        self._fused = None    # FusedIndex (host or device tensors)
        self._paired = None   # Fused2Index
        self._search = None   # FusedSearchIndex
        self._paired_search = None  # FusedSearch2Index
        self._kmer_si = None  # (fk, FusedSearchIndex with fk anchor rows)
        self._mem2 = None     # FusedMem2Index (its ftab_k anchor rows)
        self._mem1 = None     # FusedMemIndex (past MEM2_MAX_N positions)
        self._color = None    # (ColorTable, FusedColorIndex)
        self._paired_color = None   # (ColorTable, Fused2ColorIndex)
        self._compact = None  # DeviceIndex (run tables)
        self._scalar = None   # AdvancedEngine
        self._bounded = None
        self._rc_closed = None

    @classmethod
    def build(cls, fasta: Union[str, Sequence[str]],
              mode: str = "regular-thresholds", rc: bool = True,
              separators: bool = False, bound_ff: Optional[int] = 1,
              ) -> "Index":
        ref = prepare_ref(fasta, rc=rc, separators=separators)
        runs = build_bwt_runs(ref.text)
        ix = build_move_index(runs, mode, separators=separators,
                              bound_ff=bound_ff)
        return cls(ix, bwt_runs=runs)

    def save(self, index_dir: str, engine_caches: bool = True):
        """index.npz plus the record caches, in the JAX package's formats
        (either package loads what the other saved)."""
        os.makedirs(index_dir, exist_ok=True)
        self.ix.save(os.path.join(index_dir, "index.npz"))
        if not engine_caches:
            return
        if self._fused is None and self._has_fused_pml():
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

    @property
    def scalar(self):
        """The scalar oracle (AdvancedEngine, a ScalarEngine), built once."""
        if self._scalar is None:
            from .cpu_ref.advanced import AdvancedEngine

            self._scalar = AdvancedEngine(self.ix)
        return self._scalar

    def _is_bounded(self) -> bool:
        if self._bounded is None:
            self._bounded = is_bounded(self.ix)
        return self._bounded

    def _is_rc_closed(self) -> bool:
        """looks_rc_closed, computed once per index (about a second of
        host numpy at five million runs)."""
        if self._rc_closed is None:
            self._rc_closed = looks_rc_closed(self.ix)
        return self._rc_closed

    def _has_fused_pml(self) -> bool:
        """The PML records need thresholds and bound_ff=1."""
        return self.ix.thr is not None and self._is_bounded()

    def _on_device(self, query: str) -> bool:
        """Whether the device engines run `query` ("kmers" or "mems") on
        this index: both need bound_ff=1, MEMs an ACGT alphabet too.  Else
        it takes the scalar oracle, as in movi_tpu."""
        if query not in ("kmers", "mems"):
            raise ValueError(f"unknown query {query!r}")
        return self._is_bounded() and (query == "kmers"
                                       or bytes(self.ix.alphabet) == b"ACGT")

    def use_scalar_ftab(self, ftab_k: int, multi_ftab: bool = False,
                        ftab=None):
        """Give the scalar oracle an ftab of width ftab_k > 1: `ftab` where
        given (one read from an index directory), else one it builds; with
        multi_ftab, every width from 2 to ftab_k."""
        if multi_ftab:
            from .cpu_ref.advanced import AdvancedEngine

            self._scalar = AdvancedEngine(self.ix, ftab_k=ftab_k,
                                          multi_ftab=True)
        elif ftab is not None:
            self.scalar.ftab, self.scalar.ftab_k = ftab, ftab_k
        else:
            self.scalar.build_ftab(ftab_k)

    def engine(self, paired: Optional[bool] = None,
               device: DeviceLike = None):
        """The PML engine on `device`: paired=True forces the paired
        records, False the one-step layout, None picks by capacity.  An
        index the records cannot hold (no thresholds, or not built with
        bound_ff=1), or past the budget for both layouts, gets the compact
        engine (threshold repositioning where there are thresholds)."""
        dev = resolve_device(device)
        if not self._has_fused_pml():
            return self.compact_engine("pml", self.ix.thr is None, dev)
        backend = pick_backend(self.ix.r, self.ix.sigma, "pml",
                               force_paired=paired, device=dev)
        if backend == "compact":
            return self.compact_engine("pml", device=dev)
        if self._fused is None:
            self._fused = build_fused_index(self.ix)
        self._fused = self._fused.to(dev)
        if backend == "paired":
            if self._paired is None:
                self._paired = build_fused2_index(self._fused)
            self._paired = self._paired.to(dev)
            return Fused2PMLEngine(self._paired, dev)
        return FusedPMLEngine(self._fused, dev)

    def compact_engine(self, kind: str, random_repositioning: bool = False,
                       device: DeviceLike = None):
        """The compact engine of `kind` ("pml", "count" or "zml") on
        `device`, on the run tables (built once per index): PML
        repositions by threshold, or with random_repositioning by query
        --rpml's rule."""
        if kind not in ("pml", "count", "zml"):
            raise ValueError(f"no compact engine for {kind!r}")
        dev = resolve_device(device)
        if self._compact is None:
            self._compact = build_device_index(self.ix)
        # the tables this kind's scan reads, on dev (kept for the next
        # engine)
        self._compact = self._compact.to(
            dev, PML_TABLES if kind == "pml" else SEARCH_TABLES)
        if kind == "pml":
            return PMLEngine(self._compact, random_repositioning, dev)
        cls = CountEngine if kind == "count" else ZMLEngine
        return cls(self._compact, dev)

    def search_engine(self, kind: str, paired: Optional[bool] = None,
                      device: DeviceLike = None):
        """The count (kind="count") or ZML ("zml") engine on `device`:
        paired=True forces the paired search records, False the one-step
        layout, None picks by capacity.  An index not built with bound_ff=1,
        or past the budget for both layouts, gets the compact engine."""
        if kind not in ("count", "zml"):
            raise ValueError(f"unknown search query {kind!r}")
        dev = resolve_device(device)
        backend = (pick_backend(self.ix.r, self.ix.sigma, "search",
                                force_paired=paired, device=dev)
                   if self._is_bounded() else "compact")
        if backend == "compact":
            return self.compact_engine(kind, device=dev)
        if backend == "paired":
            cls = Fused2CountEngine if kind == "count" else Fused2ZMLEngine
        else:
            cls = FusedCountEngine if kind == "count" else FusedZMLEngine
        return cls(self._search_tables(backend, dev), dev)

    def _search_tables(self, backend: str, dev):
        """The paired or one-step search records on dev, built once."""
        if backend == "paired":
            if self._paired_search is None:
                self._paired_search = build_fused_search2_index(self.ix, dev)
            self._paired_search = self._paired_search.to(dev)
            return self._paired_search
        if self._search is None:
            self._search = build_fused_search_index(self.ix)
        self._search = self._search.to(dev)
        return self._search

    def _require_bounded(self, what: str):
        if not self._is_bounded():
            raise ValueError(
                f"{what} on an index not built with bound_ff=1 run on the "
                f"scalar AdvancedEngine (Index.scalar, the query_* "
                f"methods)")

    def kmer_engine(self, k: int = 31, counts: bool = False,
                    paired: Optional[bool] = None,
                    device: DeviceLike = None, ftab_k: int = 10):
        """The k-mer engine on `device`.  Membership (counts=False) runs
        the one-step search records with fk = min(ftab_k, k - k//3) ftab
        anchor rows on an ACGT index (none when fk <= 1).  Exact counts
        (counts=True) take the paired search records when paired=True or
        when they fit (paired=None), else the one-step records; on a
        reverse-complement closed index whose MEM v2 table fits
        (mem2_supported) the paired route is the bidirectional engine.
        Past the budget for both layouts they take the one-step records,
        as the JAX package does."""
        dev = resolve_device(device)
        self._require_bounded("k-mer queries")
        if not counts:
            fk = 0
            if bytes(self.ix.alphabet) == b"ACGT":
                fk = min(ftab_k, k - k // 3)
                if fk <= 1:
                    fk = 0
            if self._kmer_si is None or self._kmer_si[0] != fk:
                self._kmer_si = None  # free the old table first
                self._kmer_si = (fk, build_fused_search_index(self.ix, fk))
            self._kmer_si = (fk, self._kmer_si[1].to(dev))
            return FusedKmerEngine(self._kmer_si[1], k, dev)
        backend = pick_backend(self.ix.r, self.ix.sigma, "search",
                               force_paired=paired, device=dev)
        tables = self._search_tables(backend, dev)
        if backend != "paired":
            return FusedKmerCountEngine(tables, k, dev)
        # the bidirectional engine needs reverse-complement closure; past
        # the MEM v2 cap the paired engine gives the same answers (the JAX
        # package skips this check, ROADMAP §3.2)
        if self._is_rc_closed() and mem2_supported(self.ix):
            # any anchor width will do: the counts read no anchor rows
            m2 = self._mem2_table(
                0 if self._mem2 is None else self._mem2.ftab_k, dev)
            return FusedKmer2CountEngine(m2, tables, k, device=dev)
        return Fused2KmerCountEngine(tables, k, dev)

    def _mem2_table(self, ftab_k: int, dev):
        """The MEM v2 table with ftab_k anchor rows on dev, built once
        (the old one is freed first when the width changes)."""
        if self._mem2 is None or self._mem2.ftab_k != ftab_k:
            self._mem2 = None
            self._mem2 = build_fused_mem2_index(self.ix, ftab_k)
        self._mem2 = self._mem2.to(dev)
        return self._mem2

    def mem_engine(self, min_mem_length: int = 0, device: DeviceLike = None,
                   table_ftab_k: int = 10):
        """The MEM engine on `device`: BML for min_mem_length >= 2, all-MEMs
        otherwise.  Up to MEM2_MAX_N positions on the MEM v2 table with
        table_ftab_k anchor rows (used when 1 < table_ftab_k <= L); past
        it, as in movi_tpu, on the v1 machines (table_ftab_k unused)."""
        dev = resolve_device(device)
        self._require_bounded("MEMs")
        if bytes(self.ix.alphabet) != b"ACGT":
            raise ValueError("MEMs on an index not over ACGT run on the "
                             "scalar AdvancedEngine (Index.scalar, "
                             "query_mems)")
        if not mem2_supported(self.ix):
            # the v1 table, built once (pos2rba on the device)
            if self._mem1 is None:
                self._mem1 = build_fused_mem_index(self.ix, dev)
            self._mem1 = self._mem1.to(dev)
            if min_mem_length >= 2:
                return FusedMemEngine(self._mem1, min_mem_length, dev)
            return FusedAllMemEngine(self._mem1, dev)
        m2 = self._mem2_table(table_ftab_k, dev)
        if min_mem_length >= 2:
            return FusedMem2Engine(m2, min_mem_length, dev)
        return FusedAllMem2Engine(m2, dev)

    def color_engine(self, color_table, paired: Optional[bool] = None,
                     device: DeviceLike = None, **color_kw):
        """The Movi Color engine on `device` for `color_table`: paired=True
        forces the paired 32 B records (when the kept doc sets fit 16-bit
        color ids, else the one-step records), False the one-step layout,
        None picks by capacity (past the budget for both layouts, the
        one-step records, as the JAX package runs them).  color_kw:
        min_match_len, pvalue_scoring, report_all, min_diff_frac,
        min_score_frac, early_stop."""
        dev = resolve_device(device)
        if not self._has_fused_pml():
            raise ValueError(
                "multi-class classification on an index without thresholds "
                "or not built with bound_ff=1 runs on the scalar ColorEngine "
                "(Index.multi_classify)")
        backend = pick_backend(self.ix.r, self.ix.sigma, "color",
                               force_paired=paired, device=dev,
                               num_sets=len(color_table.unique_doc_sets))
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
                  paired: Optional[bool] = None, device: DeviceLike = None,
                  jax: bool = True):
        """[(name, pmls)] with pmls in processing (right-to-left) order.
        The record engines need thresholds and bound_ff=1; other indexes,
        and jax=False, take the scalar oracle (random repositioning
        without thresholds), as movi_tpu's Index.query_pml does."""
        dev = resolve_device(device)
        if jax and self._has_fused_pml():
            return self._run(self.engine(paired, dev), reads, lanes)
        rand = self.ix.thr is None
        return [(n, self.scalar.query_pml(s, random_repositioning=rand))
                for n, s in _as_reads(reads)]

    def _search_query(self, kind: str, reads: Reads, lanes: int, paired,
                      device, jax: bool):
        dev = resolve_device(device)
        if jax and self._is_bounded():
            return self._run(self.search_engine(kind, paired, dev), reads,
                             lanes)
        query = (self.scalar.query_count if kind == "count"
                 else self.scalar.query_zml)
        return [(n, query(s)) for n, s in _as_reads(reads)]

    def query_count(self, reads: Reads, lanes: int = 8192,
                    paired: Optional[bool] = None,
                    device: DeviceLike = None, jax: bool = True):
        """[(name, (pos_on_r, match_count))] as query_backward_search; an
        index not built with bound_ff=1, and jax=False, take the scalar
        oracle."""
        return self._search_query("count", reads, lanes, paired, device, jax)

    def query_zml(self, reads: Reads, lanes: int = 8192,
                  paired: Optional[bool] = None, device: DeviceLike = None,
                  jax: bool = True):
        """[(name, zmls)] with zmls in processing (right-to-left) order; an
        index not built with bound_ff=1, and jax=False, take the scalar
        oracle."""
        return self._search_query("zml", reads, lanes, paired, device, jax)

    def query_kmers(self, reads: Reads, k: int = 31, counts: bool = False,
                    lanes: int = 8192, paired: Optional[bool] = None,
                    device: DeviceLike = None, ftab_k: int = 10,
                    jax: bool = True):
        """Membership: [(name, [(kmer_start_pos, found_count)])] in
        descending position order (query_all_kmers); counts=True: [(name,
        (found_kmers, total_occurrences))] (count_kmers_bidirectional).  An
        index not built with bound_ff=1, and jax=False, take the scalar
        oracle (without an ftab)."""
        dev = resolve_device(device)
        if jax and self._on_device("kmers"):
            return self._run(self.kmer_engine(k, counts, paired, dev,
                                              ftab_k), reads, lanes)
        if counts:
            return [(n, self.scalar.count_kmers_bidirectional(s, k))
                    for n, s in _as_reads(reads)]
        return [(n, self.scalar.query_all_kmers(s, k))
                for n, s in _as_reads(reads)]

    def query_mems(self, reads: Reads, min_mem_length: int = 0,
                   ftab_k: int = 0, lanes: int = 8192,
                   device: DeviceLike = None, jax: bool = True):
        """[(name, [(pos, end, count)])]: query_mems(seq, L) for
        min_mem_length >= 2 (BML, on the MEM v2 table with ftab-10
        anchors, or past MEM2_MAX_N positions on the v1 machines),
        query_all_mems otherwise.  ftab_k > 1, an index not built with
        bound_ff=1 or not over ACGT, and jax=False take the scalar oracle
        (with its own ftab of width ftab_k)."""
        dev = resolve_device(device)
        if jax and ftab_k <= 1 and self._on_device("mems"):
            return self._run(self.mem_engine(min_mem_length, dev), reads,
                             lanes)
        eng = self.scalar
        if ftab_k > 1 and eng.ftab_k != ftab_k:
            eng.build_ftab(ftab_k)
        return [(n, eng.query_mems(s, min_mem_length))
                for n, s in _as_reads(reads)]

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
                       device: DeviceLike = None, jax: bool = True,
                       **color_kw):
        """Movi Color multi-class classification: [(name, csv_cell)].  An
        index without thresholds or not built with bound_ff=1, and
        jax=False, take the scalar ColorEngine."""
        dev = resolve_device(device)
        if jax and self._has_fused_pml():
            return [(name, cell) for name, (_, cell, _) in
                    self.query_multiclass(reads, color_table, lanes, paired,
                                          dev, **color_kw)]
        from .color import ColorEngine

        _color_needs_thresholds(self.ix)
        eng = ColorEngine(self.ix, color_table, **color_kw)
        return [(n, eng.query_pml_multiclass(s)[1])
                for n, s in _as_reads(reads)]

    def classify(self, reads: Reads, nulldb=None, bin_width: int = 150,
                 lanes: int = 8192, device: DeviceLike = None):
        """Binary SPUMONI classification of each read's PMLs against the
        null database: [(name, found)]."""
        from .classify import Classifier

        reads = _as_reads(reads)
        if nulldb is None:
            raise ValueError("classify requires a null database "
                             "(build one with movi_tpu_torch.classify)")
        cl = Classifier(nulldb, bin_width=bin_width)
        return [(name, cl.classify(pmls)[0])
                for name, pmls in self.query_pml(reads, lanes,
                                                 device=device)]


def build_index(fasta, **kw) -> Index:
    return Index.build(fasta, **kw)
