"""Copy of movi_tpu/color.py: the port keeps its own, so it imports nothing
of the JAX package.

Movi Color: multi-class (per-document) classification.

Mirrors src/move_structure_color.cpp + the multi-class query paths in
move_structure_query.cpp:252-471:
  - doc_pats: document id for every BWT row.  The reference derives them
    with an O(n) LF sweep (build_doc_pats, :4-24); we take them directly
    from the build-time suffix array.
  - doc_sets: unique sorted doc-set per run, deduplicated (:27-72)
  - frequency compression keeping the top 2^16 sets, singletons first
    (:114-169)
  - flat color table (flat_and_serialize_colors_vectors,
    move_structure_io.cpp:513-548)
  - document metadata (load_document_info, move_structure_io.cpp:643-708)
  - query-time per-base doc voting with best/second-best and p-value
    scoring (move_structure_query.cpp:373-470)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .constants import UNCLASSIFIED_THRESHOLD
from .cpu_ref.scalar import ScalarEngine
from .index.structure import MoveIndex

LOG4 = math.log(4)


@dataclass
class DocumentInfo:
    """load_document_info semantics: taxon ids compressed to
    0..num_species-1 in sorted taxon order."""

    doc_offsets: np.ndarray      # int64[num_docs] cumulative end offsets
    doc_ids: np.ndarray          # int32[num_docs] compressed species ids
    to_taxon_id: np.ndarray      # int64[num_species] species -> taxon id
    log_lens: np.ndarray         # float64[num_species]

    @property
    def num_docs(self):
        return len(self.doc_offsets)

    @property
    def num_species(self):
        return len(self.to_taxon_id)

    @classmethod
    def create(cls, doc_offsets: Sequence[int],
               taxon_ids: Optional[Sequence[int]] = None) -> "DocumentInfo":
        doc_offsets = np.asarray(doc_offsets, dtype=np.int64)
        num_docs = len(doc_offsets)
        if taxon_ids is None:
            taxon_ids = np.arange(1, num_docs + 1, dtype=np.int64)
        else:
            taxon_ids = np.asarray(taxon_ids, dtype=np.int64)
        uniq = np.unique(taxon_ids)  # sorted, like std::map iteration
        compress = {int(t): i for i, t in enumerate(uniq)}
        doc_ids = np.array([compress[int(t)] for t in taxon_ids],
                           dtype=np.int32)
        log_lens = np.zeros(len(uniq))
        prev = 0
        for i in range(num_docs):
            log_lens[doc_ids[i]] += doc_offsets[i] - prev
            prev = doc_offsets[i]
        log_lens = np.log(np.maximum(log_lens, 1))
        return cls(doc_offsets=doc_offsets, doc_ids=doc_ids,
                   to_taxon_id=uniq, log_lens=log_lens)


@dataclass
class ColorTable:
    doc_pats: Optional[np.ndarray]      # uint16[n] species per BWT row
    # (None when loaded from doc_sets-only reference binaries; only the
    # build paths need it)
    doc_set_inds: np.ndarray            # int64[r] run -> unique set index
    unique_doc_sets: List[np.ndarray]   # each: sorted uint16 species ids
    doc_info: DocumentInfo = None

    def save_reference(self, index_dir: str, compressed: bool = False,
                       flat: bool = False):
        """Write the reference's color binaries into the index dir:
        doc_pats.bin + doc_sets.bin (or compress_doc_sets.bin when the
        table is frequency/tree compressed) + doc_sets_flat.bin
        (movi.cpp:175-213; formats move_structure_io.cpp:513-585)."""
        import os

        from .index.movi_format import (write_doc_pats_bin,
                                        write_doc_sets_bin,
                                        write_doc_sets_flat_bin)

        if self.doc_pats is not None:
            write_doc_pats_bin(self.doc_pats,
                               os.path.join(index_dir, "doc_pats.bin"))
        name = "compress_doc_sets.bin" if compressed else "doc_sets.bin"
        write_doc_sets_bin(self.unique_doc_sets, self.doc_set_inds,
                           os.path.join(index_dir, name))
        if flat:
            # the flat layout cannot express dropped (compressed-away)
            # runs, whose index points past the kept table
            inds = self.doc_set_inds
            if int(inds.max(initial=0)) < len(self.unique_doc_sets):
                write_doc_sets_flat_bin(
                    self.unique_doc_sets, inds,
                    os.path.join(index_dir, "doc_sets_flat.bin"))

    @classmethod
    def load_reference(cls, index_dir: str, r: int,
                       doc_info: "DocumentInfo",
                       length: Optional[int] = None) -> "ColorTable":
        """Load color tables from the reference binaries
        (load_color_table, movi.cpp:120-150): doc_sets.bin /
        compress_doc_sets.bin / doc_sets_flat.bin, plus doc_pats.bin when
        present."""
        import os

        from .index.movi_format import (read_doc_pats_bin,
                                        read_doc_sets_bin,
                                        read_doc_sets_flat_bin)

        sets = inds = None
        for name in ("doc_sets.bin", "compress_doc_sets.bin",
                     "tree_doc_sets.bin"):
            p = os.path.join(index_dir, name)
            if os.path.exists(p):
                sets, inds = read_doc_sets_bin(p, r)
                break
        else:
            p = os.path.join(index_dir, "doc_sets_flat.bin")
            if os.path.exists(p):
                sets, inds = read_doc_sets_flat_bin(p, r)
        if sets is None:
            raise FileNotFoundError(
                f"no doc_sets[.bin|_flat.bin] in {index_dir}")
        dp_path = os.path.join(index_dir, "doc_pats.bin")
        doc_pats = (read_doc_pats_bin(dp_path, length)
                    if length is not None and os.path.exists(dp_path)
                    else None)
        return cls(doc_pats=doc_pats, doc_set_inds=inds,
                   unique_doc_sets=sets, doc_info=doc_info)

    def save(self, path: str):
        flat, offsets = self.flatten()
        np.savez_compressed(
            path, doc_pats=self.doc_pats, doc_set_inds=self.doc_set_inds,
            flat=flat, doc_offsets=self.doc_info.doc_offsets,
            doc_ids=self.doc_info.doc_ids,
            to_taxon_id=self.doc_info.to_taxon_id,
            log_lens=self.doc_info.log_lens)

    @classmethod
    def load(cls, path: str) -> "ColorTable":
        z = np.load(path)
        flat = z["flat"]
        sets = []
        off = 0
        while off < len(flat):
            size = int(flat[off])
            sets.append(flat[off + 1 : off + 1 + size].astype(np.uint16))
            off += size + 1
        di = DocumentInfo(doc_offsets=z["doc_offsets"], doc_ids=z["doc_ids"],
                          to_taxon_id=z["to_taxon_id"],
                          log_lens=z["log_lens"])
        return cls(doc_pats=z["doc_pats"], doc_set_inds=z["doc_set_inds"],
                   unique_doc_sets=sets, doc_info=di)

    def flatten(self) -> Tuple[np.ndarray, np.ndarray]:
        """Flat color table: [size, docs...] blocks + per-set offsets
        (flat_and_serialize_colors_vectors)."""
        parts = []
        offsets = np.zeros(len(self.unique_doc_sets), dtype=np.int64)
        off = 0
        for i, s in enumerate(self.unique_doc_sets):
            offsets[i] = off
            parts.append(np.concatenate([[len(s)], s]).astype(np.int64))
            off += len(s) + 1
        flat = (np.concatenate(parts) if parts
                else np.zeros(0, dtype=np.int64))
        return flat, offsets


def load_document_info(index_dir: str) -> DocumentInfo:
    """Read ref.fa.doc_offsets (+ optional ref.fa.doc_ids taxon ids), like
    load_document_info (move_structure_io.cpp:643-708)."""
    import os

    offsets_path = os.path.join(index_dir, "ref.fa.doc_offsets")
    if not os.path.exists(offsets_path):
        raise FileNotFoundError(f"doc_offsets file not found at {offsets_path}")
    doc_offsets = np.loadtxt(offsets_path, dtype=np.int64, ndmin=1)
    ids_path = os.path.join(index_dir, "ref.fa.doc_ids")
    taxon_ids = (np.loadtxt(ids_path, dtype=np.int64, ndmin=1)
                 if os.path.exists(ids_path) else None)
    return DocumentInfo.create(doc_offsets, taxon_ids)


def build_color_table(ix: MoveIndex, sa: np.ndarray,
                      doc_info: DocumentInfo) -> ColorTable:
    """doc_pats from the build-time suffix array + per-run doc sets."""
    ends = doc_info.doc_offsets
    # document of each text position, then per BWT row via SA
    doc_of_pos = np.searchsorted(ends, sa, side="right")
    doc_of_pos = np.minimum(doc_of_pos, doc_info.num_docs - 1)
    doc_pats = doc_info.doc_ids[doc_of_pos].astype(np.uint16)
    return color_table_from_doc_pats(ix, doc_pats, doc_info)


def build_color_table_from_index(ix: MoveIndex,
                                 doc_info: DocumentInfo) -> ColorTable:
    """Standalone `color` subcommand path: derive doc_pats from the index
    alone via an O(n) LF sweep (build_doc_pats,
    move_structure_color.cpp:4-24), no suffix array needed."""
    from .index.sweeps import lf_sweep

    _, doc_pats = lf_sweep(ix, doc_offsets=doc_info.doc_offsets,
                           doc_ids=doc_info.doc_ids)
    return color_table_from_doc_pats(ix, doc_pats, doc_info)


def color_table_from_doc_pats(ix: MoveIndex, doc_pats: np.ndarray,
                              doc_info: DocumentInfo) -> ColorTable:
    """Per-run unique sorted doc sets, deduplicated (build_doc_sets,
    move_structure_color.cpp:27-72)."""
    r = ix.r
    run_of_p = np.repeat(np.arange(r, dtype=np.int64),
                         ix.n_arr.astype(np.int64))
    num_sp = doc_info.num_species
    key = run_of_p * num_sp + doc_pats
    uniq_keys = np.unique(key)
    runs_k = uniq_keys // num_sp
    docs_k = (uniq_keys % num_sp).astype(np.uint16)

    doc_set_inds = np.zeros(r, dtype=np.int64)
    unique_doc_sets: List[np.ndarray] = []
    seen: Dict[bytes, int] = {}
    # group by run (uniq_keys sorted -> runs grouped, docs sorted in-group)
    boundaries = np.flatnonzero(np.diff(runs_k, prepend=-1))
    boundaries = np.append(boundaries, len(runs_k))
    for b in range(len(boundaries) - 1):
        lo, hi = boundaries[b], boundaries[b + 1]
        run = int(runs_k[lo])
        docs = docs_k[lo:hi]
        kb = docs.tobytes()
        idx = seen.get(kb)
        if idx is None:
            idx = len(unique_doc_sets)
            seen[kb] = idx
            unique_doc_sets.append(docs.copy())
        doc_set_inds[run] = idx
    return ColorTable(doc_pats=doc_pats, doc_set_inds=doc_set_inds,
                      unique_doc_sets=unique_doc_sets, doc_info=doc_info)


def compress_color_table(ct: ColorTable, take: int = 1 << 16) -> ColorTable:
    """Frequency compression: keep the `take` most frequent sets,
    singletons first (compress_doc_sets, :114-169).  Dropped runs point
    past the kept table (skipped at query time)."""
    num_sets = len(ct.unique_doc_sets)
    if num_sets <= take:
        return ct
    cnts = np.bincount(ct.doc_set_inds, minlength=num_sets)
    singleton = np.array([len(s) == 1 for s in ct.unique_doc_sets])
    order = sorted(range(num_sets),
                   key=lambda i: (bool(singleton[i]), int(cnts[i]), i),
                   reverse=True)
    keep = order[:take]
    compress_to = np.full(num_sets, take, dtype=np.int64)
    new_sets = []
    for new_i, old_i in enumerate(keep):
        compress_to[old_i] = new_i
        new_sets.append(ct.unique_doc_sets[old_i])
    return ColorTable(doc_pats=ct.doc_pats,
                      doc_set_inds=compress_to[ct.doc_set_inds],
                      unique_doc_sets=new_sets, doc_info=ct.doc_info)


class ColorEngine(ScalarEngine):
    """Scalar multi-class classification engine."""

    def __init__(self, ix: MoveIndex, ct: ColorTable,
                 min_match_len: int = 0, pvalue_scoring: bool = False,
                 report_all: bool = False, min_diff_frac: float = 0.05,
                 min_score_frac: float = 0.0, report_colors: bool = False,
                 early_stop: bool = False):
        super().__init__(ix)
        self.ct = ct
        self.min_match_len = min_match_len
        self.pvalue_scoring = pvalue_scoring
        self.report_all = report_all
        self.min_diff_frac = min_diff_frac
        self.min_score_frac = min_score_frac
        self.report_colors = report_colors
        self.early_stop = early_stop
        self.last_colors: List[int] = []

    def query_pml_multiclass(self, read: bytes) -> Tuple[List[int], str]:
        """PML with per-base doc-set voting
        (move_structure_query.cpp:252-471).  Returns (pmls, csv_cell)
        where csv_cell is "primary,secondary" in taxon ids.  With
        report_colors, self.last_colors holds the per-base color ids
        (sentinel = num unique sets for skipped bases;
        read_processor.cpp:171-186)."""
        ix = self.ix
        ct = self.ct
        di = ct.doc_info
        num_sp = di.num_species
        cnts = np.zeros(num_sp, dtype=np.int64)
        scores = np.zeros(num_sp)
        best = -1
        second = -1
        colors_count = 0
        self.last_colors = []
        r_arr = np.frombuffer(read, dtype=np.uint8)
        idx = ix.r - 1
        offset = int(ix.n_arr[idx]) - 1
        match_len = 0
        out: List[int] = []
        sum_ml = 0
        for pos in range(len(r_arr) - 1, -1, -1):
            c = int(r_arr[pos])
            if not self.check_alphabet(c):
                match_len = 0
            else:
                read_alpha = int(ix.alphamap[c])
                row_char = int(ix.alphabet[ix.c_arr[idx]])
                if row_char == c:
                    match_len += 1
                else:
                    idx, up = self.reposition_thresholds(idx, offset,
                                                         read_alpha)
                    match_len = 0
                    offset = int(ix.n_arr[idx]) - 1 if up else 0
            sum_ml += match_len
            out.append(match_len)
            offset, idx, _ = self.lf_move(offset, idx)
            # voting happens after the LF step (reference order :361-436)
            if match_len >= self.min_match_len:
                colors_count += 1
                color_id = int(ct.doc_set_inds[idx])
                if color_id >= len(ct.unique_doc_sets):
                    continue  # compressed away (skipped before add_color)
                if self.report_colors:
                    self.last_colors.append(color_id)
                for doc in ct.unique_doc_sets[color_id]:
                    doc = int(doc)
                    if not self.pvalue_scoring:
                        cnts[doc] += 1
                        if doc != best:
                            if best < 0 or cnts[doc] > cnts[best]:
                                second = best
                                best = doc
                            elif second < 0 or cnts[doc] > cnts[second]:
                                second = doc
                    else:
                        val = match_len - di.log_lens[doc] / LOG4
                        if val >= 0:
                            scores[doc] += min(val, 1.0)
                            if doc != best:
                                if best < 0 or scores[doc] > scores[best]:
                                    second = best
                                    best = doc
                                elif (second < 0
                                      or scores[doc] > scores[second]):
                                    second = doc
            elif self.report_colors:
                # skipped base sentinel (read_processor.cpp:180-185)
                self.last_colors.append(len(ct.unique_doc_sets))

            # early stop for unclassified reads: past the midpoint, every
            # 100 bases, abort if the running PML mean is below the
            # classification threshold (read_processor.cpp:240-250)
            if self.early_stop:
                p1 = pos - 1
                L = len(r_arr)
                if 0 <= p1 < L / 2 and p1 % 100 == 0:
                    # integer form of sum/(L-p1) < 0.4: exact, and
                    # identical on device (int32) and host
                    if 5 * sum_ml < 2 * (L - p1):
                        break

        vals = scores if self.pvalue_scoring else cnts
        pml_mean = sum_ml / max(len(r_arr), 1)
        cell = format_multiclass_cell(
            vals, best, second, colors_count, pml_mean, di,
            report_all=self.report_all, min_diff_frac=self.min_diff_frac,
            min_score_frac=self.min_score_frac)
        return out, cell


def format_multiclass_cell(vals, best, second, colors_count, pml_mean, di,
                           report_all=False, min_diff_frac=0.05,
                           min_score_frac=0.0) -> str:
    """CSV report cell (move_structure_query.cpp:439-471 for the two-best
    format; read_processor.cpp:489-561 for --report-all)."""
    num_sp = di.num_species
    if pml_mean < UNCLASSIFIED_THRESHOLD or best < 0:
        return "0" if report_all else "0,0"
    if report_all:
        parts = []
        if min_score_frac == 0:
            # min-diff-frac mode: always write the best, then every
            # other doc within min_diff_frac of it
            parts.append(str(di.to_taxon_id[best]))
            for i in range(num_sp):
                if i != best and (vals[best] - vals[i]
                                  ) < min_diff_frac * vals[best]:
                    parts.append(str(di.to_taxon_id[i]))
            return ",".join(parts)
        # min-score-frac mode: every doc with enough of the votes
        for i in range(num_sp):
            if vals[i] >= min_score_frac * colors_count:
                parts.append(str(di.to_taxon_id[i]))
        return "," + ",".join(parts) if parts else "0"
    if second < 0:
        return f"{di.to_taxon_id[best]},0"
    b, s = vals[best], vals[second]
    if (b - s) < 0.05 * b:
        return f"{di.to_taxon_id[best]},{di.to_taxon_id[second]}"
    return f"{di.to_taxon_id[best]},0"
