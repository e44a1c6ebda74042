"""Copy of movi_tpu/classify.py: the port keeps its own, so it imports nothing
of the JAX package.

Read classification + empirical null statistics.

Mirrors the reference:
  - null read generation: parse_null_reads (src/utils.cpp:427-475)
  - EmpNullDatabase: src/emperical_null_database.cpp
  - binary SPUMONI classification: src/classifier.cpp
Output formats (report table, filter echo) are byte-compatible.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .constants import (MIN_MATCHING_LENGTH, NULL_READ_BOUND,
                        NULL_READ_CHUNK, NUM_NULL_READS)


def generate_null_reads(records: Sequence[Tuple[str, bytes]],
                        rng: np.random.Generator,
                        chunk: int = NULL_READ_CHUNK) -> List[Tuple[str, bytes]]:
    """Extract ~800-1000 reversed random substrings of the reference
    (utils.cpp:427-475).  `records` are the raw fasta records.

    The reference uses rand(time(0)); we take an explicit RNG so runs are
    reproducible.  The classification outcome is robust to the sample (the
    reference regenerates the null set every build and still matches its
    golden outputs).
    """
    out: List[Tuple[str, bytes]] = []
    go = True
    for name, seq in records:
        if not go:
            break
        reads_to_grab = 25 if len(out) >= NUM_NULL_READS else 100
        if len(seq) > chunk:
            for _ in range(reads_to_grab):
                if not go:
                    break
                i = int(rng.integers(0, len(seq) - chunk))
                grab = seq[i : i + chunk]
                if b"N" not in grab:
                    out.append((f"read_{len(out)}", grab[::-1]))
                    go = len(out) < NULL_READ_BOUND
        else:
            out.append((f"read_{len(out)}", seq[::-1]))
    return out


@dataclass
class EmpNullDatabase:
    """Null matching-length statistics (emperical_null_database.cpp)."""

    null_stats: np.ndarray = field(default_factory=lambda: np.zeros(0, np.uint16))
    mean_null_stat: float = 0.0
    percentile_value: int = 0

    def compute(self, ml_stats: Sequence[int]):
        """compute_stats (:46-92): percentile = largest value occurring
        >= 5 times."""
        arr = np.asarray(ml_stats, dtype=np.int64)
        self.null_stats = arr.astype(np.uint16)
        self.mean_null_stat = float(arr.mean()) if len(arr) else 0.0
        vals, cnts = np.unique(arr, return_counts=True)
        common = vals[cnts >= 5]
        self.percentile_value = int(common.max()) if len(common) else 0

    # serialization matches the reference layout (:94-127)
    def save(self, path: str):
        with open(path, "wb") as f:
            f.write(struct.pack("<Q", len(self.null_stats)))
            f.write(struct.pack("<d", self.mean_null_stat))
            f.write(struct.pack("<Q", self.percentile_value))
            f.write(self.null_stats.astype("<u2").tobytes())

    @classmethod
    def load(cls, path: str) -> "EmpNullDatabase":
        with open(path, "rb") as f:
            (num,) = struct.unpack("<Q", f.read(8))
            (mean,) = struct.unpack("<d", f.read(8))
            (perc,) = struct.unpack("<Q", f.read(8))
            stats = np.frombuffer(f.read(num * 2), dtype="<u2")
        return cls(null_stats=np.array(stats), mean_null_stat=mean,
                   percentile_value=int(perc))


class Classifier:
    """Binary SPUMONI classification (classifier.cpp:69-143)."""

    def __init__(self, nulldb: EmpNullDatabase, bin_width: int = 150):
        self.max_value_thr = max(nulldb.percentile_value,
                                 MIN_MATCHING_LENGTH) + 1
        self.bin_width = bin_width

    def bins(self, matching_lens: Sequence[int]):
        """Bin maxima; bins follow classifier.cpp:77-92 exactly (the last
        short region merges into the previous bin)."""
        mls = np.asarray(matching_lens)
        maxima = []
        start = 0
        n = len(mls)
        while start < n:
            end = start + self.bin_width if start + self.bin_width < n else n
            if n - end < self.bin_width:
                end = n
            maxima.append(int(mls[start:end].max()))
            start = end
        return maxima

    def classify(self, matching_lens: Sequence[int]):
        """Returns (found, avg_max, bins_above, bins_below)."""
        maxima = self.bins(matching_lens)
        above = sum(1 for m in maxima if m >= self.max_value_thr)
        below = len(maxima) - above
        found = above / (above + below) > 0.50
        avg = sum(maxima) / len(maxima)
        return found, avg, above, below


def format_report_header(max_value_thr: int) -> str:
    """classifier.cpp:52-59 fixed-width header line."""
    return (f"{'read id:':<30}{'status:':<15}{'avg max-value (thr=':<19}"
            f"{max_value_thr:<2}{'):':<5}{'above thr:':<12}{'below thr:':<12}")


def _cpp_precision3(x: float) -> str:
    """C++ `ostream << double` after `precision(3)` (defaultfloat).

    [ostream.inserters.arithmetic] defines this as printf %.3g, and
    CPython's ``.3g`` implements the same C99 %g rules (fixed vs
    scientific switch at exponent < -4 or >= 3, trailing-zero trim,
    2-digit signed exponent), so the two are byte-identical.  Verified
    against g++ ostream output for the boundary values 999.4/999.5/
    1000, 0.0001/0.00009999, 1e-7, 1e6, 0 (tests/test_classify.py).
    """
    return f"{x:.3g}"


def format_report_line(read_name: str, found: bool, avg: float,
                       above: int, below: int) -> str:
    """classifier.cpp:130-139."""
    status = "FOUND" if found else "NOT_PRESENT"
    return (f"{read_name:<30}{status:<15}{_cpp_precision3(avg):<26}"
            f"{above:<12}{below:<12}")


def build_nulldb_pml(index, query_pml_fn, records, seed: int = 0,
                     null_reads_path: Optional[str] = None
                     ) -> EmpNullDatabase:
    """Generate null reads from the raw reference records, run PML on
    them, compute the null statistics (classifier.cpp:12-22).  When
    null_reads_path is given, the generated reads are persisted like the
    reference's index/null_reads.fasta."""
    rng = np.random.default_rng(seed)
    null_reads = generate_null_reads(records, rng)
    if null_reads_path:
        with open(null_reads_path, "w") as f:
            for name, seq in null_reads:
                f.write(f">{name}\n{seq.decode()}\n")
    stats: List[int] = []
    for _, seq in null_reads:
        stats.extend(query_pml_fn(seq))
    db = EmpNullDatabase()
    db.compute(stats)
    return db
