"""Copy of movi_tpu/logs.py: the port keeps its own, so it imports nothing
of the JAX package.

Query tracing / profiling subsystem.

Mirrors the reference's --logs machinery: per-base fast-forward and scan
counts collected into per-read vectors and written as .costs/.scans/
.fastforwards files (utils.cpp:268-289; move_structure_query.cpp:268-271,
363-371), plus aggregate histograms (ff_counts, run_lengths, repositions;
move_structure.hpp:385-389).

The .costs file holds host-clock nanoseconds per 200 bases of the scalar
engine, so it differs from run to run.
"""

from __future__ import annotations

import time
from collections import Counter
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

import numpy as np

from .cpu_ref.scalar import ScalarEngine


@dataclass
class QueryLogs:
    scans: List[int] = field(default_factory=list)
    fastforwards: List[int] = field(default_factory=list)
    costs_ns: List[int] = field(default_factory=list)


@dataclass
class EngineStats:
    ff_counts: Counter = field(default_factory=Counter)
    repositions: Counter = field(default_factory=Counter)

    def run_length_histogram(self, index) -> Dict[int, int]:
        vals, cnts = np.unique(index.n_arr, return_counts=True)
        return dict(zip(vals.tolist(), cnts.tolist()))


class LoggingScalarEngine(ScalarEngine):
    """ScalarEngine variant that records per-base ff/scan counts."""

    def __init__(self, index):
        super().__init__(index)
        self.stats = EngineStats()

    def query_pml_logged(self, read: bytes) -> Tuple[List[int], QueryLogs]:
        ix = self.ix
        logs = QueryLogs()
        r_arr = np.frombuffer(read, dtype=np.uint8)
        idx = ix.r - 1
        offset = int(ix.n_arr[idx]) - 1
        match_len = 0
        out: List[int] = []
        it = 0
        t0 = time.perf_counter_ns()
        for pos in range(len(r_arr) - 1, -1, -1):
            it += 1
            if (it - 1) % 200 == 0:
                t0 = time.perf_counter_ns()
            c = int(r_arr[pos])
            scan_count = 0
            if not self.check_alphabet(c):
                match_len = 0
            else:
                read_alpha = int(ix.alphamap[c])
                row_char = int(ix.alphabet[ix.c_arr[idx]])
                if row_char == c:
                    match_len += 1
                else:
                    old = idx
                    idx, up = self.reposition_thresholds(idx, offset,
                                                         read_alpha)
                    scan_count = abs(idx - old)
                    self.stats.repositions[scan_count] += 1
                    match_len = 0
                    offset = int(ix.n_arr[idx]) - 1 if up else 0
            out.append(match_len)
            offset, idx, ff = self.lf_move(offset, idx)
            self.stats.ff_counts[ff] += 1
            logs.fastforwards.append(ff)
            logs.scans.append(scan_count)
            if it % 200 == 0:
                logs.costs_ns.append(time.perf_counter_ns() - t0)
        return out, logs


def write_log_files(prefix: str, entries: List[Tuple[str, QueryLogs]]):
    """Writes .costs/.scans/.fastforwards in the reference's format."""
    with open(prefix + ".costs", "w") as fc, \
         open(prefix + ".scans", "w") as fs, \
         open(prefix + ".fastforwards", "w") as ff:
        for name, logs in entries:
            for f in (fc, fs, ff):
                f.write(f">{name}\n")
            fc.write(" ".join(str(v) for v in logs.costs_ns) + " \n"
                     if logs.costs_ns else "\n")
            fs.write(" ".join(str(v) for v in logs.scans) + " \n"
                     if logs.scans else "\n")
            ff.write(" ".join(str(v) for v in logs.fastforwards) + " \n"
                     if logs.fastforwards else "\n")
