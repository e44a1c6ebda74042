"""Copy of movi_tpu/io/outputs.py: the port keeps its own, so it imports nothing
of the JAX package.

Output formatting matching the reference byte-for-byte.

  - stdout PML lines: utils.cpp:212-219 + move_query.hpp:26-38
  - BPF binary files: utils.hpp:63-86, utils.cpp:202-246
  - count/.matches lines: utils.cpp:248-256
  - MEM lines: utils.cpp:306-316
"""

from __future__ import annotations

import struct
from typing import Iterable, List, Sequence

BPF_MAGIC = 0x42504600
BPF_VERSION = (1, 0, 0)


def pml_stdout_lines(name: str, pmls_processing_order: Sequence[int]) -> List[str]:
    """The two stdout lines for one read.

    `pmls_processing_order` is right-to-left (as produced by query_pml);
    the printed line is left-to-right with a trailing space, exactly like
    output_base_stats (utils.cpp:214-219).
    """
    vals = " ".join(str(v) for v in reversed(pmls_processing_order))
    return [">" + name, vals + " " if vals else ""]


class BPFWriter:
    """Base Profile Format writer (utils.hpp:63-86)."""

    def __init__(self, path: str, entry_size: int = 16,
                 write_header: bool = True):
        """write_header=False emits a headerless record stream -- the
        per-host output shards of the multi-host runner, which host 0
        concatenates under one header (parallel/multihost.py)."""
        assert entry_size in (16, 32, 64)
        self.entry_size = entry_size
        self.f = open(path, "wb")
        if write_header:
            major, minor, patch = BPF_VERSION
            self.f.write(struct.pack("<IBBBBH2x", BPF_MAGIC, major, minor,
                                     patch, entry_size, 0))

    def write_read(self, name: str, values: Sequence[int]):
        """Per-read record: u16 namelen, name, u64 count, values[]
        (utils.cpp:212-246).  Values are stored in processing order
        (right-to-left), like MoveQuery::matching_lens."""
        import numpy as np

        nb = name.encode()
        self.f.write(struct.pack("<H", len(nb)))
        self.f.write(nb)
        self.f.write(struct.pack("<Q", len(values)))
        dt = {16: "<u2", 32: "<u4", 64: "<u8"}[self.entry_size]
        if self.entry_size == 64:
            arr = np.asarray(values, dtype=np.uint64)
        else:
            clip = (1 << self.entry_size) - 1
            arr = np.minimum(np.asarray(values, dtype=np.int64), clip)
        self.f.write(arr.astype(dt).tobytes())

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bpf(path: str, entry_size_hint: int = 32):
    """Read a BPF file -> list of (name, values).

    Headerless legacy files (pre-BPFHeader) fall back to
    `entry_size_hint`: 32 by default, 16/64 via the reference's
    --small-bpf/--large-bpf view flags (movi_parser.cpp:185-186)."""
    out = []
    with open(path, "rb") as f:
        hdr = f.read(12)
        if len(hdr) == 12:
            magic, major, minor, patch, entry_size, _ = struct.unpack(
                "<IBBBBH2x", hdr)
        else:
            magic = 0
        if magic != BPF_MAGIC:
            f.seek(0)
            entry_size = entry_size_hint
        fmt = {16: "H", 32: "I", 64: "Q"}[entry_size]
        width = entry_size // 8
        while True:
            b = f.read(2)
            if not b:
                break
            (nlen,) = struct.unpack("<H", b)
            name = f.read(nlen).decode()
            (cnt,) = struct.unpack("<Q", f.read(8))
            vals = struct.unpack(f"<{cnt}{fmt}", f.read(cnt * width))
            out.append((name, list(vals)))
    return out


def count_line(name: str, query_length: int, pos_on_r: int,
               match_count: int) -> str:
    """utils.cpp:248-256."""
    return f"{name}\t{query_length - pos_on_r}/{query_length}\t{match_count}"


def mem_lines(name: str, mems: Iterable[tuple]) -> List[str]:
    return [f"{name}\t{s}\t{e}\t{c}" for (s, e, c) in mems]
