"""Copy of movi_tpu/build/prepare_ref.py: the port keeps its own, so it imports nothing
of the JAX package.

Reference preparation: FASTA cleaning, reverse complement, separators.

Mirrors src/prepare_ref.cpp:16-131 of the reference:
  - uppercase a/c/g/t
  - any non-ACGT character becomes 'A'
  - the reverse complement of every record is appended right after it
  - with separators, a '%' is appended after every (fw and rc) sequence
  - doc_offsets records cumulative document end offsets
"""

from __future__ import annotations

import gzip
import io
import os
from dataclasses import dataclass, field
from typing import Iterator, List, Tuple

import numpy as np

from ..constants import SEPARATOR

_COMP = np.zeros(256, dtype=np.uint8)
_COMP[ord("A")] = ord("T")
_COMP[ord("T")] = ord("A")
_COMP[ord("C")] = ord("G")
_COMP[ord("G")] = ord("C")

_CLEAN = np.full(256, ord("A"), dtype=np.uint8)  # non-ACGT -> 'A'
for _c in b"ACGT":
    _CLEAN[_c] = _c
for _lo, _up in zip(b"acgt", b"ACGT"):
    _CLEAN[_lo] = _up


def _open_maybe_gz(path: str):
    with open(path, "rb") as f:
        magic = f.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(path, "rb")
    return open(path, "rb")


def iter_fasta(path: str) -> Iterator[Tuple[str, bytes]]:
    """Yield (name, sequence-bytes) records from a FASTA file."""
    name = None
    chunks: List[bytes] = []
    with _open_maybe_gz(path) as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            if line.startswith(b">"):
                if name is not None:
                    yield name, b"".join(chunks)
                # kseq takes the name up to the first whitespace
                name = line[1:].split()[0].decode() if len(line) > 1 else ""
                chunks = []
            else:
                chunks.append(line)
        if name is not None:
            yield name, b"".join(chunks)


def clean_seq(seq: bytes) -> np.ndarray:
    """Uppercase and map non-ACGT to 'A' (prepare_ref.cpp:39-49)."""
    arr = np.frombuffer(seq, dtype=np.uint8)
    return _CLEAN[arr]


def revcomp(arr: np.ndarray) -> np.ndarray:
    return _COMP[arr[::-1]]


@dataclass
class PreparedRef:
    """Cleaned, concatenated reference text (without the terminator)."""

    text: np.ndarray                 # uint8, fw+rc concatenation
    names: List[str] = field(default_factory=list)
    doc_offsets: List[int] = field(default_factory=list)  # cumulative end offsets
    separators: bool = False


def prepare_ref(
    fasta_paths,
    rc: bool = True,
    separators: bool = False,
    is_list: bool = False,
    out_fasta: str | None = None,
) -> PreparedRef:
    """Build the cleaned reference text, mirroring movi-prepare-ref.

    ``fasta_paths`` may be a single path or a list of paths.  ``is_list``
    mirrors the reference's list mode in which each *file* is one document;
    otherwise each fasta *record* is one document (prepare_ref.cpp:73-81).
    """
    if isinstance(fasta_paths, (str, os.PathLike)):
        fasta_paths = [fasta_paths]

    pieces: List[np.ndarray] = []
    names: List[str] = []
    doc_offsets: List[int] = []
    running = 0
    out = open(out_fasta, "w") if out_fasta else None
    sep_arr = np.array([SEPARATOR], dtype=np.uint8)

    for path in fasta_paths:
        file_len = 0
        for name, seq in iter_fasta(str(path)):
            fw = clean_seq(seq)
            entry_len = 0
            pieces.append(fw)
            entry_len += len(fw)
            if separators:
                pieces.append(sep_arr)
                entry_len += 1
            if rc:
                rcp = revcomp(fw)
                pieces.append(rcp)
                entry_len += len(rcp)
                if separators:
                    pieces.append(sep_arr)
                    entry_len += 1
            names.append(name)
            if out is not None:
                sep_s = "%" if separators else ""
                out.write(f">{name}\n{fw.tobytes().decode()}{sep_s}\n")
                if rc:
                    out.write(
                        f">{name}_rev_comp\n{revcomp(fw).tobytes().decode()}{sep_s}\n"
                    )
            if is_list:
                file_len += entry_len
            else:
                running += entry_len
                doc_offsets.append(running)
        if is_list:
            running += file_len
            doc_offsets.append(running)

    if out is not None:
        out.close()
        with open(str(out_fasta) + ".doc_offsets", "w") as f:
            for off in doc_offsets:
                f.write(f"{off}\n")

    text = np.concatenate(pieces) if pieces else np.zeros(0, dtype=np.uint8)
    return PreparedRef(text=text, names=names, doc_offsets=doc_offsets,
                       separators=separators)
