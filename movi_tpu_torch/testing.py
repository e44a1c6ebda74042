"""Seeded synthetic indexes and reads shared by the parity tests and
chip_smoke.py (numpy only, so both packages get identical inputs)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from movi_tpu.build.suffix import build_bwt_runs
from movi_tpu.index.structure import MoveIndex, build_move_index

ACGT = np.frombuffer(b"ACGT", np.uint8)
EDGE_LENGTHS = (1, 2, 3, 2047, 2048, 2049, 4097)


def random_text(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ACGT, size=n).astype(np.uint8)


def small_index(seed: int = 47, n: int = 5000):
    """The 5,000-base ACGT text of tests/test_fused2.py, indexed with
    regular thresholds and NT splitting (bound_ff=1)."""
    text = random_text(n, seed)
    return text, index_from_text(text)


def mixed_reads(text: np.ndarray, seed: int = 1, count: int = 60
                ) -> List[Tuple[str, bytes]]:
    """Reads of length 3-70 taken from the text, 60% of them with
    substitutions that include N."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count):
        L = int(rng.integers(3, 70))
        s = int(rng.integers(0, len(text) - L))
        seq = text[s:s + L].copy()
        if rng.random() < 0.6:
            pos = rng.integers(0, L, size=max(1, L // 8))
            seq[pos] = rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                  size=len(pos))
        reads.append((f"r{i}", seq.tobytes()))
    return reads


def length_reads(text: np.ndarray, lengths: Sequence[int] = EDGE_LENGTHS,
                 seed: int = 9) -> List[Tuple[str, bytes]]:
    """One read per length; reads longer than the text wrap around it, so
    the long ones cross the JAX engines' carried-chunk boundaries."""
    rng = np.random.default_rng(seed)
    reads = []
    for i, L in enumerate(lengths):
        s = int(rng.integers(0, len(text) - min(L, len(text) - 1)))
        seq = np.resize(np.roll(text, -s), L)
        reads.append((f"L{i}", seq.tobytes()))
    return reads


def sim_reads(text: np.ndarray, lanes: int, read_len: int, seed: int,
              err: float = 0.01) -> np.ndarray:
    """uint8 [lanes, read_len] reads with substitutions at rate err (the
    read model of bench.py)."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(0, len(text) - read_len, size=lanes)
    reads = np.stack([text[s:s + read_len] for s in starts])
    flip = rng.random(reads.shape) < err
    return np.where(flip, rng.choice(ACGT, size=reads.shape), reads)


def index_from_text(text: np.ndarray) -> MoveIndex:
    return build_move_index(build_bwt_runs(text), "regular-thresholds",
                            bound_ff=1)


def colored_index(docs: Sequence[np.ndarray], taxon_ids: Sequence[int]):
    """(ix, ct) for the concatenated documents: a regular-thresholds
    index with NT splitting and its Movi Color table."""
    from movi_tpu.color import DocumentInfo, build_color_table

    text = np.concatenate(docs)
    offs = np.cumsum([len(d) for d in docs]).astype(np.int64)
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds", bound_ff=1)
    di = DocumentInfo.create(offs, taxon_ids=list(taxon_ids))
    return ix, build_color_table(ix, runs.sa, di)


def small_color_index():
    """The three-document index of tests/test_fused_color.py (2,500
    bases each, doc 1 sharing doc 0's first 1,200) and its 40 reads of
    60-140 bases with 2% substitutions, some with N.  Returns (docs, ix,
    ct, reads)."""
    rng = np.random.default_rng(5)
    docs = [rng.choice(ACGT, size=2500) for _ in range(3)]
    docs[1][:1200] = docs[0][:1200]
    ix, ct = colored_index(docs, [101, 102, 202])
    reads = []
    for i in range(40):
        d = int(rng.integers(0, 3))
        L = int(rng.integers(60, 140))
        s = int(rng.integers(0, len(docs[d]) - L))
        seq = docs[d][s:s + L].copy()
        err = rng.random(L) < 0.02
        seq = np.where(err, rng.choice(ACGT, size=L), seq)
        if i % 7 == 0:
            seq[rng.integers(0, L, size=2)] = ord("N")
        reads.append((f"r{i}", seq.tobytes()))
    return docs, ix, ct, reads


def early_stop_reads(reads: Sequence[Tuple[str, bytes]], long_len: int = 0,
                     seed: int = 99) -> List[Tuple[str, bytes]]:
    """Reads for --early-stop: six random ones of 260-350 bases (they are
    unclassified and stop at p1 in {0, 100}) and four classified ones
    made of a source read repeated to 280 bases, as in
    tests/test_fused_color.py; with long_len, also two random reads of
    that length, which stop just past their midpoint."""
    rng = np.random.default_rng(seed)
    out = [(f"u{i}", rng.choice(ACGT, size=int(rng.integers(260, 350)))
            .tobytes()) for i in range(6)]
    out += [(f"c{i}", (s * 4)[:280]) for i, (_, s) in enumerate(reads[:4])]
    out += [(f"x{i}", rng.choice(ACGT, size=long_len).tobytes())
            for i in range(2 if long_len else 0)]
    return out


def pangenome(genomes: int, length: int, err: float = 0.02,
              seed: int = 0) -> List[np.ndarray]:
    """`genomes` copies of one random ancestor (ACGT from default_rng
    (seed)) of `length` bases, genome g with substitutions at rate err
    drawn from default_rng(100 + g)."""
    ancestor = random_text(length, seed)
    out = []
    for g in range(genomes):
        rng = np.random.default_rng(100 + g)
        flip = rng.random(length) < err
        out.append(np.where(flip, rng.choice(ACGT, size=length), ancestor)
                   .astype(np.uint8))
    return out


def genome_reads(genomes: Sequence[np.ndarray], lanes: int, read_len: int,
                 seed: int, err: float = 0.01) -> np.ndarray:
    """uint8 [lanes, read_len] reads, each from a random genome at a
    random start, with substitutions at rate err."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, len(genomes), size=lanes)
    starts = rng.integers(0, len(genomes[0]) - read_len, size=lanes)
    reads = np.stack([genomes[gi][s:s + read_len]
                      for gi, s in zip(g, starts)])
    flip = rng.random(reads.shape) < err
    return np.where(flip, rng.choice(ACGT, size=reads.shape), reads)
