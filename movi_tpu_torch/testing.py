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
