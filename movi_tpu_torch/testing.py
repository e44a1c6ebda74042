"""Seeded synthetic indexes and reads shared by the parity tests and
chip_smoke.py (numpy only, so both packages get identical inputs)."""

from __future__ import annotations

import contextlib
import io
import os
from typing import List, Sequence, Tuple

import numpy as np

from .build.suffix import build_bwt_runs
from .index.structure import MoveIndex, build_move_index

ACGT = np.frombuffer(b"ACGT", np.uint8)
EDGE_LENGTHS = (1, 2, 3, 2047, 2048, 2049, 4097)


def random_text(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).choice(ACGT, size=n).astype(np.uint8)


def small_index(seed: int = 47, n: int = 5000):
    """The 5,000-base ACGT text of tests/test_fused2.py, indexed with
    regular thresholds and NT splitting (bound_ff=1)."""
    text = random_text(n, seed)
    return text, index_from_text(text)


def small_sa_index(rate: int):
    """The 5,000-base ACGT text of tests/test_fused_sa.py
    (default_rng(17)), indexed with regular thresholds and NT splitting,
    with its sampled SA at `rate`; and that test's 25 reads of 30-100
    bases with 3% substitutions, every sixth with two N's.  Returns
    (text, ix, reads)."""
    rng = np.random.default_rng(17)
    text = rng.choice(ACGT, size=5000)
    ix = index_from_text(text, sa_rate=rate)
    reads = []
    for i in range(25):
        L = int(rng.integers(30, 100))
        s = int(rng.integers(0, len(text) - L))
        seq = text[s:s + L].copy()
        seq = np.where(rng.random(L) < 0.03, rng.choice(ACGT, size=L), seq)
        if i % 6 == 0:
            seq[rng.integers(0, L, size=2)] = ord("N")
        reads.append((f"r{i}", seq.tobytes()))
    return text, ix, reads


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


def screening_reads(text: np.ndarray, lanes: int, read_len: int,
                    seed: int) -> np.ndarray:
    """uint8 [lanes, read_len]: half reads from the text with 1%
    substitutions, half random, shuffled (bench.py make_mixed_reads, the
    contamination-screening mix of the k-mer engines)."""
    rng = np.random.default_rng(seed)
    found = sim_reads(text, lanes // 2, read_len, seed=seed + 1)
    rand = rng.choice(ACGT, size=(lanes - lanes // 2, read_len))
    return np.concatenate([found, rand])[rng.permutation(lanes)]


def kmer_reads(text: np.ndarray, seed: int = 3, count: int = 45,
               long_reads: int = 4) -> List[Tuple[str, bytes]]:
    """Reads for the k-mer engines, the mix of tests/test_fused_kmer.py:
    random (probe-heavy), half from the text then random, and from the
    text with 3% substitutions, every fifth with an N; reads of 1 and 3
    bases and one of 15 N's; and `long_reads` of 530-700 bases (random or
    from the text)."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(count + long_reads):
        L = int(rng.integers(12, 90) if i < count
                else rng.integers(530, 700))
        if i % 3 == 0:
            seq = rng.choice(ACGT, size=L)
        else:
            s = int(rng.integers(0, len(text) - L))
            seq = text[s:s + L].copy()
            if i % 3 == 1:
                seq[L // 2:] = rng.choice(ACGT, size=L - L // 2)
            else:
                seq = np.where(rng.random(L) < 0.03,
                               rng.choice(ACGT, size=L), seq)
        if i % 5 == 0:
            seq[int(rng.integers(0, L))] = ord("N")
        reads.append((f"k{i}", np.asarray(seq, np.uint8).tobytes()))
    return reads + [("tiny", b"ACG"), ("one", b"T"), ("allN", b"N" * 15)]


def mem_reads(rng: np.random.Generator, text: np.ndarray, n: int,
              err: float = 0.05, with_n: bool = False, prefix: str = "r",
              lengths: Tuple[int, int] = (25, 90)
              ) -> List[Tuple[str, bytes]]:
    """Reads for the MEM engines, the recipe of tests/test_fused_mem2.py:
    `n` stretches of the text with substitutions at rate err, lengths
    drawn from [lengths[0], lengths[1]), with two N's each if with_n."""
    reads = []
    for i in range(n):
        L = int(rng.integers(*lengths))
        s = int(rng.integers(0, len(text) - L))
        seq = text[s:s + L].copy()
        e = rng.random(L) < err
        seq = np.where(e, rng.choice(ACGT, size=L), seq)
        if with_n:
            seq[rng.integers(0, L, size=2)] = ord("N")
        reads.append((f"{prefix}{i}", seq.astype(np.uint8).tobytes()))
    return reads


def with_revcomp(fw: np.ndarray) -> np.ndarray:
    """The text followed by its reverse complement."""
    from .build.prepare_ref import revcomp

    return np.concatenate([fw, revcomp(fw)])


def rc_index(n: int, seed: int):
    """n random ACGT bases (default_rng(seed)) and their reverse
    complement, indexed: a reverse-complement closed index.  Returns
    (fw, ix)."""
    fw = random_text(n, seed)
    return fw, index_from_text(with_revcomp(fw))


def junction_index(docs: int = 3, doc_len: int = 800, seed: int = 82):
    """A multi-document reference without separators, each document
    followed by its reverse complement (the index of
    tests/test_fused_mem2.py's multi-document case): (text, the start of
    every document and complement after the first, ix)."""
    from .build.prepare_ref import revcomp

    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(docs):
        d = rng.choice(ACGT, size=doc_len).astype(np.uint8)
        parts += [d, revcomp(d)]
    text = np.concatenate(parts)
    junctions = np.cumsum([len(p) for p in parts])[:-1]
    return text, junctions, index_from_text(text)


def junction_reads(text: np.ndarray, junctions: Sequence[int], n: int,
                   seed: int = 5) -> List[Tuple[str, bytes]]:
    """`n` exact reads of 30-80 bases from the text, each spanning one of
    the junctions with at least 8 bases on either side."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        L = int(rng.integers(30, 80))
        j = int(junctions[int(rng.integers(0, len(junctions)))])
        s = int(rng.integers(j - L + 8, j - 8))
        reads.append((f"j{i}", text[s:s + L].tobytes()))
    return reads


def separator_text():
    """The text of tests/test_separators.py: three 800-base documents
    (default_rng(91)), each followed by '%', its reverse complement and
    '%'.  Returns (text, the first document)."""
    from .build.prepare_ref import revcomp
    from .constants import SEPARATOR

    rng = np.random.default_rng(91)
    docs = [rng.choice(ACGT, size=800).astype(np.uint8) for _ in range(3)]
    sep = np.array([SEPARATOR], dtype=np.uint8)
    return np.concatenate([p for d in docs
                           for p in (d, sep, revcomp(d), sep)]), docs[0]


def run_cli(main, argv) -> Tuple[int, str, str]:
    """(exit code, stdout, stderr) of a CLI's main(argv), run in this
    process."""
    out, err = io.StringIO(), io.StringIO()
    rc = 0
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            main([str(a) for a in argv])
    except SystemExit as e:
        rc = e.code if isinstance(e.code, int) else 1
    return rc, out.getvalue(), err.getvalue()


def write_fasta(path: str, records: Sequence[Tuple[str, bytes]]):
    with open(path, "w") as f:
        f.writelines(f">{n}\n{s.decode()}\n" for n, s in records)


def cli_inputs(d: str):
    """A two-document FASTA (1,300 + 1,100 random bases, seeds 21 and 22;
    `build` adds reverse complements) and 33 reads from it: 30 of 3-70
    bases (mixed_reads, with N's) and three of 300 bases with three N's.
    Returns (fasta path, reads path, reads)."""
    refs = [random_text(1300, 21), random_text(1100, 22)]
    fasta = os.path.join(d, "ref.fa")
    write_fasta(fasta, [(f"doc{i}", t.tobytes()) for i, t in enumerate(refs)])
    reads = mixed_reads(refs[0], seed=5, count=20) + \
        mixed_reads(refs[1], seed=6, count=10)
    for i in range(3):
        seq = refs[i % 2][100 * i:100 * i + 300].copy()
        seq[[7, 150, 299]] = ord("N")
        reads.append((f"long{i}", seq.tobytes()))
    rpath = os.path.join(d, "reads.fa")
    write_fasta(rpath, reads)
    return fasta, rpath, reads


def unsplit_index(fasta: str, mode: str = "regular-thresholds"):
    """The index of `mode` of a FASTA (reverse complements added) without
    NT splitting (bound_ff None), which no `build` flag makes.  Returns
    (ix, runs, ref)."""
    from .build.prepare_ref import prepare_ref

    ref = prepare_ref([fasta])
    runs = build_bwt_runs(ref.text)
    return build_move_index(runs, mode), runs, ref


def index_from_text(text: np.ndarray, sa_rate: int = 0) -> MoveIndex:
    """Regular thresholds with NT splitting; with sa_rate, also the
    sampled SA at that rate (build --sa-entries)."""
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds", bound_ff=1)
    if sa_rate:
        ix.sampled_SA = runs.sampled_sa(sa_rate)
        ix.sa_sample_rate = sa_rate
    return ix


def colored_index(docs: Sequence[np.ndarray], taxon_ids: Sequence[int]):
    """(ix, ct) for the concatenated documents: a regular-thresholds
    index with NT splitting and its Movi Color table."""
    from .color import DocumentInfo, build_color_table

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
