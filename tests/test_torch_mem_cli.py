"""The port's MEM and bidirectional k-mer count entry points against the
JAX package's on the CPU: Index.query_mems and query_kmers(counts=True)
on a reverse-complement closed index equal the JAX API; `query --mem`
(BML and all-MEMs) and `--kmer-count --paired-records` equal the JAX CLI
byte for byte, the .mems / .kmers files and --stdout, on a one-document
reference (where the JAX engines are right: no document junctions, no
'#' in the reads); the routes past the device engines agree too."""

import os
import subprocess
import sys

import numpy as np
import pytest

from movi_tpu import api as japi
from movi_tpu_torch import api as tapi
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.testing import (mixed_reads, random_text, rc_index,
                                    with_revcomp)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def rc():
    """3,000 random bases and their reverse complement (seed 19), and
    reads from it: short ones with N's and three of 200-300 bases."""
    fw, ix = rc_index(3000, 19)
    text = with_revcomp(fw)
    reads = mixed_reads(text, seed=8, count=24)
    rng = np.random.default_rng(9)
    for i in range(3):
        L = int(rng.integers(200, 300))
        s = int(rng.integers(0, len(text) - L))
        seq = text[s:s + L].copy()
        seq[rng.integers(0, L, size=4)] = rng.choice(
            np.frombuffer(b"ACGTN", np.uint8), size=4)
        reads.append((f"long{i}", seq.tobytes()))
    return ix, reads


@pytest.mark.parametrize("L", [0, 12, 20])
def test_api_query_mems_equals_jax(rc, L):
    ix, reads = rc
    want = japi.Index(ix).query_mems(reads, min_mem_length=L, lanes=16)
    got = tapi.Index(ix).query_mems(reads, min_mem_length=L, lanes=16,
                                    device="cpu")
    assert got == want
    assert sum(len(m) for _, m in got) > 0


@pytest.mark.parametrize("k,paired", [(31, None), (11, True)])
def test_api_bidirectional_counts_equal_jax(rc, k, paired):
    from movi_tpu_torch.engine.fused_kmer2 import FusedKmer2CountEngine

    ix, reads = rc
    index = tapi.Index(ix)
    assert isinstance(index.kmer_engine(k, True, paired, "cpu"),
                      FusedKmer2CountEngine)
    want = japi.Index(ix).query_kmers(reads, k=k, counts=True, lanes=16,
                                      paired=paired)
    assert index.query_kmers(reads, k=k, counts=True, lanes=16,
                             paired=paired, device="cpu") == want
    assert any(f for _, (f, _) in want)


def test_api_unported_mem_routes_raise(rc, monkeypatch):
    """ftab_k > 1 and a non-ACGT index take the scalar AdvancedEngine in
    both APIs, with equal MEMs; n past MEM2_MAX_N, which raised before
    the v1 machines were ported (item 15), now takes them in both APIs,
    with equal MEMs (tests/test_torch_mem1_cli.py has that route's
    cases)."""
    ix, reads = rc
    index = tapi.Index(ix)
    assert (index.query_mems(reads, min_mem_length=12, ftab_k=6,
                             device="cpu")
            == japi.Index(ix).query_mems(reads, min_mem_length=12,
                                         ftab_k=6))
    # the scalar MEMs extend both ways: a reverse-complement closed text
    text = with_revcomp(random_text(2000, 3))
    text[::97] = ord("N")
    text[-1 - np.arange(0, len(text), 97)] = ord("N")
    ixn = build_move_index(build_bwt_runs(text), "regular", bound_ff=1)
    assert bytes(ixn.alphabet) != b"ACGT"
    some = reads[:8]
    for L in (0, 12):
        assert (tapi.Index(ixn).query_mems(some, L, device="cpu")
                == japi.Index(ixn).query_mems(some, L))
    monkeypatch.setattr(tm2, "MEM2_MAX_N", int(ix.all_p[-1]) - 1)
    monkeypatch.setattr(jm2, "MEM2_MAX_N", int(ix.all_p[-1]) - 1)
    got = tapi.Index(ix).query_mems(reads, min_mem_length=12, device="cpu")
    assert got == japi.Index(ix).query_mems(reads, min_mem_length=12)


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def built(tmp_path_factory, rc):
    """`movi_tpu_torch.cli build` (reverse complements added) of one
    document, and the rc fixture's reads as a FASTA."""
    d = tmp_path_factory.mktemp("torch_mem_cli")
    fasta = d / "ref.fa"
    fasta.write_text(f">doc\n{random_text(3000, 19).tobytes().decode()}\n")
    idx = str(d / "idx")
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", str(fasta),
                                    "--index", idx, "--skip-null"])
    assert r.returncode == 0, r.stderr
    rpath = d / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in rc[1]))
    return idx, str(rpath)


@pytest.mark.parametrize("flags,suffix", [
    (["--mem", "--min-mem-length", "12"], "mems"),
    (["--mem"], "mems"),
    (["--mem", "--min-mem-length", "12", "--ftab-k", "6", "--stdout"], None),
    (["--kmer-count", "--k", "15", "--paired-records"], "kmers.15"),
    (["--kmer-count", "--k", "21", "--stdout"], None)])
def test_cli_equals_jax_byte_for_byte(built, flags, suffix):
    """The .mems (or .kmers) file, or stdout, of both CLIs; the JAX CLI
    takes its bidirectional engine on this reverse-complement closed
    index wherever the port does."""
    idx, reads = built
    out = f"{reads}.regular-thresholds.{suffix}"
    texts = []
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        if suffix and os.path.exists(out):
            os.unlink(out)
        r = _cli(module, ["query", "--index", idx, "--read", reads, *flags,
                          "--platform", "cpu"])
        assert r.returncode == 0, r.stderr
        if suffix:
            with open(out) as f:
                texts.append(f.read())
        else:
            texts.append(r.stdout)
    assert texts[0] == texts[1]
    lines = texts[0].splitlines()
    if "--mem" in flags:
        assert lines and all(len(ln.split("\t")) == 4 for ln in lines)
    else:
        assert len(lines) == 27
