"""The port's k-mer engines (FusedKmerEngine, FusedKmerCountEngine,
Fused2KmerCountEngine) against the JAX package's and the port's own copy
of the oracle, AdvancedEngine (query_all_kmers,
count_kmers_bidirectional), on the CPU: random (probe-heavy), half-
matching and exact reads with N's, reads shorter than k and reads past
512 bases, at k = 5 ... 31.  Every comparison is exact."""

import numpy as np
import pytest

from movi_tpu.build.prepare_ref import revcomp
from movi_tpu.engine import fused_kmer as jk
from movi_tpu.engine import fused_search as js
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.api import Index
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_kmer as tk
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (ACGT, index_from_text, kmer_reads,
                                    random_text)

KS = [5, 9, 11, 15, 21, 31]


@pytest.fixture(scope="module")
def setup():
    """The rc index of tests/test_fused_kmer.py (2,500 random bases and
    their reverse complement, seed 9) and its reads."""
    fw = np.random.default_rng(9).choice(ACGT, size=2500).astype(np.uint8)
    text = np.concatenate([fw, revcomp(fw)])
    ix = index_from_text(text)
    reads = kmer_reads(text, seed=11)
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    assert batch.width > 512
    return dict(ix=ix, reads=reads, batch=batch,
                oracle=AdvancedEngine(ix, ftab_k=0),
                s2=(js2.build_fused_search2_index(ix),
                    ts2.build_fused_search2_index(ix, "cpu")))


@pytest.mark.parametrize("k", KS)
def test_membership_equals_jax_and_oracle(setup, k):
    """Without ftab anchors and with the API's fk = min(10, k - k/3)."""
    ix, batch = setup["ix"], setup["batch"]
    want = [setup["oracle"].query_all_kmers(s, k) for _, s in setup["reads"]]
    assert any(want) and not all(want)
    for fk in (0, min(10, k - k // 3)):
        got = tk.FusedKmerEngine(ts.build_fused_search_index(ix, fk), k,
                                 "cpu").query_batch(batch)
        jax_got = jk.FusedKmerEngine(js.build_fused_search_index(ix, fk),
                                     k).query_batch(batch)
        assert got == jax_got == want, fk


@pytest.mark.parametrize("k", KS)
def test_counts_equal_jax_and_oracle(setup, k):
    """The one-step and the paired exact counts."""
    ix, batch = setup["ix"], setup["batch"]
    want = [setup["oracle"].count_kmers_bidirectional(s, k)
            for _, s in setup["reads"]]
    assert any(f for f, _ in want)
    j2, t2 = setup["s2"]
    got = tk.FusedKmerCountEngine(ts.build_fused_search_index(ix), k,
                                  "cpu").query_batch(batch)
    got2 = ts2.Fused2KmerCountEngine(t2, k, "cpu").query_batch(batch)
    assert got == got2 == want
    assert (jk.FusedKmerCountEngine(js.build_fused_search_index(ix), k)
            .query_batch(batch) == want)
    assert js2.Fused2KmerCountEngine(j2, k).query_batch(batch) == want


def test_forward_only_ftab_membership():
    """The forward-only index of tests/test_fused_kmer.py (seed 31) with
    ftab-6 anchors: the anchors keep fw-only validity, so stretches are
    found, equal to the oracle."""
    rng = np.random.default_rng(31)
    fw = rng.choice(ACGT, size=2500)
    ix = index_from_text(fw)
    reads = []
    for i in range(12):
        s0 = int(rng.integers(0, len(fw) - 60))
        reads.append((f"r{i}", fw[s0:s0 + 60].tobytes()))
    batch = next(make_batches(reads, lanes=len(reads)))
    got = tk.FusedKmerEngine(ts.build_fused_search_index(ix, 6), 11,
                             "cpu").query_batch(batch)
    assert all(got)
    oracle = AdvancedEngine(ix)
    assert got == [oracle.query_all_kmers(s, 11) for _, s in reads]


def test_membership_ticks_past_the_cap_raise(setup, monkeypatch):
    """A lane still running after the tick cap is an error, not a partial
    answer."""
    monkeypatch.setattr(tk, "tick_cap", lambda k, W: 5)
    eng = tk.FusedKmerEngine(ts.build_fused_search_index(setup["ix"]), 15,
                             "cpu")
    with pytest.raises(RuntimeError, match="did not finish"):
        eng.query_batch(setup["batch"])


def test_kmer_spans_order():
    out = np.array([[0, 3, 0, 1], [0, 0, 0, 0], [2, 0, 0, 0]], np.int32)
    assert tk.kmer_spans(out) == [[(3, 1), (1, 3)], [], [(0, 2)]]


@pytest.mark.parametrize("counts", [False, True])
def test_unbounded_index_not_ported(counts):
    """An index without NT splitting (bound_ff) takes the scalar
    AdvancedEngine route in both packages, with equal answers; the device
    engine getter refuses it."""
    from movi_tpu.api import Index as JIndex

    ix = build_move_index(build_bwt_runs(random_text(600, 2)), "regular")
    reads = [("r", b"ACGTACGTAC"), ("s", b"TTGCANACGGT")]
    want = JIndex(ix).query_kmers(reads, k=5, counts=counts)
    assert Index(ix).query_kmers(reads, k=5, counts=counts,
                                 device="cpu") == want
    with pytest.raises(ValueError, match="scalar AdvancedEngine"):
        Index(ix).kmer_engine(5, counts, device="cpu")
