"""Bidirectional exact k-mer counts (movi_tpu_torch/engine/fused_kmer2.py)
against the JAX package on the CPU: the plain phase R and phase L
functions against _kmer2_right_scan and _kmer2_left_flat on the same
inputs, the dispatchers' (lane, anchor) forms against the plain ones, and
the engine against AdvancedEngine.count_kmers_bidirectional, the JAX
engine and the port's Fused2KmerCountEngine on the cases of
tests/test_fused_kmer2.py; and the routing past MEM2_MAX_N (ROADMAP
§3.2).  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_kmer2 as jk2
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch import api as tapi
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_kmer2 as tk2
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
from movi_tpu_torch.testing import ACGT, rc_index


@pytest.fixture(scope="module")
def setup():
    """The index of tests/test_fused_kmer2.py (3,000 random bases and
    their reverse complement, seed 21), both packages' tables on it."""
    fw, ix = rc_index(3000, 21)
    return dict(fw=fw, ix=ix, oracle=AdvancedEngine(ix),
                m2=tm2.build_fused_mem2_index(ix),
                s2=ts2.build_fused_search2_index(ix, "cpu"),
                jm2=jm2.build_fused_mem2_index(ix),
                js2=js2.build_fused_search2_index(ix))


def _reads(fw, n, k, seed, with_n=False):
    """tests/test_fused_kmer2.py's reads: every third random, the others
    from the text with 4% substitutions, every fourth with two N's."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(n):
        L = int(rng.integers(k + 1, 100))
        if i % 3 == 0:
            seq = rng.choice(ACGT, size=L)
        else:
            s = int(rng.integers(0, len(fw) - L))
            seq = fw[s:s + L].copy()
            seq = np.where(rng.random(L) < 0.04, rng.choice(ACGT, size=L),
                           seq)
        if with_n and i % 4 == 0:
            seq[rng.integers(0, L, size=2)] = ord("N")
        reads.append((f"r{i}", np.asarray(seq, np.uint8).tobytes()))
    return reads


def _batch(reads):
    return next(make_batches(reads, lanes=len(reads), bucket_widths=False))


def _groups(setup, batch, k, p):
    """(slots int8, own, anchor int32) tensors of the batch's groups."""
    own, anchor = tk2.kmer2_groups(batch.lengths, k, p)
    al = left_aligned_slots(batch, setup["m2"].alphamap_query, fill=-1)
    return tuple(torch.from_numpy(x.astype(d)) for x, d in
                 ((al, np.int8), (own, np.int32), (anchor, np.int32)))


@pytest.mark.parametrize("k,p", [(5, 2), (11, 5), (21, 10), (11, 1)])
def test_phases_equal_jax(setup, k, p):
    """Phase R over the [k, G] chain chars equals _kmer2_right_scan; phase
    L over the JAX engine's flat lanes (the alive partials of every depth,
    compacted) equals _kmer2_left_flat; the dispatchers' (lane, anchor)
    forms equal both."""
    reads = _reads(setup["fw"], 20, k, seed=k, with_n=True)
    batch = _batch(reads)
    slots, own, anchor = _groups(setup, batch, k, p)
    rchars = tk2.kmer_windows(slots, own, anchor, k)
    want = jk2._kmer2_right_scan(setup["jm2"], jnp.asarray(rchars.numpy()),
                                 k)
    got = tk2.kmer2_right_scan_plain(setup["m2"], rchars, k)
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(tk2.kmer2_right_scan(setup["m2"], slots, own, anchor, k),
                    got):
        assert torch.equal(g, w)
    alive, fs, fe = got

    # the JAX engine's flat lanes: depth d's alive partials, d < p_eff
    G = own.shape[0]
    d = np.arange(p)[:, None]
    mask = (alive.numpy()[k - 2 - d[:, 0]]
            & (d <= anchor.numpy()[None, :]))
    dd, gg = np.nonzero(mask)
    assert 0 < len(dd) < p * G
    flat = ((k - 2 - dd) * G + gg).astype(np.int32)
    lane_own = own.numpy()[gg]
    lane_anchor = anchor.numpy()[gg]
    args = (slots.to(torch.int32), torch.from_numpy(lane_own),
            torch.from_numpy(lane_anchor),
            torch.from_numpy(dd.astype(np.int32)), torch.from_numpy(flat))
    S = tk2.left_steps(p)
    want = jk2._kmer2_left_flat(setup["jm2"], setup["js2"],
                                jnp.asarray(fs.numpy()),
                                jnp.asarray(fe.numpy()),
                                *[jnp.asarray(a.numpy()) for a in args], S)
    got = tk2.kmer2_left_flat_plain(setup["m2"], setup["s2"], fs, fe, *args,
                                    S)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[0].sum()) <= len(dd)
    found, cnt = tk2.kmer2_left_scan(setup["m2"], setup["s2"], alive, fs, fe,
                                     slots, own, anchor, k, p)
    assert found.shape == cnt.shape == (p, G)
    assert torch.equal(found[dd, gg], got[0])
    assert torch.equal(cnt[dd, gg], got[1])
    assert not bool(found[~torch.from_numpy(mask)].any())
    assert not bool(cnt[~torch.from_numpy(mask)].any())


@pytest.mark.parametrize("k", [5, 11, 21])
def test_engine_equals_oracle_and_jax(setup, k):
    reads = _reads(setup["fw"], 30, k, seed=100 + k, with_n=True)
    batch = _batch(reads)
    got = tk2.FusedKmer2CountEngine(setup["m2"], setup["s2"], k,
                                    device="cpu").query_batch(batch)
    want = [setup["oracle"].count_kmers_bidirectional(s, k)
            for _, s in reads]
    assert got == want
    assert got == jk2.FusedKmer2CountEngine(
        setup["jm2"], setup["js2"], k).query_batch(batch)


@pytest.mark.parametrize("p", [1, 2, 4, 9])
def test_engine_block_size_invariant(setup, p):
    """Any block size p gives the per-window counts."""
    k = 11
    reads = _reads(setup["fw"], 15, k, seed=200 + p)
    got = tk2.FusedKmer2CountEngine(setup["m2"], setup["s2"], k, p=p,
                                    device="cpu").query_batch(_batch(reads))
    assert got == [setup["oracle"].count_kmers_bidirectional(s, k)
                   for _, s in reads]


def test_engine_edge_cases(setup):
    fw, k = setup["fw"], 9
    reads = [("tiny", b"ACG"), ("exactk", fw[50:59].tobytes()),
             ("allN", b"N" * 20), ("one", b"A"),
             ("kminus1", fw[10:18].tobytes()),
             ("nmid", fw[100:140].tobytes()[:20] + b"N"
              + fw[160:180].tobytes())]
    eng = tk2.FusedKmer2CountEngine(setup["m2"], setup["s2"], k,
                                    device="cpu")
    assert eng.query_batch(_batch(reads)) == [
        setup["oracle"].count_kmers_bidirectional(s, k) for _, s in reads]
    assert eng.query_batch(_batch(reads[:1] + reads[3:4])) == [(0, 0)] * 2


def test_engine_equals_paired_engine(setup):
    k = 15
    batch = _batch(_reads(setup["fw"], 25, k, seed=7, with_n=True))
    assert (tk2.FusedKmer2CountEngine(setup["m2"], setup["s2"], k,
                                      device="cpu").query_batch(batch)
            == ts2.Fused2KmerCountEngine(setup["s2"], k,
                                         "cpu").query_batch(batch))


def test_routing_checks_mem2_cap(setup, monkeypatch):
    """On a reverse-complement closed index the paired counts route takes
    the bidirectional engine; past MEM2_MAX_N (monkeypatched low) it takes
    the paired engine, with the same answers (ROADMAP §3.2: the JAX
    package would build the oversized table)."""
    ix = setup["ix"]
    reads = _reads(setup["fw"], 12, 15, seed=3)
    index = tapi.Index(ix)
    eng = index.kmer_engine(15, counts=True, paired=True, device="cpu")
    assert isinstance(eng, tk2.FusedKmer2CountEngine)
    want = index.query_kmers(reads, k=15, counts=True, paired=True,
                             device="cpu")
    monkeypatch.setattr(tm2, "MEM2_MAX_N", int(ix.all_p[-1]) - 1)
    assert not tm2.mem2_supported(ix)
    index = tapi.Index(ix)
    eng = index.kmer_engine(15, counts=True, paired=True, device="cpu")
    assert isinstance(eng, ts2.Fused2KmerCountEngine)
    assert index._mem2 is None
    assert index.query_kmers(reads, k=15, counts=True, paired=True,
                             device="cpu") == want
    assert want == [(n, setup["oracle"].count_kmers_bidirectional(s, 15))
                    for n, s in reads]


def test_mem2_table_shared_by_mems_and_counts(setup):
    """The k-mer route reuses the MEM table the Index already holds,
    whatever its anchor width."""
    index = tapi.Index(setup["ix"])
    index.mem_engine(12, "cpu")
    m2 = index._mem2
    assert m2.ftab_k == 10
    eng = index.kmer_engine(11, counts=True, paired=True, device="cpu")
    assert eng.m2.rec_all is m2.rec_all


def test_rc_closure_checked_once_per_index(setup, monkeypatch):
    """The counts route tests reverse-complement closure once per Index,
    not on every query."""
    calls = []
    real = tapi.looks_rc_closed
    monkeypatch.setattr(tapi, "looks_rc_closed",
                        lambda ix: calls.append(1) or real(ix))
    index = tapi.Index(setup["ix"])
    reads = _reads(setup["fw"], 4, 11, seed=9)
    for _ in range(3):
        index.query_kmers(reads, k=11, counts=True, paired=True,
                          device="cpu")
    assert len(calls) == 1
