"""One-step count/ZML port (movi_tpu_torch/engine/fused_search.py) against
the JAX engines and the scalar oracle, on the CPU.  Every comparison is
exact."""

import numpy as np
import pytest
import torch

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import fused_search as js
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import fused_search_index_from_jax
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import select
from movi_tpu_torch.testing import length_reads, mixed_reads, small_index


@pytest.fixture(scope="module")
def setup():
    text, ix = small_index()
    return dict(text=text, ix=ix, sc=ScalarEngine(ix),
                jsi=js.build_fused_search_index(ix),
                tsi=ts.build_fused_search_index(ix))


def test_search_records_byte_identical(setup):
    jsi, tsi = setup["jsi"], setup["tsi"]
    for f in ("rec_all", "init_rec", "all_p"):
        got = getattr(tsi, f)
        assert got.dtype == torch.int32, f
        assert np.array_equal(np.asarray(getattr(jsi, f)), got.numpy()), f
    assert tsi.init_rec.shape == (tsi.sigma + 1, 4)
    assert (tsi.r, tsi.sigma) == (jsi.r, jsi.sigma)
    assert np.array_equal(jsi.alphamap_query, tsi.alphamap_query)
    # the search alphamap sends illegal bytes to -1, not to sigma
    assert tsi.alphamap_query[ord("N")] == -1


def test_ftab_rows_not_yet_ported(setup):
    """The ftab anchor rows, once left for the k-mer slice, are now built:
    4^fk rows appended after the search records, byte-identical to the
    JAX builder's, and the count scans ignore them."""
    ix = setup["ix"]
    jsi = js.build_fused_search_index(ix, ftab_k=4)
    tsi = ts.build_fused_search_index(ix, ftab_k=4)
    assert tsi.ftab_k == 4
    assert tsi.rec_all.shape == (2 * ix.sigma * ix.r + 4 ** 4, 4)
    assert np.array_equal(np.asarray(jsi.rec_all), tsi.rec_all.numpy())
    reads = mixed_reads(setup["text"], seed=9, count=20)
    batch = next(make_batches(reads, lanes=len(reads)))
    assert (ts.FusedCountEngine(tsi, "cpu").query_batch(batch)
            == ts.FusedCountEngine(setup["tsi"], "cpu").query_batch(batch))


def test_convert_gives_equal_engines(setup):
    """fused_search_index_from_jax: the JAX records drive the port's
    engines to the JAX engines' answers."""
    conv = fused_search_index_from_jax(setup["jsi"])
    for f in ("rec_all", "init_rec", "all_p"):
        assert torch.equal(getattr(conv, f), getattr(setup["tsi"], f)), f
    reads = mixed_reads(setup["text"], seed=8, count=30)
    batch = next(make_batches(reads, lanes=len(reads)))
    assert (ts.FusedCountEngine(conv, "cpu").query_batch(batch)
            == js.FusedCountEngine(setup["jsi"]).query_batch(batch))
    assert (ts.FusedZMLEngine(conv, "cpu").query_batch(batch)
            == js.FusedZMLEngine(setup["jsi"]).query_batch(batch))


def _check(setup, reads):
    batch = next(make_batches(reads, lanes=len(reads)))
    jsi, tsi, sc = setup["jsi"], setup["tsi"], setup["sc"]
    want_c = js.FusedCountEngine(jsi).query_batch(batch)
    want_z = js.FusedZMLEngine(jsi).query_batch(batch)
    got_c = ts.FusedCountEngine(tsi, "cpu").query_batch(batch)
    got_z = ts.FusedZMLEngine(tsi, "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got_c[i] == want_c[i] == sc.query_count(seq), name
        assert got_z[i] == want_z[i] == sc.query_zml(seq), name


def test_count_zml_mixed_reads(setup):
    _check(setup, mixed_reads(setup["text"]))


def test_count_zml_edge_lengths(setup):
    """Lengths 1-4097: the port scans the whole width at once, the JAX
    engines across their 2048-base carried chunks."""
    _check(setup, length_reads(setup["text"]))


def _chars(setup, mark_beyond, seed=5):
    tsi = setup["tsi"]
    batch = next(make_batches(mixed_reads(setup["text"], seed=seed),
                              lanes=60))
    alphas = ts.search_chars(tsi.alphamap_query, batch, mark_beyond)
    return torch.from_numpy(np.ascontiguousarray(alphas.T).astype(np.int8))


@pytest.mark.parametrize("splits", [(1,), (2, 7), (13, 14, 40)])
def test_count_carried_state_equals_one_pass(setup, splits):
    """A count scan split into pieces (the first from row 0's char, the
    rest from the carried state) ends in the state and count of one
    pass."""
    tsi = setup["tsi"]
    args = (tsi.rec_all, tsi.init_rec, tsi.all_p, tsi.r, tsi.sigma)
    chars = _chars(setup, mark_beyond=True)
    st_one, cnt_one = ts.fused_count_scan(*args, chars)
    bounds = [0, *splits, chars.shape[0]]
    st = None
    for lo, hi in zip(bounds, bounds[1:]):
        st, cnt = ts.fused_count_scan(*args, chars[lo:hi], st)
    assert torch.equal(st, st_one)
    assert torch.equal(cnt, cnt_one)


@pytest.mark.parametrize("splits", [(1,), (2, 7), (13, 14, 40)])
def test_zml_carried_state_equals_one_pass(setup, splits):
    tsi = setup["tsi"]
    args = (tsi.rec_all, tsi.init_rec, tsi.r, tsi.sigma)
    chars = _chars(setup, mark_beyond=False)
    st_one, ml_one = ts.fused_zml_scan(*args, chars)
    bounds = [0, *splits, chars.shape[0]]
    st, mls = None, []
    for lo, hi in zip(bounds, bounds[1:]):
        st, ml = ts.fused_zml_scan(*args, chars[lo:hi], st)
        mls.append(ml)
    assert torch.equal(st, st_one)
    assert torch.equal(torch.cat(mls), ml_one)


def test_scan_from_first_char_needs_a_step(setup):
    tsi = setup["tsi"]
    empty = torch.zeros((0, 3), dtype=torch.int8)
    with pytest.raises(ValueError):
        ts.fused_zml_scan(tsi.rec_all, tsi.init_rec, tsi.r, tsi.sigma, empty)


def test_search_backend_ladder(monkeypatch):
    """pick_backend's "search" rung: the paired records at 48*sigma^2 B
    per run, then the one-step ones at 32*sigma B per run."""
    r, sigma = 1000, 4
    paired = select.paired_search_table_bytes(r, sigma)
    assert paired == 768 * r
    assert select.one_step_search_table_bytes(r, sigma) == 128 * r
    for budget, want in ((2 * paired, "paired"), (2 * paired - 2, "one-step"),
                         (2 * 128 * r - 2, "compact")):
        monkeypatch.setattr(select, "memory_budget_bytes", lambda d: budget)
        assert select.pick_backend(r, sigma, "search") == want
    assert select.pick_backend(r, sigma, "search", force_paired=True) \
        == "paired"
    monkeypatch.setattr(select, "memory_budget_bytes", lambda d: 1 << 40)
    assert not select.use_paired_search(select.SEARCH2_MAX_RUNS, sigma)
    assert not select.use_paired_search(r, 7)
    with pytest.raises(ValueError):
        select.pick_backend(r, sigma, "kmer")
