"""Paired count/ZML port (movi_tpu_torch/engine/fused_search2.py) against
the JAX engines and the scalar oracle, on the CPU.  Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import fused_search2 as js2
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import fused_search2_index_from_jax
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.testing import length_reads, mixed_reads, small_index


@pytest.fixture(scope="module")
def setup():
    text, ix = small_index()
    # the JAX build composes in one chunk here (r < COMPOSE_CHUNK)
    return dict(text=text, ix=ix, sc=ScalarEngine(ix),
                j2=js2.build_fused_search2_index(ix),
                t2=ts2.build_fused_search2_index(ix, "cpu"),
                tsi=ts.build_fused_search_index(ix))


def _compose_inputs(ix):
    nu, nd = ix.next_tables_search()
    return [np.asarray(x).astype(np.int32)
            for x in (ix.id_arr, ix.offset_arr, ix.n_arr, nu, nd)]


def test_paired_search_tables_byte_identical(setup):
    j2, t2 = setup["j2"], setup["t2"]
    for f in ("rec_all", "init_rec", "restart_rec", "all_p"):
        got = getattr(t2, f)
        assert got.dtype == torch.int32, f
        assert np.array_equal(np.asarray(getattr(j2, f)), got.numpy()), f
    assert t2.rec_all.shape == (2 * t2.r * t2.sigma ** 2, 6)
    assert np.array_equal(j2.alphamap_query, t2.alphamap_query)


@pytest.mark.parametrize("chunk", ["third", "ragged"])
def test_compose_chunked_byte_identical(setup, chunk):
    """Chunks that neither divide r nor align to it, and the overlapping
    last-chunk recompose; the JAX compose at the same chunk size."""
    ix = setup["ix"]
    r, sigma = ix.r, ix.sigma
    ch = r // 3 - 1 if chunk == "third" else 97
    inputs = _compose_inputs(ix)
    want = js2.compose_search2(*[jnp.asarray(x) for x in inputs], r=r,
                               sigma=sigma, chunk_runs=ch)
    got = ts2.compose_search2(*[torch.from_numpy(x) for x in inputs], r,
                              sigma, chunk_runs=ch)
    assert r % ch != 0
    assert np.array_equal(np.asarray(want), got.numpy())
    assert torch.equal(got, setup["t2"].rec_all)


@pytest.mark.parametrize("width", [1, 2, 7, 64, 65])
def test_pack_search_pairs_equal(width):
    rng = np.random.default_rng(width)
    alphas = rng.integers(-2, 4, size=(9, width)).astype(np.int32)
    want, want_w = js2.pack_search_pairs(alphas, 4)
    got, got_w = ts2.pack_search_pairs(alphas, 4)
    assert got_w == want_w == width
    assert got.dtype == want.dtype == np.uint8
    assert np.array_equal(got, want)


def _check(setup, reads):
    batch = next(make_batches(reads, lanes=len(reads)))
    j2, t2, sc = setup["j2"], setup["t2"], setup["sc"]
    want_c = js2.Fused2CountEngine(j2).query_batch(batch)
    want_z = js2.Fused2ZMLEngine(j2).query_batch(batch)
    got_c = ts2.Fused2CountEngine(t2, "cpu").query_batch(batch)
    got_z = ts2.Fused2ZMLEngine(t2, "cpu").query_batch(batch)
    one_c = ts.FusedCountEngine(setup["tsi"], "cpu").query_batch(batch)
    one_z = ts.FusedZMLEngine(setup["tsi"], "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got_c[i] == want_c[i] == sc.query_count(seq), name
        assert got_z[i] == want_z[i] == sc.query_zml(seq), name
    assert got_c == one_c
    assert got_z == one_z


def test_paired_count_zml_mixed_reads(setup):
    _check(setup, mixed_reads(setup["text"]))


def test_paired_count_zml_edge_lengths(setup):
    """Odd lengths (tail pad) and lengths 1-4097: the port scans the whole
    width at once, the JAX engines across their 1024-pair chunks."""
    _check(setup, length_reads(setup["text"]))


def _batch(setup):
    return next(make_batches(mixed_reads(setup["text"], seed=5), lanes=60))


@pytest.mark.parametrize("splits", [(1,), (3, 4), (7, 8, 21)])
def test_paired_count_carried_state_equals_one_pass(setup, splits):
    t2 = setup["t2"]
    args = (t2.rec_all, t2.init_rec, t2.all_p, t2.r, t2.sigma)
    a0, pairs = ts2.Fused2CountEngine(t2, "cpu").prepare(_batch(setup))
    st_one, cnt_one = ts2.fused2_count_scan(*args, pairs, a0=a0)
    bounds = [0, *splits, pairs.shape[0]]
    st, cnt = ts2.fused2_count_scan(*args, pairs[:0], a0=a0)
    for lo, hi in zip(bounds, bounds[1:]):
        st, cnt = ts2.fused2_count_scan(*args, pairs[lo:hi], st)
    assert torch.equal(st, st_one)
    assert torch.equal(cnt, cnt_one)


@pytest.mark.parametrize("splits", [(1,), (3, 4), (7, 8, 21)])
def test_paired_zml_carried_state_equals_one_pass(setup, splits):
    t2 = setup["t2"]
    args = (t2.rec_all, t2.init_rec, t2.restart_rec, t2.r, t2.sigma)
    pairs = ts2.Fused2ZMLEngine(t2, "cpu").prepare(_batch(setup))
    st_one, ml_one = ts2.fused2_zml_scan(*args, pairs)
    bounds = [0, *splits, pairs.shape[0]]
    st, mls = None, []
    for lo, hi in zip(bounds, bounds[1:]):
        st, ml = ts2.fused2_zml_scan(*args, pairs[lo:hi], st)
        mls.append(ml)
    assert torch.equal(st, st_one)
    assert torch.equal(torch.cat(mls), ml_one)


def test_paired_count_needs_a0_or_state(setup):
    t2 = setup["t2"]
    args = (t2.rec_all, t2.init_rec, t2.all_p, t2.r, t2.sigma,
            torch.zeros((2, 3), dtype=torch.uint8))
    with pytest.raises(ValueError):
        ts2.fused2_count_scan(*args)
    with pytest.raises(ValueError):
        ts2.fused2_count_scan(*args, torch.zeros((6, 3), dtype=torch.int32),
                              torch.zeros(3, dtype=torch.int8))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_paired_search_cache_loads_in_the_other_package(setup, tmp_path,
                                                        writer):
    path = str(tmp_path / "paired_search_records.npz")
    t2 = setup["t2"]
    if writer == "jax":
        js2.save_fused_search2_index(setup["j2"], path)
        got = ts2.load_fused_search2_index(path)
        fields = {f: getattr(got, f).numpy()
                  for f in ("rec_all", "init_rec", "restart_rec", "all_p")}
    else:
        ts2.save_fused_search2_index(t2, path)
        got = js2.load_fused_search2_index(path)
        fields = {f: np.asarray(getattr(got, f))
                  for f in ("rec_all", "init_rec", "restart_rec", "all_p")}
    for f, v in fields.items():
        assert np.array_equal(v, getattr(t2, f).numpy()), f
    assert (got.r, got.sigma) == (t2.r, t2.sigma)
    assert np.array_equal(got.alphamap_query, t2.alphamap_query)


def test_stale_paired_search_cache_raises(setup, tmp_path):
    path = str(tmp_path / "paired_search_records.npz")
    ts2.save_fused_search2_index(setup["t2"], path)
    z = dict(np.load(path))
    z["meta"] = np.array([z["meta"][0], z["meta"][1], 1], dtype=np.int64)
    np.savez(path, **z)
    with pytest.raises(ValueError, match="stale"):
        ts2.load_fused_search2_index(path)
    with pytest.raises(ValueError, match="stale"):
        js2.load_fused_search2_index(path)


def test_convert_gives_equal_engines(setup):
    conv = fused_search2_index_from_jax(setup["j2"])
    for f in ("rec_all", "init_rec", "restart_rec", "all_p"):
        assert torch.equal(getattr(conv, f), getattr(setup["t2"], f)), f
    reads = mixed_reads(setup["text"], seed=8, count=30)
    batch = next(make_batches(reads, lanes=len(reads)))
    assert (ts2.Fused2CountEngine(conv, "cpu").query_batch(batch)
            == js2.Fused2CountEngine(setup["j2"]).query_batch(batch))
    assert (ts2.Fused2ZMLEngine(conv, "cpu").query_batch(batch)
            == js2.Fused2ZMLEngine(setup["j2"]).query_batch(batch))
