"""The compact engines' port (movi_tpu_torch/engine/device_index.py,
pml.py, search.py) against the JAX package's and the port's ScalarEngine,
on the CPU: the run tables byte for byte, compact PML under both
repositioning rules, count and ZML, on threshold, threshold-free,
unbounded and separator indexes; carried state; the reposition that finds
no run; and the routes that reach the compact engines.  Every comparison
is exact."""

import numpy as np
import pytest
import torch

from movi_tpu import api as japi
from movi_tpu.engine import device_index as jdi
from movi_tpu.engine import pml as jpml
from movi_tpu.engine import search as jsearch
from movi_tpu_torch.api import Index
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.convert import device_index_from_jax
from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
from movi_tpu_torch.engine import device_index as tdi
from movi_tpu_torch.engine import pml as tpml
from movi_tpu_torch.engine import search as tsearch
from movi_tpu_torch.engine import select
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (length_reads, mixed_reads, random_text,
                                    separator_text)

# (mode, bound_ff, separators)
INDEXES = {"thr-unbounded": ("regular-thresholds", None, False),
           "thr-bounded": ("regular-thresholds", 1, False),
           "regular": ("regular", None, False),
           "large": ("large", None, False),
           "separators": ("regular-thresholds", 1, True)}


@pytest.fixture(scope="module")
def texts():
    text = random_text(5000, 47)
    sep_text, doc = separator_text()
    return {"plain": (text, build_bwt_runs(text)),
            "separators": (doc, build_bwt_runs(sep_text))}


@pytest.fixture(scope="module", params=list(INDEXES))
def case(request, texts):
    """One index, its reads (mixed with N's, '%' in a separator index's,
    lengths 1-4097) as one batch, and the oracle."""
    mode, bff, seps = INDEXES[request.param]
    text, runs = texts["separators" if seps else "plain"]
    ix = build_move_index(runs, mode, separators=seps, bound_ff=bff)
    reads = mixed_reads(text, seed=4, count=40) + length_reads(text)
    if seps:
        reads.append(("sep", text[:30].tobytes() + b"%" + text[40:70]
                      .tobytes()))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return dict(name=request.param, ix=ix, reads=reads, batch=batch,
                sc=ScalarEngine(ix), jdi=jdi.build_device_index(ix),
                tdi=tdi.build_device_index(ix))


def test_device_index_byte_identical(case):
    """build_device_index and device_index_from_jax give the JAX arrays,
    dtype and bytes."""
    jd, td = case["jdi"], case["tdi"]
    conv = device_index_from_jax(jd)
    for d in (td, conv):
        for f in ("mode", "r", "length", "end_bwt_idx", "sigma"):
            assert getattr(d, f) == getattr(jd, f), f
        assert np.array_equal(d.alphamap_query, np.asarray(jd.alphamap_query))
        for f in tdi.PML_TABLES + tdi.SEARCH_TABLES:
            want, got = getattr(jd, f), getattr(d, f)
            if want is None:
                assert got is None, f
                continue
            want = np.asarray(want)
            assert got.numpy().dtype == want.dtype, f
            assert got.numpy().tobytes() == want.tobytes(), f
    assert (td.thr_full is None) == (case["ix"].thr is None)
    assert td.hbm_bytes() == jd.hbm_bytes() + td.first_runs.numel() * 16


def _rules(ix):
    return [False, True] if ix.thr is not None else [True]


def test_compact_pml_equals_jax_and_oracle(case):
    """Both repositioning rules (threshold only with thresholds)."""
    ix, reads, batch = case["ix"], case["reads"], case["batch"]
    for rr in _rules(ix):
        want = jpml.PMLEngine(case["jdi"], rr).query_batch(batch)
        got = tpml.PMLEngine(case["tdi"], rr, "cpu").query_batch(batch)
        for i, (name, seq) in enumerate(reads):
            assert got[i] == want[i] == case["sc"].query_pml(
                seq, random_repositioning=rr), (name, rr)


def test_compact_count_zml_equal_jax_and_oracle(case):
    reads, batch, sc = case["reads"], case["batch"], case["sc"]
    want_c = jsearch.CountEngine(case["jdi"]).query_batch(batch)
    want_z = jsearch.ZMLEngine(case["jdi"]).query_batch(batch)
    got_c = tsearch.CountEngine(case["tdi"], "cpu").query_batch(batch)
    got_z = tsearch.ZMLEngine(case["tdi"], "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got_c[i] == want_c[i] == sc.query_count(seq), name
        assert got_z[i] == want_z[i] == sc.query_zml(seq), name


@pytest.fixture(scope="module")
def unbounded(texts):
    text, runs = texts["plain"]
    ix = build_move_index(runs, "regular-thresholds")
    reads = mixed_reads(text, seed=5, count=60)
    return ix, tdi.build_device_index(ix), reads


def _codes(di, reads, mark_beyond):
    batch = next(make_batches(reads, lanes=len(reads)))
    alphas = tsearch.search_chars(di.alphamap_query, batch, mark_beyond)
    return torch.from_numpy(np.ascontiguousarray(alphas.T).astype(np.int8))


@pytest.mark.parametrize("splits", [(1,), (2, 7), (13, 14, 40)])
@pytest.mark.parametrize("rr", [False, True])
def test_pml_carried_state_equals_one_pass(unbounded, splits, rr):
    _, di, reads = unbounded
    codes = _codes(di, reads, False)
    st0 = tpml.initial_state(di, codes.shape[1], "cpu")
    st_one, ml_one = tpml.compact_pml_scan(di, codes, st0, rr)
    bounds = [0, *splits, codes.shape[0]]
    st, mls = st0, []
    for lo, hi in zip(bounds, bounds[1:]):
        st, ml = tpml.compact_pml_scan(di, codes[lo:hi], st, rr)
        mls.append(ml)
    assert all(torch.equal(a, b) for a, b in zip(st, st_one))
    assert torch.equal(torch.cat(mls), ml_one)


@pytest.mark.parametrize("kind", ["count", "zml"])
@pytest.mark.parametrize("splits", [(1,), (2, 7), (13, 14, 40)])
def test_search_carried_state_equals_one_pass(unbounded, kind, splits):
    """A count or ZML scan split into pieces (the first from row 0's
    char, the rest from the carried state) equals one pass."""
    _, di, reads = unbounded
    scan = {"count": tsearch.compact_count_scan,
            "zml": tsearch.compact_zml_scan}[kind]
    codes = _codes(di, reads, kind == "count")
    st_one, out_one = scan(di, codes)
    bounds = [0, *splits, codes.shape[0]]
    st, outs = None, []
    for lo, hi in zip(bounds, bounds[1:]):
        st, out = scan(di, codes[lo:hi], st)
        outs.append(out)
    assert torch.equal(st, st_one)
    got = outs[-1] if kind == "count" else torch.cat(outs)
    assert torch.equal(got, out_one)


def test_scan_from_first_char_needs_a_step(unbounded):
    _, di, _ = unbounded
    empty = torch.zeros((0, 3), dtype=torch.int8)
    for scan in (tsearch.compact_count_scan, tsearch.compact_zml_scan):
        with pytest.raises(ValueError):
            scan(di, empty)


@pytest.mark.parametrize("rr", [False, True])
def test_reposition_without_a_run_raises_like_the_oracle(unbounded, rr):
    """With no run of any char above or below (the reposition tables
    emptied), the first mismatch raises ScalarEngine's message, in the
    plain scan as in the oracle."""
    ix, di, _ = unbounded
    none = torch.full_like(di.rep_up, di.r)
    broken = tdi.DeviceIndex(**{**di.__dict__, "rep_up": none,
                                "rep_down": none})
    sc = ScalarEngine(ix)
    sc.nu = np.full_like(sc.nu, ix.r)
    sc.nd = np.full_like(sc.nd, ix.r)
    read = random_text(50, 3).tobytes()
    with pytest.raises(AssertionError, match=tpml.NOT_FOUND):
        sc.query_pml(read, random_repositioning=rr)
    batch = next(make_batches([("r", read)], lanes=1))
    with pytest.raises(AssertionError, match=tpml.NOT_FOUND):
        tpml.PMLEngine(broken, rr, "cpu").query_batch(batch)


def test_threshold_rule_needs_thresholds(texts):
    ix = build_move_index(texts["plain"][1], "regular")
    di = tdi.build_device_index(ix)
    with pytest.raises(ValueError, match="thresholds"):
        tpml.PMLEngine(di, False, "cpu")
    with pytest.raises(ValueError, match="thresholds"):
        Index(ix).compact_engine("pml", device="cpu")
    with pytest.raises(ValueError):
        Index(ix).compact_engine("kmer", device="cpu")


def test_compact_table_bytes():
    """The compact tables a PML step reads cost 13 + 12*sigma B per run (61
    at sigma = 4) against the one-step records' 8*(sigma+1) (40); count/
    ZML's cost 16 + 8*sigma (48) against 32*sigma (128)."""
    r, sigma = 1000, 4
    assert select.compact_pml_table_bytes(r, sigma) == 61 * r + 4
    assert select.one_step_pml_table_bytes(r, sigma) == 40 * r
    assert select.compact_search_table_bytes(r, sigma) \
        == 48 * r + 4 + 16 * (sigma + 1)
    assert select.one_step_search_table_bytes(r, sigma) == 128 * r


def test_table_bytes_match_the_tables(unbounded):
    ix, di, _ = unbounded
    assert di.hbm_bytes(tdi.PML_TABLES) \
        == select.compact_pml_table_bytes(ix.r, ix.sigma)
    assert di.hbm_bytes(tdi.SEARCH_TABLES) \
        == select.compact_search_table_bytes(ix.r, ix.sigma)


def test_compact_rung_takes_the_compact_engines(monkeypatch, texts):
    """pick_backend returning "compact" (a budget below the one-step
    tables) makes Index.engine / search_engine the compact engines, whose
    answers equal the JAX API's (which picks its fused engines)."""
    text, runs = texts["plain"]
    ix = build_move_index(runs, "regular-thresholds", bound_ff=1)
    monkeypatch.setattr(select, "memory_budget_bytes", lambda d: 1000)
    assert select.pick_backend(ix.r, ix.sigma, "pml") == "compact"
    assert select.pick_backend(ix.r, ix.sigma, "search") == "compact"
    index = Index(ix)
    assert isinstance(index.engine(device="cpu"), tpml.PMLEngine)
    assert not index.engine(device="cpu").random_repositioning
    assert isinstance(index.search_engine("count", device="cpu"),
                      tsearch.CountEngine)
    assert isinstance(index.search_engine("zml", device="cpu"),
                      tsearch.ZMLEngine)
    reads = mixed_reads(text, seed=6, count=30)
    jix = japi.Index(ix)
    assert index.query_pml(reads, device="cpu") == jix.query_pml(reads)
    assert index.query_count(reads, device="cpu") == jix.query_count(reads)
    assert index.query_zml(reads, device="cpu") == jix.query_zml(reads)


@pytest.mark.parametrize("mode", ["regular-thresholds", "regular"])
def test_unbounded_api_equals_jax(texts, mode):
    """An index not built with bound_ff=1 takes the scalar route in both
    APIs; the engine getters give the compact engines."""
    text, runs = texts["plain"]
    ix = build_move_index(runs, mode)
    reads = mixed_reads(text, seed=7, count=20)
    index, jix = Index(ix), japi.Index(ix)
    assert index.query_pml(reads, device="cpu") == jix.query_pml(reads)
    assert index.query_count(reads, device="cpu") == jix.query_count(reads)
    assert index.query_zml(reads, device="cpu") == jix.query_zml(reads)
    eng = index.engine(device="cpu")
    assert isinstance(eng, tpml.PMLEngine)
    assert eng.random_repositioning == (ix.thr is None)
    assert isinstance(index.search_engine("zml", device="cpu"),
                      tsearch.ZMLEngine)
