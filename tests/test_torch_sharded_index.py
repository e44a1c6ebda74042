"""The model-sharded record scans of
movi_tpu_torch/parallel/sharded_index.py at (data, model) = (2, 2) and
(1, 4) (four gloo ranks, each a fresh process) against JAX's at (2, 4) on
the 8-device CPU mesh, the unsharded scans and ScalarEngine; the plain
per-shard gathers of kernels 15a and 15b against a numpy emulation; and
the pick_backend ladder against movi_tpu's.  Every comparison is exact."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine.fused import build_fused_index
from movi_tpu.engine.fused_search import (build_fused_search_index,
                                          fused_count_scan, fused_zml_scan)
from movi_tpu.parallel import sharded_index as jsi
from movi_tpu_torch import testing
from movi_tpu_torch.convert import (fused_index_from_jax,
                                    fused_search_index_from_jax)
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import select as tselect
from movi_tpu_torch.parallel import make_mesh
from movi_tpu_torch.parallel import sharded_index as tsi

SHAPES = [(2, 2), (1, 4)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(53)
    text = testing.random_text(5000, 53)
    ix = testing.index_from_text(text)
    jfi = build_fused_index(ix)
    jsx = build_fused_search_index(ix)
    pml_alphas, pml_reads = testing.scan_order_codes(
        rng, text, jfi.alphamap_query, 16, 40, jfi.sigma)
    search_alphas, search_reads = testing.scan_order_codes(
        rng, text, jsx.alphamap_query, 16, 40, -2)
    return dict(text=text, ix=ix, jfi=jfi, jsx=jsx, pml=pml_alphas,
                pml_reads=pml_reads, search=search_alphas,
                search_reads=search_reads)


@pytest.fixture(scope="module")
def port(case):
    """[results per shape of SHAPES] from four gloo ranks, and the
    one-rank (1, 1) mesh in this process."""
    ranks = testing.run_ranks("movi_tpu_torch.testing:sharded_rank", 4,
                              shapes=SHAPES, text=case["text"],
                              pml_alphas=case["pml"],
                              search_alphas=case["search"])
    one = testing.sharded_results(make_mesh(1, "cpu"), case["text"],
                                  case["pml"], case["search"])
    return dict(zip(SHAPES, ranks[0]), **{"(1, 1)": one})


@pytest.fixture(scope="module")
def jax_res(case):
    assert len(jax.devices()) >= 8
    mesh = jsi.make_2d_mesh(data=2, model=4)
    m, c = jsi.sharded_fused_count(mesh, case["jsx"], case["search"])
    return dict(pml=np.asarray(jsi.sharded_fused_pml(mesh, case["jfi"],
                                                     case["pml"])),
                count=(np.asarray(m), np.asarray(c)),
                zml=np.asarray(jsi.sharded_fused_zml(mesh, case["jsx"],
                                                     case["search"])))


def _shapes():
    return SHAPES + ["(1, 1)"]


@pytest.mark.parametrize("shape", _shapes(), ids=str)
def test_sharded_pml(case, port, jax_res, shape):
    ml = port[shape]["pml"]
    assert np.array_equal(ml, jax_res["pml"])
    sc = ScalarEngine(case["ix"])
    for i, seq in enumerate(case["pml_reads"]):
        assert ml[:len(seq), i].tolist() == sc.query_pml(seq), i


@pytest.mark.parametrize("shape", _shapes(), ids=str)
def test_sharded_count_and_zml(case, port, jax_res, shape):
    """Equal to JAX's sharded scans, the unsharded fused scans and
    ScalarEngine."""
    matched, count = port[shape]["count"]
    assert count.dtype == np.int64
    m_u, c_u = (np.asarray(x) for x in
                fused_count_scan(case["jsx"], jnp.asarray(case["search"])))
    for m_ref, c_ref in (jax_res["count"], (m_u, c_u)):
        assert np.array_equal(matched, m_ref)
        assert np.array_equal(count, c_ref)
    zml = port[shape]["zml"]
    assert np.array_equal(zml, jax_res["zml"])
    assert np.array_equal(zml, np.asarray(
        fused_zml_scan(case["jsx"], jnp.asarray(case["search"]))))
    sc = ScalarEngine(case["ix"])
    for i, seq in enumerate(case["search_reads"]):
        assert (len(seq) - int(matched[i]), int(count[i])) == \
            sc.query_count(seq), i
        assert zml[:len(seq), i].tolist() == sc.query_zml(seq), i


def _emulated_rows(records: np.ndarray, model: int, m: int,
                   keys: np.ndarray) -> np.ndarray:
    """Shard m's rows of keys, numpy: the table padded to a multiple of
    model, rows [m*len, (m+1)*len) owned, zero elsewhere."""
    rows = -(-records.shape[0] // model) * model
    padded = np.zeros((rows, records.shape[1]), records.dtype)
    padded[:records.shape[0]] = records
    shard_len = rows // model
    out = np.zeros((len(keys), records.shape[1]), records.dtype)
    own = (keys >= m * shard_len) & (keys < (m + 1) * shard_len)
    out[own] = padded[keys[own]]
    return out


@pytest.mark.parametrize("model", [2, 3])
def test_plain_gathers_per_shard(case, model):
    """Kernels 15a and 15b's plain versions: the rows each shard gathers
    at step 0 (the search's: those of the second char's keys) equal a
    numpy emulation, and the shards sum to the unsharded rows."""
    tfi = fused_index_from_jax(case["jfi"])
    tsx = fused_search_index_from_jax(case["jsx"])
    codes = torch.from_numpy(case["pml"].astype(np.uint8))
    chars = torch.from_numpy(case["search"].astype(np.int8))
    W, lanes = codes.shape
    slots = tfi.sigma + 1
    pml_keys = np.full(lanes, tfi.start_idx, np.int64) * slots + \
        case["pml"][0]
    pml_sum = np.zeros((lanes, 2), np.int64)
    search_sum = np.zeros((2 * lanes, 4), np.int64)
    for m in range(model):
        mesh = make_mesh(1, "cpu")
        mesh.model, mesh.m = model, m
        local, lo = tsi.local_shard(mesh, tfi.records)
        st = torch.tensor([tfi.start_idx, tfi.start_offset, 0],
                          dtype=torch.int32)[:, None].repeat(1, lanes)
        ml = torch.zeros((W, lanes), dtype=torch.int32)
        rec = tsi.sharded_pml_gather_plain(local, lo, slots, tfi.p_dollar,
                                           codes, 0, None, st, ml)
        want = _emulated_rows(tfi.records.numpy(), model, m, pml_keys)
        assert np.array_equal(rec.numpy(), want)
        pml_sum += rec.numpy()

        local, lo = tsi.local_shard(mesh, tsx.rec_all)
        st = torch.empty((6, lanes), dtype=torch.int32)
        rec = tsi.sharded_search_gather_plain(local, lo, tsx.r, tsx.sigma,
                                              tsx.init_rec, chars, 0, False,
                                              None, st, None)
        a1 = np.maximum(case["search"][1], 0).astype(np.int64)
        rs, re = st[0].numpy(), st[2].numpy()
        keys = np.concatenate([
            a1 * tsx.r + np.clip(rs, 0, tsx.r - 1),
            (tsx.sigma + a1) * tsx.r + np.clip(re, 0, tsx.r - 1)])
        assert np.array_equal(
            rec.numpy(), _emulated_rows(tsx.rec_all.numpy(), model, m, keys))
        search_sum += rec.numpy()
    assert np.array_equal(pml_sum, tfi.records.numpy()[pml_keys])
    assert np.array_equal(search_sum, tsx.rec_all.numpy()[keys])


def test_sharded_count_keeps_64_bits(case):
    """ROADMAP §3: JAX's sharded_fused_count takes the interval size from
    int32 all_p, so a count past 2^31 wraps.  With all_p scaled past 2^31
    (a synthetic table: the scan never reads all_p), the port's count is
    the exact int64 size; JAX's wraps (recorded, not fixed)."""
    jsx = case["jsx"]
    big = np.asarray(jsx.all_p).astype(np.int64) << 22
    tsx = dataclasses.replace(fused_search_index_from_jax(jsx),
                              all_p=torch.from_numpy(big))
    mesh = make_mesh(1, "cpu")
    chars = case["search"][:1].copy()        # one char: the widest intervals
    matched, count = tsi.sharded_fused_count(mesh, tsx, chars)
    state = ts.fused_count_scan(tsx.rec_all, tsx.init_rec,
                                tsx.all_p.to(torch.int32), tsx.r, tsx.sigma,
                                torch.from_numpy(chars.astype(np.int8)))[0]
    rs, os_, re, oe, m = (state[i].numpy().astype(np.int64)
                          for i in range(5))
    want = np.where(m > 0, big[re] + oe - big[rs] - os_ + 1, 0)
    assert count.dtype == torch.int64 and want.max() >= 2**31
    assert np.array_equal(count.numpy(), want)
    # JAX takes the int64 all_p as int32
    _, jc = jsi.sharded_fused_count(
        jsi.make_2d_mesh(2, 4), dataclasses.replace(jsx, all_p=big), chars)
    jc = np.asarray(jc).astype(np.int64)
    assert not np.array_equal(jc, want)
    assert np.array_equal(jc % 2**32, want % 2**32)


@pytest.mark.parametrize("kind", ["pml", "search"])
def test_pick_backend_ladder(monkeypatch, kind):
    """paired -> one-step -> sharded -> compact as the budget runs out,
    rung for rung as movi_tpu's (tests/test_sharded_index.py:103)."""
    from movi_tpu.engine import select as jselect

    r, sigma = 1_000_000, 4
    budgets = [4_000_000_000, 2_000_000_000, 500_000_000, 200_000_000,
               100_000_000, 50_000_000, 10_000_000]
    seen = set()
    for budget in budgets:
        monkeypatch.setenv("MOVI_TPU_HBM_BYTES", str(budget))
        monkeypatch.setattr(tselect, "memory_budget_bytes",
                            lambda d, b=budget: b)
        for shards in (1, 4, 8):
            want = jselect.pick_backend(r, sigma, kind, model_shards=shards)
            got = tselect.pick_backend(r, sigma, kind, model_shards=shards,
                                       device="cpu")
            assert got == want, (budget, shards)
            seen.add(got)
    assert seen == {"paired", "one-step", "sharded", "compact"}
