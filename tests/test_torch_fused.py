"""One-step PML port (movi_tpu_torch/engine/fused.py) against the JAX
engine and the scalar oracle, on the CPU.  Every comparison is exact."""

import numpy as np
import pytest
import torch

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import fused as jf
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import fused_index_from_jax
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.testing import length_reads, mixed_reads, small_index


@pytest.fixture(scope="module")
def setup():
    text, ix = small_index()
    return text, ix, ScalarEngine(ix), jf.build_fused_index(ix), \
        tf.build_fused_index(ix)


def test_records_byte_identical(setup):
    _, _, _, jfi, tfi = setup
    assert tfi.records.dtype == torch.int32
    assert np.array_equal(np.asarray(jfi.records), tfi.records.numpy())
    for f in ("r", "sigma", "start_idx", "start_offset", "p_dollar"):
        assert getattr(jfi, f) == getattr(tfi, f), f
    assert np.array_equal(jfi.alphamap_query, tfi.alphamap_query)
    conv = fused_index_from_jax(jfi)
    assert torch.equal(conv.records, tfi.records)
    assert conv.p_dollar == tfi.p_dollar


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_cache_loads_in_the_other_package(setup, tmp_path, writer):
    _, _, _, jfi, tfi = setup
    path = str(tmp_path / "fused_records.npz")
    if writer == "jax":
        jf.save_fused_index(jfi, path)
        got = tf.load_fused_index(path)
        assert torch.equal(got.records, tfi.records)
    else:
        tf.save_fused_index(tfi, path)
        got = jf.load_fused_index(path)
        assert np.array_equal(np.asarray(got.records), tfi.records.numpy())
    for f in ("r", "sigma", "start_idx", "start_offset", "p_dollar"):
        assert tuple(np.atleast_1d(getattr(got, f))) == \
            tuple(np.atleast_1d(getattr(tfi, f))), f
    assert np.array_equal(got.alphamap_query, tfi.alphamap_query)


def _check_pml(setup, reads):
    _, _, sc, jfi, tfi = setup
    batch = next(make_batches(reads, lanes=len(reads)))
    want_jax = jf.FusedPMLEngine(jfi).query_batch(batch)
    got = tf.FusedPMLEngine(tfi, "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got[i] == want_jax[i], name
        assert got[i] == sc.query_pml(seq), name


def test_one_step_pml_mixed_reads(setup):
    _check_pml(setup, mixed_reads(setup[0]))


def test_one_step_pml_edge_lengths(setup):
    """Lengths 1-4097: the port scans the whole width at once, the JAX
    engine across its carried-chunk boundaries."""
    _check_pml(setup, length_reads(setup[0]))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_carried_state_equals_one_pass(setup, chunk):
    """Scanning in carried chunks gives the ml and final state of one
    pass over the whole width (the kernel's state in/out contract)."""
    text, _, _, _, tfi = setup
    eng = tf.FusedPMLEngine(tfi, "cpu")
    batch = next(make_batches(mixed_reads(text, seed=5), lanes=60))
    alphas_t = eng.prepare(batch)
    args = (tfi.records, tfi.sigma + 1, tfi.p_dollar)
    state0 = tf.initial_state(tfi, batch.lanes, "cpu")
    st_one, ml_one = tf.fused_pml_scan(*args, alphas_t, state0)
    st, mls = state0, []
    for c0 in range(0, alphas_t.shape[0], chunk):
        st, ml = tf.fused_pml_scan(*args, alphas_t[c0:c0 + chunk], st)
        mls.append(ml)
    assert torch.equal(torch.cat(mls), ml_one)
    for a, b in zip(st, st_one):
        assert torch.equal(a, b)
