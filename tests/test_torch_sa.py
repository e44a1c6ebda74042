"""SA entries (engine/fused_sa.py) against movi_tpu's engine/fused_sa.py
and the scalar oracle (ScalarEngine.query_pml(collect_sa=True)), on the
CPU: the pre_tab bytes, the plain pre-state scan and SA walk against the
JAX ones on the same inputs, a split scan against one pass, and the
engine's PMLs and SA values for every read.  Tolerance 0: int32 and int64
streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused_sa as jsa
from movi_tpu_torch.convert import fused_sa_index_from_jax
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused_sa as tsa
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import length_reads, small_sa_index

RATES = [100, 37]


def _setup(rate):
    """(ix, reads, the port's FusedSAIndex, the JAX one, one batch of
    every read: the 25 of tests/test_fused_sa.py and EDGE_LENGTHS)."""
    text, ix, reads = small_sa_index(rate)
    reads = reads + length_reads(text)
    sx = tsa.build_fused_sa_index(ix, tf.build_fused_index(ix))
    jsx = jsa.build_fused_sa_index(ix, jf.build_fused_index(ix))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return ix, reads, sx, jsx, batch


def _codes(sx, batch):
    return tf.FusedPMLEngine(sx.fi, "cpu").prepare(batch)


def _plain_scan(sx, codes, state=None):
    fi = sx.fi
    if state is None:
        state = tf.initial_state(fi, codes.shape[1], "cpu")
    return tsa.pml_pre_state_scan_plain(fi.records, sx.pre_tab, fi.sigma + 1,
                                        fi.p_dollar, codes, state)


@pytest.mark.parametrize("rate", RATES)
def test_pre_tab_byte_identical(rate):
    ix, _, sx, jsx, _ = _setup(rate)
    assert sx.pre_tab.dtype == torch.int32
    assert sx.pre_tab.numpy().tobytes() == np.asarray(jsx.pre_tab).tobytes()
    assert sx.all_p.dtype == torch.int64 and sx.sampled.dtype == torch.int64
    assert np.array_equal(sx.all_p.numpy(), np.asarray(jsx.all_p))
    assert np.array_equal(sx.sampled.numpy(), np.asarray(jsx.sampled))
    assert (sx.rate, sx.n) == (jsx.rate, jsx.n) == (rate, ix.length)


@pytest.mark.parametrize("rate", RATES)
def test_fused_sa_index_from_jax_equals_own_build(rate):
    _, _, sx, jsx, _ = _setup(rate)
    got = fused_sa_index_from_jax(jsx)
    for name in ("pre_tab", "all_p", "sampled"):
        a, b = getattr(got, name), getattr(sx, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    assert torch.equal(got.fi.records, sx.fi.records)
    assert got.fi.p_dollar == sx.fi.p_dollar
    assert (got.rate, got.n) == (sx.rate, sx.n)


@pytest.mark.parametrize("rate", RATES)
def test_pre_state_scan_equals_jax(rate):
    _, _, sx, jsx, batch = _setup(rate)
    codes = _codes(sx, batch)
    _, ml, pre_idx, pre_off = _plain_scan(sx, codes)
    want = jsa._pml_pre_state_scan(jsx, jnp.asarray(codes.numpy()))
    for name, got, w in zip(("ml", "pre_idx", "pre_off"),
                            (ml, pre_idx, pre_off), want):
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), np.asarray(w)), name


@pytest.mark.parametrize("rate", RATES)
def test_sa_walk_equals_jax(rate):
    """Over every element of the [W, lanes] batch, padding included."""
    _, _, sx, jsx, batch = _setup(rate)
    _, _, pre_idx, pre_off = _plain_scan(sx, _codes(sx, batch))
    idx, off = pre_idx.reshape(-1), pre_off.reshape(-1)
    fi = sx.fi
    got = tsa.sa_walk_plain(fi.records, fi.sigma + 1, sx.all_p, sx.sampled,
                            sx.rate, sx.n, idx, off)
    want = jsa._sa_walk(jsx, jnp.asarray(idx.numpy()),
                        jnp.asarray(off.numpy()))
    assert got.dtype == torch.int64 and got.shape == idx.shape
    assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_sa_values_stay_64_bit():
    """Sampled values past 2^40 come out whole: nothing on the walk's
    output path narrows to int32."""
    _, _, sx, _, batch = _setup(37)
    _, _, pre_idx, pre_off = _plain_scan(sx, _codes(sx, batch))
    fi = sx.fi
    args = (fi.records, fi.sigma + 1, sx.all_p)
    flat = (pre_idx.reshape(-1), pre_off.reshape(-1))
    base = tsa.sa_walk_plain(*args, sx.sampled, sx.rate, sx.n, *flat)
    far = tsa.sa_walk_plain(*args, sx.sampled + (1 << 40), sx.rate, sx.n,
                            *flat)
    assert torch.equal(far - base, torch.full_like(base, 1 << 40))


def test_walk_past_max_steps_gives_minus_one():
    """Walks longer than max_steps stop with -1; the others keep their
    values, and the steps are the walk's lengths."""
    _, _, sx, _, batch = _setup(100)
    _, _, pre_idx, pre_off = _plain_scan(sx, _codes(sx, batch))
    fi = sx.fi
    args = (fi.records, fi.sigma + 1, sx.all_p, sx.sampled, sx.rate)
    flat = (pre_idx.reshape(-1), pre_off.reshape(-1))
    full, steps = tsa.sa_walk_steps_plain(*args, sx.n, *flat)
    assert int(steps.max()) > 40 and int(steps.min()) == 0
    cut, cut_steps = tsa.sa_walk_steps_plain(*args, 40, *flat)
    long = steps > 40
    assert torch.equal(cut, torch.where(long, -1, full))
    assert torch.equal(cut_steps, torch.clamp(steps, max=40))


def test_split_scan_equals_one_pass():
    _, _, sx, _, batch = _setup(100)
    codes = _codes(sx, batch)
    st, *whole = _plain_scan(sx, codes)
    cut = codes.shape[0] // 2 | 1
    st1, *first = _plain_scan(sx, codes[:cut])
    st2, *second = _plain_scan(sx, codes[cut:], st1)
    for a, b, c in zip(first, second, whole):
        assert torch.equal(torch.cat([a, b]), c)
    for a, b in zip(st2, st):
        assert torch.equal(a, b)


@pytest.mark.parametrize("rate", RATES)
def test_engine_equals_jax_and_scalar(rate):
    """FusedSAEngine.query_batch equals the JAX FusedSAEngine and
    ScalarEngine.query_pml(collect_sa=True) for every read, over several
    batches."""
    ix, reads, _, _, _ = _setup(rate)
    eng = tsa.FusedSAEngine(tf.build_fused_index(ix), ix, "cpu")
    jeng = jsa.FusedSAEngine(jf.build_fused_index(ix), ix)
    oracle = ScalarEngine(ix)
    n = 0
    for b in make_batches(reads, lanes=12, bucket_widths=False):
        got = eng.query_batch(b)
        assert got == jeng.query_batch(b)
        for name, res in zip(b.names, got):
            seq = dict(reads)[name]
            assert res == oracle.query_pml(seq, collect_sa=True), name
            n += 1
    assert n == len(reads)
