"""Paired PML port (movi_tpu_torch/engine/fused2.py) against the JAX
engine and the scalar oracle, on the CPU.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused2 as jf2
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import fused2_index_from_jax
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.testing import length_reads, mixed_reads, small_index


@pytest.fixture(scope="module")
def setup():
    text, ix = small_index()
    jfi = jf.build_fused_index(ix)
    tfi = tf.build_fused_index(ix)
    # the JAX build composes in one chunk here (r < COMPOSE_CHUNK)
    return dict(text=text, ix=ix, sc=ScalarEngine(ix), jfi=jfi, tfi=tfi,
                jf2=jf2.build_fused2_index(jfi),
                tf2=tf2.build_fused2_index(tfi))


def test_compose_single_shot_byte_identical(setup):
    tfi, j2 = setup["tfi"], setup["jf2"]
    r, slots = tfi.r, tfi.sigma + 1
    want, want_b = jf2.compose_records(setup["jfi"].records, r=r,
                                       slots=slots, p_dollar=tfi.p_dollar,
                                       chunk_runs=r)
    got, got_b = tf2.compose_records(tfi.records, r, slots, tfi.p_dollar,
                                     chunk_runs=r)
    assert got.dtype == torch.int32
    assert got_b == want_b
    assert np.array_equal(np.asarray(want), got.numpy())
    assert np.array_equal(np.asarray(j2.records), setup["tf2"].records.numpy())
    conv = fused2_index_from_jax(j2)
    assert torch.equal(conv.records, setup["tf2"].records)


def test_compose_chunked_byte_identical(setup):
    """Chunks that neither divide r nor align to it, plus the overlapping
    last-chunk recompose."""
    tfi = setup["tfi"]
    r, slots = tfi.r, tfi.sigma + 1
    ch = r // 3 - 1
    want, want_b = jf2.compose_records(setup["jfi"].records, r=r,
                                       slots=slots, p_dollar=tfi.p_dollar,
                                       chunk_runs=ch)
    got, got_b = tf2.compose_records(tfi.records, r, slots, tfi.p_dollar,
                                     chunk_runs=ch)
    assert got_b == want_b
    assert np.array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("width", [1, 2, 7, 64, 65])
def test_pack_pairs_equal(width):
    rng = np.random.default_rng(width)
    alphas = rng.integers(0, 5, size=(9, width)).astype(np.int32)
    want, want_w = jf2.pack_pairs(alphas, 4)
    got, got_w = tf2.pack_pairs(alphas, 4)
    assert got_w == want_w == width
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)


def _check_pml(setup, reads):
    batch = next(make_batches(reads, lanes=len(reads)))
    want_jax = jf2.Fused2PMLEngine(setup["jf2"]).query_batch(batch)
    got = tf2.Fused2PMLEngine(setup["tf2"], "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got[i] == want_jax[i], name
        assert got[i] == setup["sc"].query_pml(seq), name


def test_paired_pml_mixed_reads(setup):
    _check_pml(setup, mixed_reads(setup["text"]))


def test_paired_pml_edge_lengths(setup):
    """Odd lengths (tail pad) and lengths 1-4097: the port scans the whole
    width at once, the JAX engine across its carried-chunk boundaries."""
    _check_pml(setup, length_reads(setup["text"]))


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_paired_carried_state_equals_one_pass(setup, chunk):
    """Scanning in carried chunks of pairs gives the ml and final state of
    one pass (the paired kernel's state in/out contract)."""
    eng = tf2.Fused2PMLEngine(setup["tf2"], "cpu")
    batch = next(make_batches(mixed_reads(setup["text"], seed=5), lanes=60))
    a12_t, _ = eng.prepare(batch)
    f2 = setup["tf2"]
    args = (f2.records, f2.sigma + 1, f2.p_dollar)
    state0 = tf.initial_state(f2, batch.lanes, "cpu")
    st_one, ml_one = tf2.fused2_pml_scan(*args, a12_t, state0)
    st, mls = state0, []
    for c0 in range(0, a12_t.shape[0], chunk):
        st, ml = tf2.fused2_pml_scan(*args, a12_t[c0:c0 + chunk], st)
        mls.append(ml)
    assert torch.equal(torch.cat(mls), ml_one)
    for a, b in zip(st, st_one):
        assert torch.equal(a, b)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_paired_cache_loads_in_the_other_package(setup, tmp_path, writer):
    path = str(tmp_path / "paired_records.npz")
    want = setup["tf2"]
    if writer == "jax":
        jf2.save_fused2_index(setup["jf2"], path)
        got = tf2.load_fused2_index(path).records.numpy()
    else:
        tf2.save_fused2_index(want, path)
        got = np.asarray(jf2.load_fused2_index(path).records)
    assert np.array_equal(got, want.records.numpy())


# A fields past 2^24: the 9 high bits of A_hi reach w0's sign bit
A_CASES = [(0x1ABCDEF, 0x1FFFFFF), (0, tf2.MAX_RUNS - 1),
           (0xFFFFFF, 0x1000000)]


def _const_record(A_lo, A_hi, T1=5, C_lo=7, C_hi=9):
    """A record whose branches are CONST (next state = (A, C)), packed by
    the port's word packer."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    k = tf2.KIND_CONST
    return tf2.pack_words(t(T1), t(1), (t(A_lo), t(0), t(C_lo), t(k), t(0)),
                          (t(A_hi), t(0), t(C_hi), t(k), t(0)))


@pytest.mark.parametrize("A_lo,A_hi", A_CASES)
def test_25_bit_run_ids_decode_exactly(A_lo, A_hi):
    """The port's packer round-trips through its decode for A past 2^24,
    and the JAX decode reads the same words the same way."""
    rec = _const_record(A_lo, A_hi)
    assert rec.dtype == torch.int32
    if A_hi >= 1 << 24:
        assert int(rec[0, 0]) < 0  # bit 31 set
    T1 = 5
    for off, want_A, want_C in [(T1 - 1, A_lo, 7), (T1, A_hi, 9)]:
        offs = torch.tensor([off], dtype=torch.int32)
        idx, o, m1, *_ = tf2._fused2_decode(rec, offs, (0, 0))
        assert (int(idx[0]), int(o[0]), int(m1[0])) == (want_A, want_C, 1)
        jidx, jo, *_ = jf2._fused2_decode(jnp.asarray(rec.numpy()),
                                          jnp.asarray([off]), (0, 0))
        assert (int(jidx[0]), int(jo[0])) == (want_A, want_C)


@pytest.mark.parametrize("A_lo,A_hi", A_CASES)
def test_25_bit_words_match_jax_packing(A_lo, A_hi):
    """The packer's words equal the int32-wrapped words of
    tests/test_fused2.py's hand packing."""
    T1, C_lo, C_hi, K = 5, 7, 9, jf2.KIND_CONST
    w0 = ((T1 + jf2._BIAS) | (1 << 13)
          | ((A_lo >> 16) << 14) | ((A_hi >> 16) << 23))
    w1 = jf2._BIAS | (C_lo << 13) | (K << 25)
    w2 = jf2._BIAS | (C_hi << 13) | (K << 25)
    w3 = (A_lo & 0xFFFF) | ((A_hi & 0xFFFF) << 16)
    want = np.array([w0, w1, w2, w3], dtype=np.int64).astype(np.int32)
    assert np.array_equal(_const_record(A_lo, A_hi)[0].numpy(), want)
