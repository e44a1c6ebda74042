"""Dense-automaton PML port (movi_tpu_torch/engine/dense.py) against the
JAX engine and the scalar oracle, on the CPU.  Every comparison is
exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine import dense as jd
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import dense_index_from_jax
from movi_tpu_torch.engine import dense as td
from movi_tpu_torch.testing import length_reads, mixed_reads, small_index


@pytest.fixture(scope="module")
def setup():
    text, ix = small_index()
    return text, ix, ScalarEngine(ix), jd.build_dense_index(ix), \
        td.build_dense_index(ix)


def test_table_byte_identical(setup):
    _, _, _, jdi, tdi = setup
    assert tdi.table.dtype == torch.int32
    assert np.array_equal(np.asarray(jdi.table), tdi.table.numpy())
    for f in ("n", "sigma", "start_pos"):
        assert getattr(jdi, f) == getattr(tdi, f), f
    assert np.array_equal(jdi.alphamap_query, tdi.alphamap_query)
    conv = dense_index_from_jax(jdi)
    assert torch.equal(conv.table, tdi.table)
    assert conv.start_pos == tdi.start_pos


@pytest.mark.parametrize("reads", ["mixed", "lengths"])
def test_dense_pml_equals_jax_and_oracle(setup, reads):
    """Reads with N's (tests/test_fused.py:49's recipe), and reads of
    1-4,097 bases (past 512, across the JAX carried chunks)."""
    text, _, sc, jdi, tdi = setup
    reads = (mixed_reads(text, seed=2, count=50) if reads == "mixed"
             else length_reads(text))
    batch = next(make_batches(reads, lanes=len(reads)))
    want = jd.DensePMLEngine(jdi).query_batch(batch)
    got = td.DensePMLEngine(tdi, "cpu").query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        assert got[i] == want[i], name
        assert got[i] == sc.query_pml(seq), name


def test_split_scan_equals_one_pass(setup):
    text, _, _, _, tdi = setup
    batch = next(make_batches(mixed_reads(text, seed=4, count=12), lanes=12))
    eng = td.DensePMLEngine(tdi, "cpu")
    codes = eng.prepare(batch)
    st0 = td.initial_state(tdi, codes.shape[1], "cpu")
    slots = tdi.sigma + 1
    st, ml = td.dense_pml_scan(tdi.table, slots, codes, st0)
    h = codes.shape[0] // 2
    st1, ml1 = td.dense_pml_scan(tdi.table, slots, codes[:h], st0)
    st2, ml2 = td.dense_pml_scan(tdi.table, slots, codes[h:], st1)
    assert torch.equal(torch.cat([ml1, ml2]), ml)
    assert all(torch.equal(a, b) for a, b in zip(st, st2))


class _HighTable:
    """A transition table of n rows held as a formula, not in memory:
    rows at or past `high` go on to the next row with a match, the rows
    below go to row 0 without one."""

    def __init__(self, n: int, slots: int, high: int):
        self.n, self.slots, self.high = n, slots, high

    def entry(self, i: np.ndarray) -> np.ndarray:
        p = i // self.slots
        return np.where(p >= self.high,
                        ((p + 1) % self.n) | (1 << 31), 0) \
            .astype(np.int64).astype(np.uint32).view(np.int32)

    def __getitem__(self, idx: torch.Tensor) -> torch.Tensor:
        return torch.from_numpy(self.entry(idx.numpy()))


def test_table_index_stays_64_bit():
    """ROADMAP §3: at n*(sigma+1) >= 2^31 entries the JAX step's int32
    index p*slots + a wraps.  On a 4.7e8-row table (held as a formula)
    the port's scan walks the high rows with a match at every base.  The
    JAX scan computes a negative index there: its gather leaves the table
    (given the table's first rows; jnp.take fills out of range) and its
    matching lengths stop growing (recorded, not fixed)."""
    slots, W, lanes = 5, 6, 3
    n = (1 << 31) // slots + 40_000_000    # ~4.7e8 rows, 2.3e9 entries
    high = n - 100
    table = _HighTable(n, slots, high)
    codes = torch.tensor([[0, 2, 4]] * W, dtype=torch.uint8)
    st0 = (torch.full((lanes,), high, dtype=torch.int32),
           torch.zeros(lanes, dtype=torch.int32))
    (p, _), ml = td.dense_pml_scan_plain(table, slots, codes, st0)
    assert ml.tolist() == [[t + 1] * lanes for t in range(W)]
    assert p.tolist() == [high + W] * lanes

    # JAX on the same automaton's first 2^20 entries (the 2.3e9 would
    # not fit this host) from the same start
    first = jnp.asarray(table.entry(np.arange(1 << 20)))
    jdi = jd.DenseIndex(n=n, sigma=slots - 1, table=first, start_pos=high,
                        alphamap_query=np.zeros(256, np.int32))
    key = np.int64(high) * slots + 2
    assert key >= 2**31                    # the index JAX computes wraps
    jml = np.asarray(jd._dense_pml_scan(jdi, jnp.asarray(
        codes.numpy().astype(np.int32))))
    assert jml.tolist() != ml.tolist()
    assert jml.max() < W
