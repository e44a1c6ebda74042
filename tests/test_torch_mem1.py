"""MEM v1 port (movi_tpu_torch/engine/fused_mem.py) against the JAX
package on the CPU: the table byte for byte (with pos2rba and, with
POS2RUN_MAX_N at 0 in both packages, without it), the plain BML and
all-MEMs machines register for register after the same ticks on the JAX
table (convert.fused_mem_index_from_jax), and the engines against the
JAX engines and the oracle (AdvancedEngine.query_mems, query_all_mems)
on the cases of tests/test_fused_mem.py, in both reposition forms.  On
reads with '#' and on an index whose first run is longer than one row
the port equals the oracle where the JAX engines do not (ROADMAP §3.9,
§3.10); those JAX mismatches are recorded, not asserted.  Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_mem as jfm
from movi_tpu.engine.fused_search import _init_interval_oh
from movi_tpu.io.fastx import make_batches as jax_batches
from movi_tpu_torch.convert import fused_mem_index_from_jax
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_mem as tfm
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import mem_reads, random_text, rc_index

FORMS = ["pos2rba", "search"]


@pytest.fixture(scope="module")
def setup():
    """The index of tests/test_fused_mem.py (4,000 random bases from
    default_rng(7) and their reverse complement) and its oracle."""
    fw, ix = rc_index(4000, 7)
    return dict(fw=fw, ix=ix, oracle=AdvancedEngine(ix, ftab_k=0))


def _tables(ix, monkeypatch, form):
    """The JAX table in `form` (POS2RUN_MAX_N at 0 in both packages for
    the binary search) and the port's copy of it."""
    if form == "search":
        monkeypatch.setattr(jfm, "POS2RUN_MAX_N", 0)
        monkeypatch.setattr(tfm, "POS2RUN_MAX_N", 0)
    jmi = jfm.build_fused_mem_index(ix)
    return jmi, fused_mem_index_from_jax(jmi)


@pytest.mark.parametrize("form", FORMS)
def test_table_byte_identical(setup, monkeypatch, form):
    """The port's builder writes JAX's bytes: search records, init rows,
    all_p, skip rows and pos2rba (np.repeat of the runs), or no pos2rba
    past POS2RUN_MAX_N; the converted JAX table equals it too."""
    ix = setup["ix"]
    jmi, conv = _tables(ix, monkeypatch, form)
    got = tfm.build_fused_mem_index(ix, "cpu")
    n = int(ix.all_p[-1])
    assert got.n == conv.n == n
    for t in (got, conv):
        assert t.si.rec_all.dtype == torch.int32
        assert np.array_equal(t.si.rec_all.numpy(), np.asarray(jmi.si.rec_all))
        assert np.array_equal(t.si.init_rec.numpy(),
                              np.asarray(jmi.si.init_rec))
        assert np.array_equal(t.all_p64.numpy(), np.asarray(jmi.all_p64))
        assert t.skip_rec.shape == (ix.sigma * ix.r, 2)
        assert np.array_equal(t.skip_rec.numpy(), np.asarray(jmi.skip_rec))
        assert np.array_equal(t.si.alphamap_query, jmi.si.alphamap_query)
    if form == "search":
        assert jmi.pos2rba is None and got.pos2rba is None
        assert conv.pos2rba is None
        return
    runs = np.repeat(np.arange(ix.r), ix.n_arr)
    want = np.stack([runs, ix.all_p[:-1][runs]], axis=1).astype(np.int32)
    for t in (got, conv):
        assert t.pos2rba.dtype == torch.int32
        assert t.pos2rba.numpy().tobytes() == want.tobytes()
    assert np.asarray(jmi.pos2rba).tobytes() == want.tobytes()


def _batch_inputs(tmi, reads, L=0):
    """(batch, the engine's int8 slots, the state before entry) of one
    batch of reads."""
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    eng = (tfm.FusedMemEngine(tmi, L, "cpu") if L
           else tfm.FusedAllMemEngine(tmi, "cpu"))
    al8, state, _ = eng.prepare(batch)
    return batch, al8, state


def _reads(setup, seed, n=24):
    """Reads with N's (no '#'), and the short and all-N reads."""
    reads = mem_reads(np.random.default_rng(seed), setup["fw"], n,
                      with_n=True)
    return reads + [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]


def _equal_states(got, want, keys):
    assert set(got) == set(want) == set(keys) | {"ends", "counts"}
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("L,ticks", [(12, 37), (2, 300), (20, 90),
                                     (12, 2000)])
def test_mem_ticks_equal_jax(setup, monkeypatch, form, L, ticks):
    """Every register and the emissions after `ticks` lockstep ticks
    equal _mem_scan's on the same table, and each lane's ticks and bytes
    are what its kernel thread would count."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, form)
    batch, al8, state = _batch_inputs(tmi, _reads(setup, 11), L)
    assert bool((state["phase"] == -1).all())
    jstate = jfm.make_mem_state(batch.lanes, batch.width,
                                jnp.asarray(batch.lengths, jnp.int32), L)
    want, _ = jfm._mem_scan(jmi, jnp.asarray(al8.numpy(), jnp.int32),
                            jstate, L, ticks)
    got, (nticks, nbytes, _) = tfm.mem_ticks_plain(tmi, al8, state, L,
                                                   ticks)
    _equal_states(got, want, tfm.MEM1_STATE_KEYS)
    assert int(nticks.max()) <= ticks
    assert bool((nticks[got["phase"] != tfm.DONE] == ticks).all())
    # a tick loads at most a step, an extension's rows and repositions
    # (a directory pair, all_p[dir[k]] and at most b + 1 halvings each),
    # and an emission's count
    reposition = 8 if form == "pos2rba" else 12 + 4 * (tmi.dir_shift + 1)
    assert bool((nbytes <= nticks * (32 + 28 + 2 * reposition + 8)).all())
    assert int(nbytes.sum()) > 0


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("ticks", [29, 3000])
def test_all_mem_ticks_equal_jax(setup, monkeypatch, form, ticks):
    """The start state the machine builds (0 ticks) equals
    FusedAllMemEngine's (init_bidirectional at the first char, RIGHT
    unless the read is empty), and every register and emission after
    `ticks` lockstep ticks equals _all_mem_scan's."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, form)
    batch, al8, state = _batch_inputs(tmi, _reads(setup, 12))
    start, _ = tfm.all_mem_ticks_plain(tmi, al8, state, 0)
    c0 = jnp.asarray(al8.numpy()[:, 0], jnp.int32)
    legal = c0 >= 0
    c0r = jnp.where(legal, 3 - c0, jnp.where(c0 == -1, 0, -1))
    want0 = [jnp.where(ok, v, e) for c, ok in ((c0, legal), (c0r, c0r >= 0))
             for v, e in zip(_init_interval_oh(jmi.si, c), (1, 0, 0, 0))]
    lanes = batch.lanes
    want0 = [np.where(batch.lengths > 0, jfm.AM_RIGHT, jfm.AM_DONE),
             np.zeros(lanes), np.ones(lanes), np.zeros(lanes)] + want0
    for key, w in zip(tfm.AM1_STATE_KEYS, want0):
        assert np.array_equal(start[key].numpy(), np.asarray(w)), key
    jstate = {key: jnp.asarray(v.numpy()) for key, v in start.items()}
    want, _ = jfm._all_mem_scan(jmi, jnp.asarray(al8.numpy(), jnp.int32),
                                ticks, jstate)
    got, (nticks, nbytes, _) = tfm.all_mem_ticks_plain(tmi, al8, state,
                                                       ticks)
    _equal_states(got, want, tfm.AM1_STATE_KEYS)
    assert int(nticks.max()) <= ticks and int(nbytes.sum()) > 0


def _port(tmi, L, reads):
    eng = (tfm.FusedMemEngine(tmi, L, "cpu") if L
           else tfm.FusedAllMemEngine(tmi, "cpu"))
    got = []
    for b in make_batches(reads, lanes=len(reads), bucket_widths=False):
        got.extend(eng.query_batch(b))
    return got


def _jax(jmi, L, reads):
    eng = jfm.FusedMemEngine(jmi, L) if L else jfm.FusedAllMemEngine(jmi)
    return eng.query_batch(next(jax_batches(reads, lanes=len(reads))))


def _oracle(oracle, L, reads):
    return [oracle.query_mems(s, L) if L else oracle.query_all_mems(s)
            for _, s in reads]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("L", [0, 2, 5, 12, 20])
def test_engines_equal_jax_and_oracle(setup, monkeypatch, form, L):
    """tests/test_fused_mem.py's cases: 30 reads with 5% substitutions
    (BML at L 2, 5, 12, 20; all-MEMs with N's too)."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, form)
    rng = np.random.default_rng(100 + L)
    reads = mem_reads(rng, setup["fw"], 30)
    if not L:
        reads += mem_reads(rng, setup["fw"], 8, with_n=True, prefix="n")
        reads += [("tiny", b"ACG"), ("one", b"A")]
    want = _oracle(setup["oracle"], L, reads)
    assert _port(tmi, L, reads) == want
    assert _jax(jmi, L, reads) == want
    assert sum(len(m) for m in want) > len(reads)


@pytest.mark.parametrize("form", FORMS)
def test_edge_reads_equal_jax_and_oracle(setup, monkeypatch, form):
    """tests/test_fused_mem.py:57-71: reads with N's, "ACG", "A" and
    twelve N's, at L 2 and 7, and all-MEMs; and three reads past 512
    bases (the JAX machines' gathered char select)."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, form)
    rng = np.random.default_rng(57)
    reads = mem_reads(rng, setup["fw"], 15, with_n=True)
    reads += [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]
    for L in (2, 7, 0):
        want = _oracle(setup["oracle"], L, reads)
        assert _port(tmi, L, reads) == want, L
        assert _jax(jmi, L, reads) == want, L
    longs = mem_reads(rng, setup["fw"], 3, err=0.03, prefix="L",
                      lengths=(530, 700))
    for L in (15, 0):
        want = _oracle(setup["oracle"], L, longs)
        assert _port(tmi, L, longs) == want, L
        assert _jax(jmi, L, longs) == want, L


def _hash_reads(fw, seed=5):
    """16 reads of 30-80 bases from the text, each with one '#'."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(16):
        L = int(rng.integers(30, 80))
        s = int(rng.integers(0, len(fw) - L))
        seq = fw[s:s + L].copy()
        seq[int(rng.integers(0, L))] = ord("#")
        reads.append((f"h{i}", seq.tobytes()))
    return reads


@pytest.mark.parametrize("form", FORMS)
def test_hash_reads_equal_oracle(setup, monkeypatch, record_property, form):
    """ROADMAP §3.9: a '#' inside a read is part of it.  The JAX v1
    machines count a read's length as its slots > -2, which drops each
    '#' (-3), so a MEM that runs to the read's end stops one position
    short.  The port counts slots != -2 and equals the oracle; the JAX
    engines' mismatches are recorded, not asserted."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, form)
    reads = _hash_reads(setup["fw"])
    wrong = {}
    for L in (0, 12):
        want = _oracle(setup["oracle"], L, reads)
        assert _port(tmi, L, reads) == want, L
        wrong[L] = sum(g != w for g, w in zip(_jax(jmi, L, reads), want))
    record_property("jax_all_mems_reads_wrong", wrong[0])
    record_property("jax_bml12_reads_wrong", wrong[12])
    print(f"{form}: the JAX v1 engines get {wrong[0]} (all-MEMs) and "
          f"{wrong[12]} (BML, L = 12) of {len(reads)} '#' reads wrong")


def test_empty_fw_count_first_run_longer_than_one(record_property):
    """ROADMAP §3.10: an all-MEMs emission whose forward interval is the
    canonical empty one (a read starting with N) counts 0, as the oracle
    does; the JAX machine counts 1 - n_arr[0], which is visible only
    when the first BWT run is longer than one row.  Recorded, not
    asserted."""
    _, ix = rc_index(50, 13)
    assert int(ix.n_arr[0]) > 1, "fixture must have a long first run"
    fw = random_text(50, 13)
    reads = [("n", b"N"), ("nn", b"NN"), ("mix", b"N" + fw[:9].tobytes()),
             ("tail", fw[5:20].tobytes() + b"N")]
    oracle = AdvancedEngine(ix)
    jmi = jfm.build_fused_mem_index(ix)
    tmi = fused_mem_index_from_jax(jmi)
    for L in (0, 3):
        want = _oracle(oracle, L, reads)
        assert _port(tmi, L, reads) == want, L
        assert _port(tfm.build_fused_mem_index(ix, "cpu"), L, reads) == want
    jgot = _jax(jmi, 0, reads)
    wrong = sum(g != w for g, w in zip(jgot, _oracle(oracle, 0, reads)))
    record_property("jax_reads_wrong", wrong)
    print(f"the JAX all-MEMs engine gets {wrong} of {len(reads)} reads "
          f"wrong ({jgot[0]} for a lone N)")


def test_tick_cap_raises(setup, monkeypatch):
    """A lane still running at the budget raises, not a partial answer."""
    monkeypatch.setattr(tfm, "mem_tick_cap", lambda W: 5)
    tmi = tfm.build_fused_mem_index(setup["ix"], "cpu")
    reads = mem_reads(np.random.default_rng(5), setup["fw"], 4)
    for L in (12, 0):
        with pytest.raises(RuntimeError, match="did not converge"):
            _port(tmi, L, reads)
