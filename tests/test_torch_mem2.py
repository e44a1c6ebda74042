"""MEM v2 port (movi_tpu_torch/engine/fused_mem2.py) against the JAX
package on the CPU: the combined table byte for byte (the ftab rows
against build_ftab_rows(rc_merge=False)), the step helpers, and the plain
BML and all-MEMs machines register for register after the same ticks;
the engines against the oracle, AdvancedEngine.query_mems and
query_all_mems, on the cases of tests/test_fused_mem2.py and on reads
that span a document junction (ROADMAP §3.1).  Every comparison is
exact."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
from movi_tpu_torch.testing import (junction_index, junction_reads,
                                    mem_reads, random_text, rc_index)


@pytest.fixture(scope="module")
def setup():
    """The index of tests/test_fused_mem2.py's module fixture (4,000
    random bases and their reverse complement, seed 7), its oracle, the
    port's table (ftab 0) and the JAX one."""
    fw, ix = rc_index(4000, 7)
    return dict(fw=fw, ix=ix, oracle=AdvancedEngine(ix, ftab_k=0),
                t0=tm2.build_fused_mem2_index(ix),
                j0=jm2.build_fused_mem2_index(ix))


def _jax_twin(jidx, tidx):
    """The JAX index carrying the port's table (its ftab rows are built
    with rc_merge=False), so the machines are compared on one table."""
    return dataclasses.replace(jidx, rec_all=jnp.asarray(tidx.rec_all.numpy()),
                               ftab_k=tidx.ftab_k)


@pytest.mark.parametrize("fk", [0, 4, 10])
def test_table_byte_identical(setup, fk):
    ix = setup["ix"]
    want = setup["j0"] if fk == 0 else jm2.build_fused_mem2_index(ix, fk)
    got = tm2.build_fused_mem2_index(ix, fk)
    base = 2 * ix.sigma * ix.r + int(ix.all_p[-1])
    assert (got.r, got.sigma, got.n, got.ftab_k, got.p1) == \
        (want.r, want.sigma, want.n, want.ftab_k, want.p1)
    rec = got.rec_all.numpy()
    assert rec.dtype == np.int32
    assert rec.shape == (base + (4 ** fk if fk else 0), 8)
    assert np.array_equal(rec[:base], np.asarray(want.rec_all)[:base])
    if fk:
        assert np.array_equal(rec[base:],
                              jm2.build_ftab_rows(ix, fk, rc_merge=False))
    assert np.array_equal(got.init_rec6.numpy(), np.asarray(want.init_rec6))
    assert np.array_equal(got.alphamap_query, want.alphamap_query)


def test_junction_table_anchor_rows_keep_fw_only_codes():
    """On a multi-document reference the port's anchor rows keep the
    junction fk-mers whose reverse complement is absent (rc_merge=False);
    the JAX table drops them (ROADMAP §3.1)."""
    _, _, ix = junction_index()
    got = tm2.build_fused_mem2_index(ix, 6).rec_all.numpy()
    want = np.asarray(jm2.build_fused_mem2_index(ix, 6).rec_all)
    base = 2 * ix.sigma * ix.r + int(ix.all_p[-1])
    assert np.array_equal(got[:base], want[:base])
    assert np.array_equal(got[base:],
                          jm2.build_ftab_rows(ix, 6, rc_merge=False))
    assert int(got[base:, 7].sum()) > int(want[base:, 7].sum())


def test_step_helpers_equal_jax(setup):
    """mem2_step, mem2_resolve, init6 and init_pair6 on random legal and
    illegal inputs (chars -3..3, intervals and positions past the ends)."""
    t, j, ix = setup["t0"], setup["j0"], setup["ix"]
    rng = np.random.default_rng(3)
    N = 4000
    rs, re = (rng.integers(-2, ix.r + 2, size=N) for _ in range(2))
    os_, oe = (rng.integers(0, 40, size=N) for _ in range(2))
    a = rng.integers(-3, 4, size=N)
    args = [x.astype(np.int32) for x in (rs, os_, re, oe, a)]
    want = jm2.mem2_step(j, *map(jnp.asarray, args))
    got = tm2.mem2_step(t, *map(torch.from_numpy, args))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    pos = rng.integers(-5, t.n + 5, size=N).astype(np.int32)
    for g, w in zip(tm2.mem2_resolve(t, torch.from_numpy(pos)),
                    jm2.mem2_resolve(j, jnp.asarray(pos))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    c = np.arange(-3, 4, dtype=np.int32)
    for g, w in zip(tm2.init6(t, torch.from_numpy(c)),
                    jm2._init6(j, jnp.asarray(c))):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for gs, ws in zip(tm2.init_pair6(t, torch.from_numpy(c)),
                      jm2._init_pair6(j, jnp.asarray(c))):
        for g, w in zip(gs, ws):
            assert np.array_equal(g.numpy(), np.asarray(w))


def _bml_inputs(setup, fk, L, n=24, seed=11):
    """(port table, JAX twin, alc, start state, use_ftab) for a batch of
    reads with N's, short and all-N reads."""
    ix = setup["ix"]
    t = setup["t0"] if fk == 0 else tm2.build_fused_mem2_index(ix, fk)
    rng = np.random.default_rng(seed)
    reads = mem_reads(rng, setup["fw"], n, with_n=True)
    reads += [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    amap = t.alphamap_query.copy()
    amap[ord("#")] = -3
    al8 = torch.from_numpy(left_aligned_slots(batch, amap).astype(np.int8))
    use_ftab = 1 < fk <= L
    alc = tm2.prep_alc(al8, fk if use_ftab else 0)
    lengths = torch.from_numpy(batch.lengths.astype(np.int32))
    return (t, _jax_twin(setup["j0"], t), alc, batch, lengths, use_ftab,
            reads)


def _equal_states(got, want, keys):
    assert set(got) == set(want) == set(keys) | {"ends", "counts"}
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key


@pytest.mark.parametrize("fk,L,ticks", [(0, 12, 37), (0, 5, 300),
                                        (6, 12, 41), (6, 20, 400),
                                        (8, 8, 300)])
def test_mem2_scan_equals_jax(setup, fk, L, ticks):
    """Every register and the emissions after `ticks` lockstep ticks equal
    _mem2_scan's, ftab anchors off, on (BACK after the row) and covering
    the window (fk = L)."""
    t, j, alc, batch, lengths, use_ftab, _ = _bml_inputs(setup, fk, L)
    assert use_ftab == (fk > 0)
    state = tm2.entry_state(tm2.MEM2_STATE_KEYS, batch.lanes, batch.width,
                            "cpu")
    jstate = jm2.make_mem2_state(batch.lanes, batch.width,
                                 jnp.asarray(lengths.numpy()), L)
    want, _ = jm2._mem2_scan(j, jnp.asarray(alc.numpy()), jstate, L, ticks,
                             use_ftab)
    got, work = tm2.mem2_scan(t, alc, state, L, ticks, use_ftab)
    _equal_states(got, want, tm2.MEM2_STATE_KEYS)
    nticks, rows, steps = work
    assert int(nticks.max()) <= ticks
    assert bool((nticks[got["phase"] != tm2.DONE] == ticks).all())
    assert bool((rows <= 2 * nticks).all()) and int(rows.sum()) > 0
    # a step loads two rows; RESOLVE two and an ftab anchor one, no step
    assert bool((2 * steps <= rows).all()) and int(steps.sum()) > 0
    assert bool((steps <= nticks).all())


def _all_mem_inputs(setup, n=24, seed=12):
    t = setup["t0"]
    reads = mem_reads(np.random.default_rng(seed), setup["fw"], n,
                      with_n=True, prefix="am")
    reads += [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    amap = t.alphamap_query.copy()
    amap[ord("#")] = -3
    alc = tm2.prep_alc(torch.from_numpy(
        left_aligned_slots(batch, amap).astype(np.int8)), 0)
    state = tm2.entry_state(tm2.AM2_STATE_KEYS, batch.lanes, batch.width,
                            "cpu")
    return t, alc, state, reads, batch


@pytest.mark.parametrize("ticks", [29, 400])
def test_all_mem2_scan_equals_jax(setup, ticks):
    """The start state the machine builds (0 ticks) equals the JAX
    engine's, and every register and emission after `ticks` lockstep
    ticks equals _all_mem2_scan's."""
    t, alc, state, _, batch = _all_mem_inputs(setup)
    j = setup["j0"]
    start, _ = tm2.all_mem2_scan(t, alc, state, 0)
    fw, rc = jm2._init_pair6(j, jnp.asarray(alc.numpy()[:, 0]))
    lanes = batch.lanes
    want0 = (np.where(batch.lengths > 0, jm2.AM2_RIGHT, jm2.AM2_DONE),
             np.zeros(lanes), np.ones(lanes), np.zeros(lanes), *fw, *rc)
    for key, w in zip(tm2.AM2_STATE_KEYS, want0):
        assert np.array_equal(start[key].numpy(), np.asarray(w)), key
    jstate = {key: jnp.asarray(v.numpy()) for key, v in start.items()}
    want, _ = jm2._all_mem2_scan(j, jnp.asarray(alc.numpy()), ticks, jstate)
    got, work = tm2.all_mem2_scan(t, alc, state, ticks)
    _equal_states(got, want, tm2.AM2_STATE_KEYS)
    assert int(work[0].max()) <= ticks and int(work[1].sum()) > 0
    # a step loads two rows, a RES tick two more
    assert bool((2 * work[2] <= work[1]).all()) and int(work[2].sum()) > 0


@pytest.mark.parametrize("machine", ["bml", "bml-ftab", "all"])
def test_split_equals_one_pass(setup, machine):
    """A run split in two (the second from the first's state) equals one
    pass to the end, and each lane's ticks and rows add up."""
    if machine == "all":
        t, alc, state, _, batch = _all_mem_inputs(setup)
        cap = tm2.all_mem2_tick_cap(batch.width)

        def run(st, ticks):
            return tm2.all_mem2_scan(t, alc, st, ticks)
    else:
        fk = 6 if machine == "bml-ftab" else 0
        t, _, alc, batch, lengths, use_ftab, _ = _bml_inputs(setup, fk, 12)
        state = tm2.entry_state(tm2.MEM2_STATE_KEYS, batch.lanes,
                                batch.width, "cpu")
        cap = tm2.bml_tick_cap(batch.width)

        def run(st, ticks):
            return tm2.mem2_scan(t, alc, st, 12, ticks, use_ftab)
    one, w_one = run(state, cap)
    assert bool((one["phase"] == (tm2.AM2_DONE if machine == "all"
                                  else tm2.DONE)).all())
    half, w1 = run(state, 53)
    two, w2 = run(half, cap)
    for key in one:
        assert torch.equal(two[key], one[key]), key
    assert torch.equal(w1 + w2, w_one)
    assert int(w_one[0].max()) > 53


def _engine_results(eng, reads, lanes=None):
    got = []
    for b in make_batches(reads, lanes=lanes or len(reads),
                          bucket_widths=False):
        got.extend(eng.query_batch(b))
    return got


@pytest.mark.parametrize("L", [2, 5, 12, 20])
def test_mem2_engine_equals_oracle(setup, L):
    reads = mem_reads(np.random.default_rng(100 + L), setup["fw"], 30)
    got = _engine_results(tm2.FusedMem2Engine(setup["t0"], L, "cpu"), reads)
    oracle = setup["oracle"]
    assert got == [oracle.query_mems(s, L) for _, s in reads]


@pytest.mark.parametrize("fk", [4, 7, 12])
def test_mem2_engine_ftab_equals_oracle(setup, fk):
    """ftab-anchored BML for L around fk (hit, miss/BSCAN and fk >= L)."""
    t = tm2.build_fused_mem2_index(setup["ix"], fk)
    reads = mem_reads(np.random.default_rng(200 + fk), setup["fw"], 20,
                      with_n=True, prefix=f"f{fk}")
    reads += [("tiny", b"ACGTA"), ("allN", b"N" * 30)]
    oracle = setup["oracle"]
    for L in (fk, fk + 1, fk + 6, 20):
        got = _engine_results(tm2.FusedMem2Engine(t, L, "cpu"), reads)
        assert got == [oracle.query_mems(s, L) for _, s in reads], L


def test_mem2_engine_edge_and_long_reads(setup):
    """N's, reads shorter than L, an all-N read, and reads past 512
    bases (W > 512) with the ftab-6 table."""
    fw, oracle = setup["fw"], setup["oracle"]
    reads = mem_reads(np.random.default_rng(31), fw, 12, with_n=True)
    reads += [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]
    for L in (2, 7):
        got = _engine_results(tm2.FusedMem2Engine(setup["t0"], L, "cpu"),
                              reads)
        assert got == [oracle.query_mems(s, L) for _, s in reads], L
    longs = mem_reads(np.random.default_rng(32), fw, 3, err=0.03,
                      prefix="L", lengths=(530, 700))
    t6 = tm2.build_fused_mem2_index(setup["ix"], 6)
    got = _engine_results(tm2.FusedMem2Engine(t6, 15, "cpu"), longs)
    assert got == [oracle.query_mems(s, 15) for _, s in longs]


def test_all_mem2_engine_equals_oracle(setup):
    _, _, _, reads, _ = _all_mem_inputs(setup)
    got = _engine_results(tm2.FusedAllMem2Engine(setup["t0"], "cpu"), reads)
    assert got == [setup["oracle"].query_all_mems(s) for _, s in reads]


def test_all_mem2_empty_fw_count_first_run_longer_than_one():
    """The empty-fw emission count is 0 (the oracle's interval_count of
    EMPTY), visible only when the first BWT run is longer than one row;
    the skip arithmetic runs on that index too."""
    _, ix = rc_index(50, 13)
    assert int(ix.n_arr[0]) > 1, "fixture must have a long first run"
    fw = random_text(50, 13)
    reads = [("n", b"N"), ("nn", b"NN"), ("mix", b"N" + fw[:9].tobytes()),
             ("tail", fw[5:20].tobytes() + b"N")]
    t = tm2.build_fused_mem2_index(ix)
    oracle = AdvancedEngine(ix)
    got = _engine_results(tm2.FusedAllMem2Engine(t, "cpu"), reads)
    assert got == [oracle.query_all_mems(s) for _, s in reads]
    got = _engine_results(tm2.FusedMem2Engine(t, 3, "cpu"), reads)
    assert got == [oracle.query_mems(s, 3) for _, s in reads]


@pytest.mark.parametrize("fk,L", [(4, 5), (5, 12), (10, 12)])
def test_mem2_multidoc_equals_oracle(fk, L):
    """tests/test_fused_mem2.py's multi-document case: reads from inside
    the documents, the ftab anchors' rc side tracked through junctions."""
    text, _, ix = junction_index()
    reads = mem_reads(np.random.default_rng(82), text, 15, err=0.0,
                      prefix="d", lengths=(40, 100))
    got = _engine_results(tm2.FusedMem2Engine(
        tm2.build_fused_mem2_index(ix, fk), L, "cpu"), reads)
    oracle = AdvancedEngine(ix, ftab_k=0)
    assert got == [oracle.query_mems(s, L) for _, s in reads]


@pytest.mark.parametrize("L", [8, 12])
def test_mem2_junction_reads_equal_oracle(record_property, L):
    """ROADMAP §3.1: reads spanning a document junction, ftab-6.  The
    port equals the oracle; the JAX engine's mismatches (its anchors are
    built with rc_merge=True) are recorded, not asserted."""
    from movi_tpu.engine.fused_mem2 import FusedMem2Engine
    from movi_tpu.io.fastx import make_batches as jax_batches

    text, junctions, ix = junction_index()
    reads = junction_reads(text, junctions, 15)
    oracle = AdvancedEngine(ix, ftab_k=0)
    want = [oracle.query_mems(s, L) for _, s in reads]
    got = _engine_results(tm2.FusedMem2Engine(
        tm2.build_fused_mem2_index(ix, 6), L, "cpu"), reads)
    assert got == want
    jeng = FusedMem2Engine(jm2.build_fused_mem2_index(ix, 6), L)
    jgot = jeng.query_batch(next(jax_batches(reads, lanes=len(reads))))
    wrong = sum(g != w for g, w in zip(jgot, want))
    record_property("jax_reads_wrong", wrong)
    print(f"L={L}: the JAX engine gets {wrong} of {len(reads)} junction "
          f"reads wrong")


def test_engine_tick_cap_raises(setup, monkeypatch):
    """A lane still running at its budget raises, not a partial answer."""
    monkeypatch.setattr(tm2, "bml_tick_cap", lambda W: 5)
    reads = mem_reads(np.random.default_rng(5), setup["fw"], 4)
    with pytest.raises(RuntimeError, match="did not finish"):
        _engine_results(tm2.FusedMem2Engine(setup["t0"], 12, "cpu"), reads)
    monkeypatch.setattr(tm2, "all_mem2_tick_cap", lambda W: 5)
    with pytest.raises(RuntimeError, match="did not finish"):
        _engine_results(tm2.FusedAllMem2Engine(setup["t0"], "cpu"), reads)



def _hash_reads(fw, seed=5):
    """Reads with '#' (which complements to itself and never matches)
    inside them."""
    rng = np.random.default_rng(seed)
    reads = [("hash", fw[:30].tobytes() + b"#" + fw[40:60].tobytes()),
             ("hashes", b"#" + fw[100:140].tobytes() + b"##"
              + fw[300:330].tobytes() + b"N#"),
             ("one", b"#"), ("edge", b"##ACGT#")]
    for name, seq in mem_reads(rng, fw, 12, with_n=True, prefix="h"):
        a = np.frombuffer(seq, np.uint8).copy()
        a[rng.integers(0, len(a), size=2)] = ord("#")
        reads.append((name, a.tobytes()))
    return reads


def test_hash_reads_equal_oracle(setup, record_property):
    """ROADMAP §3.6: a '#' inside a read is part of it.  The JAX machines
    count a read's length as its slots > -2, which drops every '#' (-3),
    so a MEM running to the read's end stops one position short per '#'.
    The port counts slots != -2 and equals the oracle; the JAX engine's
    mismatches are recorded, not asserted."""
    from movi_tpu.engine.fused_mem2 import (FusedAllMem2Engine,
                                            FusedMem2Engine)
    from movi_tpu.io.fastx import make_batches as jax_batches

    reads = _hash_reads(setup["fw"])
    oracle = setup["oracle"]
    jb = next(jax_batches(reads, lanes=len(reads)))
    wrong = 0
    for fk, L in ((0, 2), (0, 12), (6, 12), (0, 0)):
        t = setup["t0"] if fk == 0 else tm2.build_fused_mem2_index(
            setup["ix"], fk)
        eng = (tm2.FusedMem2Engine(t, L, "cpu") if L
               else tm2.FusedAllMem2Engine(t, "cpu"))
        want = [oracle.query_mems(s, L) if L else oracle.query_all_mems(s)
                for _, s in reads]
        assert _engine_results(eng, reads) == want, (fk, L)
        j = _jax_twin(setup["j0"], t)
        jeng = FusedMem2Engine(j, L) if L else FusedAllMem2Engine(j)
        wrong += sum(g != w for g, w in zip(jeng.query_batch(jb), want))
    record_property("jax_answers_wrong", wrong)
    print(f"the JAX engines get {wrong} of {4 * len(reads)} answers wrong")
