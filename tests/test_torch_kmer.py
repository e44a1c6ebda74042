"""K-mer port (movi_tpu_torch/engine/fused_kmer.py, the k-mer parts of
fused_search2.py, the builders and prep of fused_mem2.py) against the JAX
package on the CPU: the ftab anchor rows and search tables byte for
byte, and each plain kernel twin (the batch prep, the membership machine's
state after a number of ticks, the two exact-count scans) against the JAX
function it ports.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.build.prepare_ref import revcomp
from movi_tpu.engine import fused_kmer as jk
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu.engine import fused_search as js
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.convert import fused_search_index_from_jax
from movi_tpu_torch.engine import fused_kmer as tk
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import ACGT, index_from_text, kmer_reads


@pytest.fixture(scope="module")
def indexes():
    """The two indexes of tests/test_fused_kmer.py: 2,500 random bases
    with their reverse complement (seed 9), and 2,500 forward-only bases
    (seed 31)."""
    fw = np.random.default_rng(9).choice(ACGT, size=2500).astype(np.uint8)
    rc_text = np.concatenate([fw, revcomp(fw)])
    fw_text = np.random.default_rng(31).choice(ACGT, size=2500)
    return {"rc": (rc_text, index_from_text(rc_text)),
            "fw": (fw_text, index_from_text(fw_text))}


@pytest.fixture(scope="module")
def batch(indexes):
    """Probe-heavy reads on the rc index: random, half-matching and exact
    ones with N's, reads shorter than k and a few past 512 bases."""
    text, _ = indexes["rc"]
    return next(make_batches(kmer_reads(text, seed=3), lanes=64,
                             bucket_widths=False))


@pytest.mark.parametrize("name,fk", [("rc", 4), ("rc", 6), ("fw", 4),
                                     ("fw", 6)])
def test_ftab_rows_and_search_table_byte_identical(indexes, name, fk):
    """build_ftab_rows (both rc_merge settings) and the search table with
    the appended anchor rows equal the JAX builders' bytes."""
    _, ix = indexes[name]
    for merge in (True, False):
        want = jm2.build_ftab_rows(ix, fk, rc_merge=merge)
        got = tm2.build_ftab_rows(ix, fk, rc_merge=merge)
        assert got.dtype == want.dtype == np.int32
        assert np.array_equal(got, want), merge
    jsi = js.build_fused_search_index(ix, ftab_k=fk)
    tsi = ts.build_fused_search_index(ix, ftab_k=fk)
    assert tsi.ftab_k == jsi.ftab_k == fk
    assert tsi.rec_all.shape == (2 * ix.sigma * ix.r + 4 ** fk, 4)
    assert np.array_equal(np.asarray(jsi.rec_all), tsi.rec_all.numpy())
    # the forward-only index keeps rows whose reverse complement is absent
    rows = tsi.rec_all[2 * ix.sigma * ix.r:]
    assert int((rows[:, 0] != 1).sum()) > 0


def test_looks_rc_closed_equals_jax(indexes):
    assert tm2.looks_rc_closed(indexes["rc"][1])
    assert not tm2.looks_rc_closed(indexes["fw"][1])
    two_docs = index_from_text(np.concatenate(
        [indexes["fw"][0], revcomp(indexes["fw"][0]),
         indexes["rc"][0][:1000], revcomp(indexes["rc"][0][:1000])]))
    for _, ix in [*indexes.values(), (None, two_docs)]:
        assert tm2.looks_rc_closed(ix) == jm2.looks_rc_closed(ix)
        assert tm2.mem2_supported(ix) == jm2.mem2_supported(ix)
    assert tm2.MEM2_MAX_N == jm2.MEM2_MAX_N


def _slots8(indexes, batch):
    _, ix = indexes["rc"]
    al = tk.left_aligned_slots(batch, ts.search_alphamap(ix), fill=-1)
    return al.astype(np.int8)


@pytest.mark.parametrize("fk", [0, 4, 6, 10])
def test_prep_alc_equals_jax(indexes, batch, fk):
    al8 = _slots8(indexes, batch)
    want = np.asarray(jm2._prep_alc(jnp.asarray(al8), fk, fk > 0))
    got = tm2.prep_alc(torch.from_numpy(al8), fk)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def _machine(indexes, batch, fk, k):
    """(JAX index, port index, alc, start state) for the membership
    machine on the rc index."""
    _, ix = indexes["rc"]
    jsi = js.build_fused_search_index(ix, ftab_k=fk)
    tsi = ts.build_fused_search_index(ix, ftab_k=fk)
    use_ftab = 1 < fk <= k - k // 3
    alc = tm2.prep_alc(torch.from_numpy(_slots8(indexes, batch)),
                       fk if use_ftab else 0)
    state = tk.make_kmer_state(batch.lanes, batch.width,
                               torch.from_numpy(batch.lengths), k)
    return jsi, tsi, alc, state, use_ftab


@pytest.mark.parametrize("fk,k,ticks", [(0, 11, 37), (6, 11, 37),
                                        (0, 21, 300), (6, 15, 900)])
def test_kmer_scan_state_equals_jax(indexes, batch, fk, k, ticks):
    """The plain machine's every register and its emissions after `ticks`
    lockstep ticks equal _kmer_scan's, ftab anchors off and on."""
    jsi, tsi, alc, state, use_ftab = _machine(indexes, batch, fk, k)
    assert use_ftab == (fk > 0)
    jstate = {key: jnp.asarray(v.numpy()) for key, v in state.items()}
    want, _ = jk._kmer_scan(jsi, jnp.asarray(alc.numpy()), jstate, k, ticks,
                            use_ftab)
    got, work = tk.kmer_scan(tsi, alc, state, k, ticks, use_ftab)
    assert set(got) == set(want)
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    nticks, rows, steps = work
    assert int(nticks.max()) <= ticks
    assert bool((nticks[got["phase"] != tk.DONE] == ticks).all())
    assert bool((rows <= 2 * nticks).all()) and int(rows.sum()) > 0
    # a step loads two rows, an ftab anchor one
    assert bool((2 * steps <= rows).all()) and int(steps.sum()) > 0
    assert bool((rows - 2 * steps <= nticks - steps).all())
    assert use_ftab or torch.equal(rows, 2 * steps)


@pytest.mark.parametrize("fk", [0, 6])
def test_kmer_scan_split_equals_one_pass(indexes, batch, fk):
    """A run split in two (the second from the first's state) equals one
    pass to the end, and the ticks and rows of each lane add up."""
    k = 15
    _, tsi, alc, state, use_ftab = _machine(indexes, batch, fk, k)
    cap = tk.tick_cap(k, batch.width)
    one, n_one = tk.kmer_scan(tsi, alc, state, k, cap, use_ftab)
    assert bool((one["phase"] == tk.DONE).all())
    half, n1 = tk.kmer_scan(tsi, alc, state, k, 53, use_ftab)
    two, n2 = tk.kmer_scan(tsi, alc, half, k, cap, use_ftab)
    for key in one:
        assert torch.equal(two[key], one[key]), key
    assert torch.equal(n1 + n2, n_one)
    assert int(n_one[0].max()) > 53


@pytest.mark.parametrize("layout,k", [("one-step", 8), ("one-step", 15),
                                      ("one-step", 31), ("paired", 8),
                                      ("paired", 15), ("paired", 31)])
def test_kmer_count_scans_equal_jax(indexes, batch, layout, k):
    """kmer_count_scan_plain vs _kmer_count_scan and
    fused2_kmer_count_scan_plain vs fused2_kmer_count_scan over every
    window of the batch (N's included), k odd and even; the dispatchers'
    (lane, start) form gives the same."""
    _, ix = indexes["rc"]
    al, own = tk.batch_kmer_windows(batch, ts.search_alphamap(ix), k)
    if layout == "one-step":
        jidx = js.build_fused_search_index(ix)
        want = jk._kmer_count_scan(jidx, jnp.asarray(al), k)
        t = ts.build_fused_search_index(ix)
        got = tk.kmer_count_scan_plain(t.rec_all, t.init_rec, t.all_p, t.r,
                                       t.sigma, torch.from_numpy(al), k)
        scan = tk.kmer_count_scan
    else:
        jidx = js2.build_fused_search2_index(ix)
        want = js2.fused2_kmer_count_scan(jidx, jnp.asarray(al), k)
        t = ts2.build_fused_search2_index(ix, "cpu")
        got = ts2.fused2_kmer_count_scan_plain(t.rec_all, t.init_rec,
                                               t.all_p, t.r, t.sigma,
                                               torch.from_numpy(al), k)
        scan = ts2.fused2_kmer_count_scan
    assert got[0].dtype == torch.bool and got[1].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(got[0].sum()) < len(own)
    found = tk.kmer_starts(batch, ts.search_alphamap(ix), k)
    slots, lane, start = (torch.from_numpy(x.astype(d)) for x, d in
                          zip(found, (np.int8, np.int32, np.int32)))
    assert torch.equal(tk.kmer_windows(slots, lane, start, k),
                       torch.from_numpy(al))
    for g, w in zip(scan(t, slots, lane, start, k), got):
        assert torch.equal(g, w)


def test_batch_kmer_windows_equal_jax(indexes, batch):
    _, ix = indexes["rc"]
    amap = ts.search_alphamap(ix)
    for k in (1, 9, 31, batch.width, batch.width + 1):
        want = jk.batch_kmer_windows(batch, amap, k)
        got = tk.batch_kmer_windows(batch, amap, k)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                assert g.dtype == w.dtype and np.array_equal(g, w)


def test_convert_carries_ftab_rows(indexes, batch):
    """fused_search_index_from_jax keeps ftab_k and the anchor rows; the
    converted index drives the port's membership engine to the JAX
    engine's answers."""
    _, ix = indexes["rc"]
    jsi = js.build_fused_search_index(ix, ftab_k=6)
    conv = fused_search_index_from_jax(jsi)
    assert conv.ftab_k == 6
    assert torch.equal(conv.rec_all, ts.build_fused_search_index(ix, 6)
                       .rec_all)
    assert (tk.FusedKmerEngine(conv, 15, "cpu").query_batch(batch)
            == jk.FusedKmerEngine(jsi, 15).query_batch(batch))
