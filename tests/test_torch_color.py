"""One-step Movi Color port (movi_tpu_torch/engine/fused_color.py) against
the JAX engine and the scalar ColorEngine, on the CPU.  Every comparison
is exact (int32 streams and CSV strings)."""

import numpy as np
import pytest
import torch

from movi_tpu.color import ColorEngine, ColorTable, compress_color_table
from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused_color as jfc
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.convert import fused_color_index_from_jax
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused_color as tfc
from movi_tpu_torch.testing import ACGT, early_stop_reads, small_color_index

# the config matrix of tests/test_fused_color.py
CONFIGS = [dict(), dict(min_match_len=3), dict(report_all=True),
           dict(report_all=True, min_diff_frac=0.5),
           dict(report_all=True, min_score_frac=0.1),
           dict(pvalue_scoring=True),
           dict(pvalue_scoring=True, report_all=True, min_score_frac=0.05)]


@pytest.fixture(scope="module")
def setup():
    docs, ix, ct, reads = small_color_index()
    tables = {"full": ct, "compressed": compress_color_table(ct, take=3)}
    return dict(ix=ix, tables=tables, reads=reads,
                es_reads=reads + early_stop_reads(reads),
                jfi=jf.build_fused_index(ix), tfi=tf.build_fused_index(ix),
                oracle={})


def _oracle(setup, table, reads_key, cfg):
    """ColorEngine's (pmls, cell, colors) per read, cached per case."""
    key = (table, reads_key, tuple(sorted(cfg.items())))
    if key not in setup["oracle"]:
        sc = ColorEngine(setup["ix"], setup["tables"][table],
                         report_colors=True, **cfg)
        out = []
        for _, seq in setup[reads_key]:
            pmls, cell = sc.query_pml_multiclass(seq)
            out.append((pmls, cell, list(sc.last_colors)))
        setup["oracle"][key] = out
    return setup["oracle"][key]


def _indexes(setup, table, layout):
    """The JAX and port color indexes of one table, in one layout (the
    fallback drops the 3-word records in both)."""
    ct = setup["tables"][table]
    jci = jfc.build_fused_color_index(setup["ix"], ct, fi=setup["jfi"])
    tci = tfc.build_fused_color_index(setup["ix"], ct, fi=setup["tfi"])
    if layout == "fallback":
        jci = jfc.FusedColorIndex(fi=jci.fi, doc_set_inds=jci.doc_set_inds,
                                  num_colors=jci.num_colors, records3=None)
        tci = tfc.FusedColorIndex(fi=tci.fi, doc_set_inds=tci.doc_set_inds,
                                  num_colors=tci.num_colors, records3=None)
    return jci, tci


@pytest.mark.parametrize("table", ["full", "compressed"])
def test_records3_byte_identical(setup, table):
    jci, tci = _indexes(setup, table, "3-word")
    assert tci.records3.dtype == torch.int32
    assert np.array_equal(np.asarray(jci.records3), tci.records3.numpy())
    assert np.array_equal(np.asarray(jci.doc_set_inds),
                          tci.doc_set_inds.numpy())
    assert tci.num_colors == jci.num_colors
    conv = fused_color_index_from_jax(jci)
    assert torch.equal(conv.records3, tci.records3)
    assert torch.equal(conv.doc_set_inds, tci.doc_set_inds)
    assert torch.equal(conv.fi.records, tci.fi.records)


def test_no_records3_past_16_bit_color_ids(setup):
    """With 2^16-1 kept sets (C+1 past 0xFFFF) neither package builds the
    3-word records; the converter carries the None."""
    ct = setup["tables"]["full"]
    pad = [np.array([0], np.uint16)] * (0xFFFF - len(ct.unique_doc_sets))
    wide = ColorTable(doc_pats=None, doc_set_inds=ct.doc_set_inds,
                      unique_doc_sets=ct.unique_doc_sets + pad,
                      doc_info=ct.doc_info)
    jci = jfc.build_fused_color_index(setup["ix"], wide, fi=setup["jfi"])
    tci = tfc.build_fused_color_index(setup["ix"], wide, fi=setup["tfi"])
    assert jci.records3 is None and tci.records3 is None
    assert tci.num_colors == 0xFFFF
    assert fused_color_index_from_jax(jci).records3 is None


CASES = ([(layout, "full", "reads", cfg) for layout in ("3-word", "fallback")
          for cfg in CONFIGS]
         + [(layout, "compressed", "reads", cfg)
            for layout in ("3-word", "fallback")
            for cfg in (dict(), dict(report_all=True, min_score_frac=0.1))]
         + [(layout, "full", "es_reads", dict(early_stop=True))
            for layout in ("3-word", "fallback")])


@pytest.mark.parametrize("layout,table,reads_key,cfg", CASES)
def test_query_batch_equals_jax_and_scalar(setup, layout, table, reads_key,
                                           cfg):
    """pmls, CSV cell and --report-colors stream of every read equal the
    JAX FusedColorEngine's and ColorEngine's."""
    ct = setup["tables"][table]
    reads = setup[reads_key]
    jci, tci = _indexes(setup, table, layout)
    batch = next(make_batches(reads, lanes=len(reads)))
    want_jax = jfc.FusedColorEngine(jci, ct, **cfg).query_batch(batch)
    got = tfc.FusedColorEngine(tci, ct, "cpu", **cfg).query_batch(batch)
    oracle = _oracle(setup, table, reads_key, cfg)
    for i, (name, _) in enumerate(reads):
        gp, gc, gcol = got[i]
        assert (gp, gc, gcol) == tuple(want_jax[i]), name
        assert (gp, gc, gcol) == oracle[i], name


@pytest.mark.parametrize("early_stop", [False, True])
def test_fallback_equals_three_word(setup, early_stop):
    """The two-load form (PML record, then doc_set_inds[new_idx]) emits
    the 3-word form's ml, color ids and state over the whole batch."""
    _, tci = _indexes(setup, "full", "3-word")
    reads = setup["es_reads"]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    eng = tfc.FusedColorEngine(tci, setup["tables"]["full"], "cpu",
                               early_stop=early_stop)
    records, slots, pd, codes, state, cids, lens = eng.scan_args(batch)
    assert cids is None
    st3, ml3, cid3 = tfc.fused_color_scan(records, slots, pd, codes, state,
                                          None, lens)
    st2, ml2, cid2 = tfc.fused_color_scan(tci.fi.records, slots, pd, codes,
                                          state, tci.doc_set_inds, lens)
    assert torch.equal(ml2, ml3) and torch.equal(cid2, cid3)
    for a, b in zip(st2, st3):
        assert torch.equal(a, b)


@pytest.mark.parametrize("layout", ["3-word", "fallback"])
@pytest.mark.parametrize("early_stop", [False, True])
def test_split_scan_equals_one_pass(setup, layout, early_stop):
    """A scan in carried pieces (state, csum, stop and the global step t0
    passed on) gives the ml, color ids and state of one pass."""
    _, tci = _indexes(setup, "full", layout)
    reads = setup["es_reads"]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    eng = tfc.FusedColorEngine(tci, setup["tables"]["full"], "cpu",
                               early_stop=early_stop)
    records, slots, pd, codes, state, cids, lens = eng.scan_args(batch)
    st_one, ml_one, cid_one = tfc.fused_color_scan(records, slots, pd,
                                                   codes, state, cids, lens)
    if early_stop:
        assert int((st_one[4] > 0).sum()) >= 1  # a lane retired
    st, mls, cids_out = state, [], []
    cuts = [0, 101, 150, 151, 290, codes.shape[0]]
    for c0, c1 in zip(cuts, cuts[1:]):
        st, ml, cid = tfc.fused_color_scan(records, slots, pd, codes[c0:c1],
                                           st, cids, lens, t0=c0)
        mls.append(ml)
        cids_out.append(cid)
    assert torch.equal(torch.cat(mls), ml_one)
    assert torch.equal(torch.cat(cids_out), cid_one)
    for a, b in zip(st, st_one):
        assert torch.equal(a, b)


def test_long_reads_retire_early(setup):
    """Random reads of 6,656 bases stop just past their midpoint: the
    lanes leave the scan there (last_scanned_rows < L) and the output
    equals the JAX engine's and ColorEngine's."""
    rng = np.random.default_rng(123)
    L = 3 * 2048 + 512
    reads = [(f"u{i}", rng.choice(ACGT, size=L).tobytes()) for i in range(5)]
    ct = setup["tables"]["full"]
    jci, tci = _indexes(setup, "full", "3-word")
    batch = next(make_batches(reads, lanes=len(reads)))
    eng = tfc.FusedColorEngine(tci, ct, "cpu", early_stop=True)
    got = eng.query_batch(batch)
    assert eng.last_scanned_rows < L
    want = jfc.FusedColorEngine(jci, ct, early_stop=True).query_batch(batch)
    sc = ColorEngine(setup["ix"], ct, report_colors=True, early_stop=True)
    for (name, seq), g, w in zip(reads, got, want):
        pmls, cell = sc.query_pml_multiclass(seq)
        assert len(g[0]) < L
        assert tuple(g) == tuple(w) == (pmls, cell, sc.last_colors), name


def _rule_stop(pmls: np.ndarray) -> int:
    """Bases processed under the port's in-scan rule (es_update), as a
    vectorised pass over one read's whole stream."""
    L = len(pmls)
    ml = torch.from_numpy(pmls.astype(np.int32))
    csum_prev = torch.cumsum(ml.to(torch.int64), 0) - ml
    _, hit = tfc.es_update(csum_prev, torch.ones(L, dtype=torch.bool), ml,
                           torch.arange(L), torch.full((L,), L))
    hits = torch.nonzero(hit).flatten()
    return int(hits[0]) + 1 if len(hits) else L


def test_early_stop_rule_holds_past_int32_csum():
    """The port's rule keeps csum in 64 bits and equals the host rule
    _early_stop_len, where the JAX in-scan check (int32) wraps: an exact
    match of 70,000 bases (PML t+1 at step t) never stops, though 5*csum
    passes 2^31 at every checkpoint."""
    L = 70_000
    exact = np.arange(1, L + 1, dtype=np.int64)
    rng = np.random.default_rng(3)
    streams = [exact, rng.integers(0, 4, size=L),
               np.concatenate([rng.integers(0, 3, size=L // 2),
                               np.arange(1, L - L // 2 + 1)])]
    for pmls in streams:
        want = jfc._early_stop_len(pmls, L)
        assert tfc.early_stop_len(pmls, L) == want
        assert _rule_stop(pmls) == want
    assert _rule_stop(exact) == L
    # the JAX in-scan check on the same stream, for the record: its int32
    # csum wraps and would retire the lane at the first checkpoint
    import jax.numpy as jnp

    csum = jnp.cumsum(jnp.asarray(exact, jnp.int32))
    t = jnp.arange(L, dtype=jnp.int32)
    _, stopped = jfc._es_check(csum - jnp.asarray(exact, jnp.int32),
                               jnp.zeros(L, bool), jnp.asarray(exact,
                                                               jnp.int32),
                               t, jnp.full(L, L, jnp.int32))
    assert bool(stopped.any())
