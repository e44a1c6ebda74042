"""Paired Movi Color port (the 8-word records of
movi_tpu_torch/engine/fused2.py) against the JAX engine and the scalar
ColorEngine, on the CPU, and the color rung of engine selection.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

from movi_tpu.color import ColorEngine, ColorTable, compress_color_table
from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused2 as jf2
from movi_tpu.io.fastx import make_batches
from movi_tpu_torch.api import Index
from movi_tpu_torch.convert import fused2_color_index_from_jax
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.engine import fused_color as tfc
from movi_tpu_torch.engine import select
from movi_tpu_torch.testing import ACGT, early_stop_reads, small_color_index


@pytest.fixture(scope="module")
def setup():
    docs, ix, ct, reads = small_color_index()
    jfi = jf.build_fused_index(ix)
    tfi = tf.build_fused_index(ix)
    tables = {"full": ct, "compressed": compress_color_table(ct, take=3)}
    return dict(ix=ix, tables=tables, reads=reads, jfi=jfi, tfi=tfi,
                es_reads=reads + early_stop_reads(reads),
                j2={k: jf2.build_fused2_color_index(jfi, t)
                    for k, t in tables.items()},
                t2={k: tf2.build_fused2_color_index(tfi, t)
                    for k, t in tables.items()})


def _cids(setup, kind):
    """int32 [r] color ids: the table's (clamped), or synthetic ones up to
    0xFFFE, so that step-2 halves set bit 31."""
    ct = setup["tables"]["full"]
    if kind == "real":
        c = np.minimum(ct.doc_set_inds, len(ct.unique_doc_sets))
    else:
        c = np.random.default_rng(8).integers(1 << 15, 0xFFFF,
                                              size=setup["ix"].r)
    return c.astype(np.int32)


@pytest.mark.parametrize("kind", ["real", "synthetic"])
@pytest.mark.parametrize("chunked", [False, True])
def test_color_compose_byte_identical(setup, kind, chunked):
    """The 8-word table equals the JAX compose's, single-shot and in
    chunks that neither divide nor align to r (with the overlapping last
    chunk), for real color ids and for ids past 2^15."""
    tfi = setup["tfi"]
    r, slots = tfi.r, tfi.sigma + 1
    ch = r // 3 - 1 if chunked else r
    cids = _cids(setup, kind)
    want, want_b = jf2.compose_records(setup["jfi"].records, r=r,
                                       slots=slots, p_dollar=tfi.p_dollar,
                                       cids=np.asarray(cids),
                                       chunk_runs=ch)
    got, got_b = tf2.compose_records(tfi.records, r, slots, tfi.p_dollar,
                                     torch.from_numpy(cids), chunk_runs=ch)
    assert got.shape == (r * slots * slots, 8) and got.dtype == torch.int32
    assert got_b == want_b
    assert np.array_equal(np.asarray(want), got.numpy())
    if kind == "synthetic":
        assert int((got[:, 5] < 0).sum()) > 0  # bit 31 in use
    pml, _ = tf2.compose_records(tfi.records, r, slots, tfi.p_dollar,
                                 chunk_runs=ch)
    assert torch.equal(got[:, :4], pml)  # words 0-3 are the PML record


def test_color_index_and_converter(setup):
    j2, t2 = setup["j2"]["full"], setup["t2"]["full"]
    assert np.array_equal(np.asarray(j2.f2.records), t2.f2.records.numpy())
    assert t2.num_colors == j2.num_colors
    conv = fused2_color_index_from_jax(j2)
    assert torch.equal(conv.f2.records, t2.f2.records)
    assert conv.f2.p_dollar == t2.f2.p_dollar


CONFIGS = [dict(), dict(min_match_len=3), dict(report_all=True),
           dict(report_all=True, min_diff_frac=0.5),
           dict(report_all=True, min_score_frac=0.1),
           dict(pvalue_scoring=True),
           dict(pvalue_scoring=True, report_all=True, min_score_frac=0.05)]
CASES = ([("full", "reads", cfg) for cfg in CONFIGS]
         + [("compressed", "reads", cfg)
            for cfg in (dict(), dict(report_all=True, min_score_frac=0.1))]
         + [("full", "es_reads", dict(early_stop=True)),
            ("full", "es_reads", dict(early_stop=True, report_all=True))])


@pytest.mark.parametrize("table,reads_key,cfg", CASES)
def test_query_batch_equals_jax_and_scalar(setup, table, reads_key, cfg):
    """pmls, CSV cell and --report-colors stream of every read equal the
    JAX Fused2ColorEngine's and ColorEngine's."""
    ct = setup["tables"][table]
    reads = setup[reads_key]
    batch = next(make_batches(reads, lanes=len(reads)))
    want_jax = jf2.Fused2ColorEngine(setup["j2"][table], ct,
                                     **cfg).query_batch(batch)
    got = tf2.Fused2ColorEngine(setup["t2"][table], ct, "cpu",
                                **cfg).query_batch(batch)
    sc = ColorEngine(setup["ix"], ct, report_colors=True, **cfg)
    for i, (name, seq) in enumerate(reads):
        pmls, cell = sc.query_pml_multiclass(seq)
        assert tuple(got[i]) == tuple(want_jax[i]), name
        assert tuple(got[i]) == (pmls, cell, sc.last_colors), name


@pytest.mark.parametrize("early_stop", [False, True])
def test_paired_split_scan_equals_one_pass(setup, early_stop):
    """A paired scan in carried pieces (state, csum, stop and the even
    global step t0 passed on) gives the output and state of one pass, and
    its rows equal the one-step scan's."""
    reads = setup["es_reads"]
    ct = setup["tables"]["full"]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    eng = tf2.Fused2ColorEngine(setup["t2"]["full"], ct, "cpu",
                                early_stop=early_stop)
    (records, slots, pd, a12_t, state, lens), W = eng.scan_args(batch)
    st_one, ml_one, cid_one = tf2.fused2_color_scan(records, slots, pd,
                                                    a12_t, state, lens)
    st, mls, cids = state, [], []
    cuts = [0, 51, 75, 76, 145, a12_t.shape[0]]
    for p0, p1 in zip(cuts, cuts[1:]):
        st, ml, cid = tf2.fused2_color_scan(records, slots, pd, a12_t[p0:p1],
                                            st, lens, t0=2 * p0)
        mls.append(ml)
        cids.append(cid)
    assert torch.equal(torch.cat(mls), ml_one)
    assert torch.equal(torch.cat(cids), cid_one)
    for a, b in zip(st, st_one):
        assert torch.equal(a, b)
    one = tfc.FusedColorEngine(tfc.build_fused_color_index(
        setup["ix"], ct, setup["tfi"]), ct, "cpu", early_stop=early_stop)
    ml1, cid1 = one.query_batch_device(batch)
    if not early_stop:
        assert torch.equal(ml_one[:W], ml1) and torch.equal(cid_one[:W], cid1)
    else:
        # a paired lane also emits the second base of the pair it stops in
        assert int((st_one[4] > 0).sum()) >= 1
        for lane, L in enumerate(batch.lengths.tolist()):
            n = tfc.early_stop_len(ml1[:L, lane].numpy(), L)
            assert torch.equal(ml_one[:n, lane], ml1[:n, lane])
            assert torch.equal(cid_one[:n, lane], cid1[:n, lane])


def test_paired_long_reads_retire_early(setup):
    rng = np.random.default_rng(123)
    L = 3 * 2048 + 512
    reads = [(f"u{i}", rng.choice(ACGT, size=L).tobytes()) for i in range(5)]
    ct = setup["tables"]["full"]
    batch = next(make_batches(reads, lanes=len(reads)))
    eng = tf2.Fused2ColorEngine(setup["t2"]["full"], ct, "cpu",
                                early_stop=True)
    got = eng.query_batch(batch)
    assert eng.last_scanned_rows < L
    want = jf2.Fused2ColorEngine(setup["j2"]["full"], ct,
                                 early_stop=True).query_batch(batch)
    sc = ColorEngine(setup["ix"], ct, report_colors=True, early_stop=True)
    for (name, seq), g, w in zip(reads, got, want):
        pmls, cell = sc.query_pml_multiclass(seq)
        assert tuple(g) == tuple(w) == (pmls, cell, sc.last_colors), name


def test_use_paired_color():
    """The paired color records need r < 2^25, C+1 <= 0xFFFF and 800 B
    per run (DNA) within the budget; no cache-residency rule, so a small
    index takes them.  Forcing them past 16-bit ids gives the one-step
    layout."""
    r, sigma = 10_000, 4
    assert select.paired_color_table_bytes(r, sigma) == 800 * r
    assert select.one_step_color_table_bytes(r, sigma) == 60 * r
    assert select.use_paired_color(r, sigma, 100, device="cpu")
    assert not select.use_paired_color(r, sigma, 0xFFFF, device="cpu")
    assert not select.use_paired_color(select.MAX_RUNS, sigma, 100,
                                       device="cpu")
    assert select.use_paired_color(r, sigma, 0xFFFE, force=True)
    assert not select.use_paired_color(r, sigma, 0xFFFF, force=True)
    assert not select.use_paired_color(r, sigma, 100, force=False)
    assert select.pick_backend(r, sigma, "color", device="cpu",
                               num_sets=100) == "paired"
    assert select.pick_backend(r, sigma, "color", force_paired=True,
                               device="cpu", num_sets=0xFFFF) == "one-step"


def test_color_engine_choice(setup):
    """Index.color_engine: the paired engine by capacity, the one-step
    one when forced, and the one-step one (no 3-word records, the
    two-load scan) when the kept sets pass 16-bit ids, even if the paired
    layout is forced."""
    ct = setup["tables"]["full"]
    index = Index(setup["ix"])
    assert isinstance(index.color_engine(ct, device="cpu"),
                      tf2.Fused2ColorEngine)
    assert isinstance(index.color_engine(ct, paired=False, device="cpu"),
                      tfc.FusedColorEngine)
    pad = [np.array([0], np.uint16)] * (0xFFFF - len(ct.unique_doc_sets))
    wide = ColorTable(doc_pats=None, doc_set_inds=ct.doc_set_inds,
                      unique_doc_sets=ct.unique_doc_sets + pad,
                      doc_info=ct.doc_info)
    eng = index.color_engine(wide, paired=True, device="cpu")
    assert isinstance(eng, tfc.FusedColorEngine)
    assert eng.ci.records3 is None


def test_color_needs_thresholds_and_bound_ff(setup):
    """An index the color engines cannot run (thresholds, no bound_ff=1)
    takes the scalar ColorEngine through multi_classify, equal to the JAX
    API; the engine getter refuses it."""
    from movi_tpu import api as japi
    from movi_tpu.build.suffix import build_bwt_runs
    from movi_tpu.color import DocumentInfo as JDocumentInfo
    from movi_tpu.color import build_color_table as jbuild_color_table
    from movi_tpu.index.structure import build_move_index
    from movi_tpu_torch.convert import color_table_from_jax

    docs = [np.random.default_rng(5 + i).choice(ACGT, size=700)
            for i in range(2)]
    text = np.concatenate(docs)
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds")
    jct = jbuild_color_table(ix, runs.sa, JDocumentInfo.create(
        np.cumsum([len(d) for d in docs]), taxon_ids=[101, 202]))
    ct = color_table_from_jax(jct)
    reads = setup["reads"][:12]
    with pytest.raises(ValueError, match="scalar ColorEngine"):
        Index(ix).color_engine(ct, device="cpu")
    want = japi.Index(ix).multi_classify(reads, jct, min_match_len=2)
    assert Index(ix).multi_classify(reads, ct, device="cpu",
                                    min_match_len=2) == want
