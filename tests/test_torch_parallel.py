"""The data-parallel engines of movi_tpu_torch/parallel/mesh.py at data =
4 (four gloo ranks, each a fresh process) and data = 1 (in this process)
against the JAX engines on the 8-device CPU mesh, the scalar oracles and
the host Classifier, on the CPU.  Every comparison is exact; the cases
are those of tests/test_parallel.py."""

import numpy as np
import pytest
import torch

import jax

from movi_tpu.classify import Classifier, EmpNullDatabase
from movi_tpu.color import ColorEngine, DocumentInfo, build_color_table
from movi_tpu.cpu_ref.advanced import AdvancedEngine
from movi_tpu.cpu_ref.scalar import ScalarEngine
from movi_tpu.engine.fused import build_fused_index
from movi_tpu.engine.fused_color import build_fused_color_index
from movi_tpu.engine.fused_mem import build_fused_mem_index
from movi_tpu.engine.fused_search import build_fused_search_index
from movi_tpu.engine.fused_search2 import build_fused_search2_index
from movi_tpu.build.suffix import build_bwt_runs
from movi_tpu.index.structure import build_move_index
from movi_tpu.parallel import mesh as jmesh
from movi_tpu_torch import testing
from movi_tpu_torch.convert import fused_index_from_jax
from movi_tpu_torch.parallel import make_mesh
from movi_tpu_torch.parallel import mesh as tmesh

DATA = 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(31)
    text = rng.choice(testing.ACGT, size=6000).astype(np.uint8)
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    db = EmpNullDatabase()
    db.compute([1, 1, 1, 1, 1, 2, 2, 2, 2, 2])
    cl = Classifier(db, bin_width=16)
    rng = np.random.default_rng(37)
    batches = dict(
        pml=testing.right_aligned(rng, text, 32, 64, mutate=True),
        pml_paired=testing.right_aligned(rng, text, 32, 63, mutate=True),
        search=testing.right_aligned(rng, text, 32, 64),
        search_paired=testing.right_aligned(rng, text, 16, 40, min_len=5),
        kmer_batch=testing.right_aligned(rng, text, 16, 48, min_len=10))
    si = build_fused_search_index(ix)
    k = 8
    seqs, lengths, _ = batches["kmer_batch"]
    windows, owners = testing.kmer_window_columns(
        seqs, lengths, si.alphamap_query, k, 8)
    inputs = {key: b[:2] for key, b in batches.items()}
    inputs.update(bin_width=16, thr=int(cl.max_value_thr), k=k,
                  windows=windows, doc_ends=[3000, 6000], mem_L=10,
                  mem_text=testing.with_revcomp(text))
    mem_ix = build_move_index(build_bwt_runs(inputs["mem_text"]),
                              "regular-thresholds", bound_ff=1)
    return dict(text=text, ix=ix, si=si, cl=cl, batches=batches,
                inputs=inputs, owners=owners, mem_ix=mem_ix)


@pytest.fixture(scope="module")
def port(case):
    """{data: results} of every engine, gathered to whole batches."""
    ranks = testing.run_ranks("movi_tpu_torch.testing:mesh_rank", DATA,
                              text=case["text"], inputs=case["inputs"])
    return {DATA: ranks[0],
            1: testing.mesh_results(make_mesh(1, "cpu"), case["text"],
                                    case["inputs"])}


@pytest.fixture(scope="module")
def jax_res(case):
    """The JAX engines of movi_tpu/parallel/mesh.py on the 8-device mesh."""
    assert len(jax.devices()) >= 8, "needs the 8-device CPU mesh"
    mesh = jmesh.make_mesh(8)
    ix, inp = case["ix"], case["inputs"]
    fi = build_fused_index(ix)
    res = {}
    for key, paired in (("pml", False), ("pml_paired", True)):
        eng = jmesh.ShardedPMLEngine(fi, mesh=mesh, bin_width=16,
                                     max_value_thr=inp["thr"], paired=paired)
        res[key] = tuple(np.asarray(x)
                         for x in eng.query_batch_device(*inp[key]))
    layouts = {False: case["si"], True: build_fused_search2_index(ix)}
    for key in ("search", "search_paired"):
        for paired, idx in layouts.items():
            se = jmesh.ShardedSearchEngine(idx, mesh=mesh, paired=paired)
            res[key, paired] = tuple(np.asarray(x) for x in (
                *se.count_batch_device(*inp[key]),
                se.zml_batch_device(*inp[key])))
    runs = build_bwt_runs(case["text"])
    ct = build_color_table(ix, runs.sa, DocumentInfo.create(inp["doc_ends"]))
    ce = jmesh.ShardedColorEngine(build_fused_color_index(ix, ct, fi=fi),
                                  mesh=mesh)
    res["color"] = tuple(np.asarray(x)
                         for x in ce.query_batch_device(inp["search"][0]))
    res["color_table"] = ct
    ke = jmesh.ShardedKmerEngine(case["si"], inp["k"], mesh=mesh)
    res["kmer"] = tuple(np.asarray(x)
                        for x in ke.count_windows_device(inp["windows"]))
    mi = build_fused_mem_index(case["mem_ix"])
    for L in (inp["mem_L"], 0):
        st = jmesh.ShardedMemEngine(mi, min_mem_length=L, mesh=mesh) \
            .query_batch_device(*inp["kmer_batch"])
        res["mem", L] = (np.asarray(st["ends"]), np.asarray(st["counts"]))
    return res


@pytest.mark.parametrize("data", [DATA, 1])
@pytest.mark.parametrize("key", ["pml", "pml_paired"])
def test_pml_and_classify(case, port, jax_res, data, key):
    """ml, found, above and below equal the JAX engine's, ScalarEngine's
    PMLs and the host Classifier's vote, read by read."""
    ml, found, above, below = port[data][key]
    jml, jfound, jabove, jbelow = jax_res[key]
    assert ml.dtype == np.int32 and ml.shape == jml.shape
    assert np.array_equal(ml, jml.astype(np.int32))  # no PML past 65,535
    assert np.array_equal(found, jfound)
    assert np.array_equal(above, jabove) and np.array_equal(below, jbelow)
    sc = ScalarEngine(case["ix"])
    _, lengths, reads = case["batches"][key]
    for i, seq in enumerate(reads):
        want = sc.query_pml(seq)
        assert ml[:lengths[i], i].tolist() == want, i
        w_found, _, w_above, w_below = case["cl"].classify(want)
        assert (found[i], above[i], below[i]) == (w_found, w_above,
                                                  w_below), i


@pytest.mark.parametrize("data", [DATA, 1])
@pytest.mark.parametrize("key", ["search", "search_paired"])
@pytest.mark.parametrize("paired", [False, True])
def test_count_and_zml(case, port, jax_res, data, key, paired):
    matched, count, zml = port[data][key, paired]
    for got, want in zip((matched, count, zml), jax_res[key, paired]):
        assert np.array_equal(got, want)
    sc = ScalarEngine(case["ix"])
    _, lengths, reads = case["batches"][key]
    for i, seq in enumerate(reads):
        assert (int(lengths[i]) - int(matched[i]), int(count[i])) == \
            sc.query_count(seq), i
        assert zml[:len(seq), i].tolist() == sc.query_zml(seq), i


@pytest.mark.parametrize("data", [DATA, 1])
def test_color(case, port, jax_res, data):
    """ml and color ids equal the JAX engine's; ml equals ColorEngine's
    PMLs."""
    cml, ccol = port[data]["color"]
    assert np.array_equal(cml, jax_res["color"][0])
    assert np.array_equal(ccol, jax_res["color"][1])
    sc = ColorEngine(case["ix"], jax_res["color_table"])
    for i, seq in enumerate(case["batches"]["search"][2]):
        assert cml[:len(seq), i].tolist() == \
            sc.query_pml_multiclass(seq)[0], i


@pytest.mark.parametrize("data", [DATA, 1])
def test_kmer_counts(case, port, jax_res, data):
    """Per window equal to the JAX engine; per read equal to
    AdvancedEngine's counts."""
    found, cnt = port[data]["kmer"]
    assert np.array_equal(found, jax_res["kmer"][0])
    assert np.array_equal(cnt, jax_res["kmer"][1])
    owners = case["owners"]
    adv = AdvancedEngine(case["ix"])
    for i, seq in enumerate(case["batches"]["kmer_batch"][2]):
        mine = owners == i
        got = (int(found[:len(owners)][mine].sum()),
               int(cnt[:len(owners)][mine].astype(np.int64).sum()))
        assert got == adv.count_kmers_bidirectional(seq, 8), i


@pytest.mark.parametrize("data", [DATA, 1])
@pytest.mark.parametrize("L", [10, 0])
def test_mems(case, port, jax_res, data, L):
    """BML at L = 10 and all-MEMs on the text and its reverse complement:
    ends and counts equal the JAX engine's and AdvancedEngine's MEMs."""
    ends, counts = port[data]["mem", L]
    assert np.array_equal(ends, jax_res["mem", L][0])
    assert np.array_equal(counts, jax_res["mem", L][1])
    adv = AdvancedEngine(case["mem_ix"])
    for i, seq in enumerate(case["batches"]["kmer_batch"][2]):
        nz = np.flatnonzero(ends[i])
        got = [(int(p), int(ends[i][p]), int(counts[i][p])) for p in nz]
        want = adv.query_mems(seq, L) if L else adv.query_all_mems(seq)
        assert got == [tuple(m) for m in want], i


def test_lanes_must_divide_the_data_axis():
    text = testing.random_text(600, 3)
    fi = fused_index_from_jax(build_fused_index(build_move_index(
        build_bwt_runs(text), "regular-thresholds", bound_ff=1)))
    eng = tmesh.ShardedPMLEngine(fi, make_mesh(1, "cpu"))
    seqs = np.full((3, 5), ord("A"), np.uint8)
    ml, found, _, _ = eng.query_batch_device(seqs, np.full(3, 5))
    assert ml.shape == (5, 3) and found.shape == (3,)
    mesh = make_mesh(1, "cpu")
    mesh.data = 2   # a 'data' axis of two, seen from rank 0
    with pytest.raises(ValueError, match="divide"):
        tmesh.ShardedPMLEngine(fi, mesh).query_batch_device(
            seqs, np.full(3, 5))


def test_classify_plain_edges():
    """Kernel 16a's plain version: a lane of length 0 gives (False, 0, 1)
    as the JAX version does; a read shorter than a bin is one bin; the
    last short region merges into the previous bin."""
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    W, lanes = 37, 9
    ml = rng.integers(0, 9, size=(W, lanes)).astype(np.int32)
    lengths = np.array([0, 1, 7, 8, 15, 16, 17, 36, 37], np.int32)
    got = tmesh.classify_from_ml_plain(torch.from_numpy(ml),
                                       torch.from_numpy(lengths), 8, 4)
    want = jmesh._classify_from_ml(jnp.asarray(ml), jnp.asarray(lengths), 8,
                                   jnp.int32(4))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert (bool(got[0][0]), int(got[1][0]), int(got[2][0])) == (False, 0, 1)


def test_jax_ml_wraps_past_uint16():
    """ROADMAP §3: the JAX engine returns ml as uint16, so an exact read
    longer than 65,535 bases wraps; classification, computed before the
    cast, agrees.  The port's ml is int32 and equals ScalarEngine (on one
    exact 66,000-base read; recorded, not fixed)."""
    rng = np.random.default_rng(71)
    text = rng.choice(testing.ACGT, size=67000).astype(np.uint8)
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    L, lanes = 66000, 8
    read = text[500:500 + L]
    seqs = np.full((lanes, L), 255, np.uint8)
    seqs[0] = read
    seqs[1:, -10:] = read[:10]
    lengths = np.array([L] + [10] * (lanes - 1), np.int32)
    fi = build_fused_index(ix)
    jml, jfound, jabove, jbelow = jmesh.ShardedPMLEngine(
        fi, mesh=jmesh.make_mesh(8), bin_width=150,
        max_value_thr=4).query_batch_device(seqs, lengths)
    ml, found, above, below = tmesh.ShardedPMLEngine(
        fused_index_from_jax(fi), make_mesh(1, "cpu"), 150, 4) \
        .query_batch_device(seqs, lengths)
    want = ScalarEngine(ix).query_pml(read.tobytes())
    assert max(want) > 65535
    assert ml[:L, 0].tolist() == want
    jml = np.asarray(jml)
    assert jml.dtype == np.uint16
    assert not np.array_equal(jml[:L, 0], np.asarray(want))   # wrapped
    assert np.array_equal(jml[:L, 0], np.asarray(want) % 65536)
    for g, w in ((found, jfound), (above, jabove), (below, jbelow)):
        assert np.array_equal(g.numpy(), np.asarray(w))
