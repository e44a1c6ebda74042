"""The port's scalar routes against movi_tpu's, on the CPU: `query
--no-jax` (PML, ZML, count; PML with --sa-entries), `--logs`,
`--multi-classify` on an index the color engines cannot run, `--kmer`,
`--kmer-count`, `--mem` and `--multi-ftab` on an index the device engines
cannot run, byte for byte; and the API's scalar route (`Index.scalar`,
jax=False, `Index.classify`).  Both CLIs run in this process."""

import os

import pytest

from movi_tpu import api as japi
from movi_tpu import cli as jcli
from movi_tpu.classify import EmpNullDatabase as JNullDB
from movi_tpu_torch import api as tapi
from movi_tpu_torch import cli as tcli
from movi_tpu_torch.classify import EmpNullDatabase
from movi_tpu_torch.color import DocumentInfo, build_color_table
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.index.structure import MoveIndex
from movi_tpu_torch.testing import cli_inputs, run_cli, unsplit_index


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """`build --sa-entries` (thresholds, bound_ff=1, a sampled SA),
    `build --type regular --color` (neither thresholds nor bound_ff=1),
    and an unsplit thresholds index with its color table."""
    d = str(tmp_path_factory.mktemp("scalar_routes"))
    fasta, rpath, reads = cli_inputs(d)
    thr = os.path.join(d, "thr")
    tcli.main(["build", "--fasta", fasta, "--index", thr, "--sa-entries"])
    regular = os.path.join(d, "regular")
    tcli.main(["build", "--fasta", fasta, "--index", regular, "--type",
               "regular", "--color", "--skip-null"])
    unbounded = os.path.join(d, "unbounded")
    os.makedirs(unbounded)
    ix, runs, ref = unsplit_index(fasta)
    ix.save(os.path.join(unbounded, "index.npz"))
    build_color_table(ix, runs.sa, DocumentInfo.create(ref.doc_offsets)) \
        .save(os.path.join(unbounded, "colors.npz"))
    return dict(d=d, reads=rpath, seqs=reads,
                thr=(thr, "regular-thresholds"),
                regular=(regular, "regular"),
                unbounded=(unbounded, "regular-thresholds"))


def both(data, where, flags, outputs):
    """Run `query` through both CLIs; return JAX's and the port's (exit
    code, stdout, the files of `outputs`) and the port's log."""
    idx, mode = data[where]
    out = os.path.join(data["d"], "out")
    paths = [p.format(out=out, read=data["reads"], mode=mode)
             for p in outputs]
    res = []
    for main in (jcli.main, tcli.main):
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        rc, stdout, err = run_cli(main, ["query", "--index", idx, "--read",
                                         data["reads"], *flags, "--out-file",
                                         out, "--platform", "cpu"])
        files = []
        for p in paths:
            if os.path.exists(p):
                with open(p, "rb") as f:
                    files.append(f.read())
        res.append((rc, stdout, files))
    return res[0], res[1], err


ROUTES = [
    pytest.param("thr", ["--pml", "--no-jax", "--stdout"], [],
                 id="pml-no-jax"),
    pytest.param("thr", ["--zml", "--no-jax", "--stdout"], [],
                 id="zml-no-jax"),
    pytest.param("thr", ["--count", "--no-jax"], ["{out}.count.matches"],
                 id="count-no-jax"),
    pytest.param("thr", ["--pml", "--no-jax", "--sa-entries"],
                 ["{out}.pml.sa_entries.bpf", "{out}.pml.bpf"],
                 id="pml-no-jax-sa-entries"),
    pytest.param("thr", ["--zml", "--sa-entries", "--stdout"], [],
                 id="zml-sa-entries"),
    pytest.param("unbounded", ["--pml", "--multi-classify",
                               "--report-colors", "--report-all"],
                 ["{out}", "{read}.{mode}.colors"], id="multi-classify"),
    pytest.param("regular", ["--kmer", "--k", "11"],
                 ["{read}.{mode}.kmers.11"], id="kmer"),
    pytest.param("regular", ["--kmer-count", "--k", "11", "--stdout"], [],
                 id="kmer-count"),
    pytest.param("regular", ["--mem", "--min-mem-length", "10"],
                 ["{read}.{mode}.mems"], id="mem"),
    pytest.param("regular", ["--mem", "--stdout"], [], id="all-mems"),
    pytest.param("regular", ["--kmer", "--multi-ftab", "--ftab-k", "4",
                             "--k", "11", "--stdout"], [], id="multi-ftab"),
    pytest.param("thr", ["--kmer", "--no-jax", "--ftab-k", "6", "--k", "11",
                         "--stdout"], [], id="kmer-no-jax-ftab")]


@pytest.mark.parametrize("where,flags,outputs", ROUTES)
def test_scalar_routes_equal_jax(data, where, flags, outputs):
    want, got, log = both(data, where, flags, outputs)
    assert want[0] == got[0] == 0, log
    assert got == want
    assert want[1] or (want[2] and all(want[2]))
    # no device engine ran
    assert "compact" not in log and "records" not in log


def test_sa_entries_bpf_hold_the_oracle(data):
    """--no-jax --sa-entries writes ScalarEngine's PMLs and SA entries."""
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.io.outputs import read_bpf

    idx, _ = data["thr"]
    out = os.path.join(data["d"], "sa")
    rc, _, err = run_cli(tcli.main, ["query", "--index", idx, "--read",
                                     data["reads"], "--pml", "--no-jax",
                                     "--sa-entries", "--out-file", out,
                                     "--platform", "cpu"])
    assert rc == 0, err
    oracle = ScalarEngine(MoveIndex.load(os.path.join(idx, "index.npz")))
    sas = read_bpf(out + ".pml.sa_entries.bpf")
    pmls = read_bpf(out + ".pml.bpf")
    assert len(sas) == len(pmls) == len(data["seqs"])
    for (name, seq), (_, sa), (_, ml) in zip(data["seqs"], sas, pmls):
        assert (ml, sa) == oracle.query_pml(seq, collect_sa=True), name


def test_logs_equal_jax(data):
    """--logs: .scans, .fastforwards and the .bpf byte for byte; .costs
    holds timings, so only its lines are compared."""
    idx, mode = data["thr"]
    prefix = f"{data['reads']}.{mode}.pml"
    exts = ("scans", "fastforwards", "bpf", "costs")
    res = []
    for main in (jcli.main, tcli.main):
        for e in exts:
            if os.path.exists(f"{prefix}.{e}"):
                os.unlink(f"{prefix}.{e}")
        rc, _, err = run_cli(main, ["query", "--index", idx, "--read",
                                    data["reads"], "--pml", "--logs",
                                    "--platform", "cpu"])
        assert rc == 0, err
        res.append({e: open(f"{prefix}.{e}", "rb").read() for e in exts})
    for e in ("scans", "fastforwards", "bpf"):
        assert res[1][e] == res[0][e], e
    lines = [r["costs"].splitlines() for r in res]
    assert len(lines[1]) == len(lines[0]) == 2 * len(data["seqs"])
    assert [ln for ln in lines[1] if ln.startswith(b">")] \
        == [ln for ln in lines[0] if ln.startswith(b">")]


def test_multi_classify_without_thresholds_fails_like_jax(data):
    """The scalar ColorEngine repositions by threshold: on an index
    without thresholds movi_tpu fails (a TypeError, ROADMAP §3.7) and the
    port refuses with the reason; neither writes a call."""
    idx, _ = data["regular"]
    argv = ["query", "--index", idx, "--read", data["reads"], "--pml",
            "--multi-classify", "--stdout", "--platform", "cpu"]
    with pytest.raises(TypeError):
        run_cli(jcli.main, argv)
    rc, out, err = run_cli(tcli.main, argv)
    assert rc == 1 and out == ""
    assert "needs an index with thresholds" in err


@pytest.fixture(scope="module")
def indexes(data):
    return {w: MoveIndex.load(os.path.join(data[w][0], "index.npz"))
            for w in ("thr", "regular", "unbounded")}


def test_scalar_property_is_the_oracle(indexes):
    index = tapi.Index(indexes["thr"])
    assert isinstance(index.scalar, AdvancedEngine)
    assert index.scalar is index.scalar


@pytest.mark.parametrize("query,kw", [
    ("query_pml", {}), ("query_count", {}), ("query_zml", {}),
    ("query_kmers", {"k": 11}), ("query_kmers", {"k": 11, "counts": True}),
    ("query_mems", {"min_mem_length": 10}),
    ("query_mems", {"min_mem_length": 10, "ftab_k": 4})])
@pytest.mark.parametrize("where", ["thr", "regular"])
def test_api_scalar_routes_equal_jax(data, indexes, query, kw, where):
    """jax=False on any index, and every query on the index without
    thresholds or bound_ff=1, take the scalar oracle in both APIs."""
    ix = indexes[where]
    reads = data["seqs"]
    jix, tix = japi.Index(ix), tapi.Index(ix)
    want = getattr(jix, query)(reads, jax=False, **kw)
    assert getattr(tix, query)(reads, jax=False, device="cpu", **kw) == want
    if where == "regular":
        assert getattr(tix, query)(reads, device="cpu", **kw) \
            == getattr(jix, query)(reads, **kw) == want


def test_api_multi_classify_scalar_equals_jax(data, indexes):
    from movi_tpu.color import ColorTable as JColorTable
    from movi_tpu_torch.color import ColorTable

    idx, _ = data["unbounded"]
    ct = ColorTable.load(os.path.join(idx, "colors.npz"))
    jct = JColorTable.load(os.path.join(idx, "colors.npz"))
    ix = indexes["unbounded"]
    kw = dict(min_match_len=2, report_all=True)
    want = japi.Index(ix).multi_classify(data["seqs"], jct, **kw)
    assert tapi.Index(ix).multi_classify(data["seqs"], ct, device="cpu",
                                         **kw) == want
    assert tapi.Index(ix).multi_classify(data["seqs"], ct, device="cpu",
                                         jax=False, **kw) == want


@pytest.mark.parametrize("where", ["thr", "regular"])
def test_api_classify_equals_jax(data, indexes, where):
    db = os.path.join(data["thr"][0], "movi.pml.nulldb")
    ix = indexes[where]
    want = japi.Index(ix).classify(data["seqs"], JNullDB.load(db))
    got = tapi.Index(ix).classify(data["seqs"], EmpNullDatabase.load(db),
                                  device="cpu")
    assert got == want
    assert len(got) == len(data["seqs"])
    with pytest.raises(ValueError, match="null database"):
        tapi.Index(ix).classify(data["seqs"], device="cpu")


@pytest.mark.parametrize("flags", [["--pml", "--no-jax"], ["--kmer"],
                                   ["--count", "--logs"]])
def test_scalar_routes_resolve_the_device_first(data, monkeypatch, flags):
    """A route is chosen by the index and the flags, never by the card:
    without one, the default --platform gpu fails on a scalar route too."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    idx, _ = data["regular"]
    rc, out, err = run_cli(tcli.main, ["query", "--index", idx, "--read",
                                       data["reads"], *flags, "--stdout"])
    assert rc == 1 and out == ""
    assert "no CUDA device" in err
