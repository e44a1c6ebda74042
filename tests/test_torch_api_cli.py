"""The port's API and CLI against movi_tpu's, on the CPU: identical PML,
count, ZML and multi-class lists, byte-identical `query --stdout` output,
`.matches` files, --classify reports, and --multi-classify CSVs and
.colors files."""

import os
import subprocess
import sys

import numpy as np
import pytest

from movi_tpu import api as japi
from movi_tpu_torch import api as tapi
from movi_tpu_torch.testing import ACGT, mixed_reads, random_text, small_index

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("paired", [True, False])
def test_api_query_pml_equals_jax(paired):
    text, ix = small_index()
    reads = mixed_reads(text, seed=3)
    want = japi.Index(ix).query_pml(reads, lanes=32)
    got = tapi.Index(ix).query_pml(reads, lanes=32, paired=paired,
                                   device="cpu")
    assert got == want


@pytest.mark.parametrize("paired", [True, False])
def test_api_query_count_zml_equal_jax(paired):
    text, ix = small_index()
    reads = mixed_reads(text, seed=3)
    jix, tix = japi.Index(ix), tapi.Index(ix)
    assert (tix.query_count(reads, lanes=32, paired=paired, device="cpu")
            == jix.query_count(reads, lanes=32, paired=paired))
    assert (tix.query_zml(reads, lanes=32, paired=paired, device="cpu")
            == jix.query_zml(reads, lanes=32, paired=paired))


def test_api_paired_search_cache_shared_between_packages(tmp_path):
    """paired_search_records.npz written by either package's Index.save
    is read by the other's Index.load, which then composes nothing."""
    text, ix = small_index()
    reads = mixed_reads(text, seed=6, count=20)
    want = japi.Index(ix).query_zml(reads, paired=True)

    jdir = str(tmp_path / "from_jax")
    src = japi.Index(ix)
    src.query_count(reads, paired=True)  # composes the table
    src.save(jdir)
    port = tapi.Index.load(jdir)
    assert port._paired_search is not None
    assert port.query_zml(reads, paired=True, device="cpu") == want

    tdir = str(tmp_path / "from_torch")
    src = tapi.Index(ix)
    src.query_zml(reads, paired=True, device="cpu")
    src.save(tdir)
    assert "paired_search_records.npz" in os.listdir(tdir)
    back = japi.Index.load(tdir)
    assert back._paired_search is not None
    assert back.query_zml(reads, paired=True) == want


def test_api_caches_shared_between_packages(tmp_path):
    """Index.save of either package writes record caches the other's
    Index.load reads (index.npz, fused_records.npz, paired_records.npz)."""
    text, ix = small_index()
    reads = mixed_reads(text, seed=6, count=20)
    want = japi.Index(ix).query_pml(reads)

    jdir = str(tmp_path / "from_jax")
    japi.Index(ix).save(jdir)
    port = tapi.Index.load(jdir)
    assert port._fused is not None and port._paired is None
    assert port.query_pml(reads, paired=False, device="cpu") == want

    tdir = str(tmp_path / "from_torch")
    src = tapi.Index(ix)
    src.query_pml(reads, paired=True, device="cpu")  # composes the table
    src.save(tdir)
    assert sorted(os.listdir(tdir)) == ["fused_records.npz", "index.npz",
                                        "paired_records.npz"]
    back = japi.Index.load(tdir)
    assert back._fused_pml is not None and back._paired_pml is not None
    assert back.query_pml(reads, paired=True) == want
    assert tapi.Index.load(tdir).query_pml(reads, paired=True,
                                           device="cpu") == want


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """An index built by `movi_tpu.cli build` (jax-free without
    --fused-cache) from a synthetic FASTA, and reads half from it and
    half random, with N's."""
    d = tmp_path_factory.mktemp("torch_cli")
    refs = [random_text(4000, 11), random_text(3000, 12)]
    fasta = d / "ref.fa"
    fasta.write_text("".join(f">doc{i}\n{t.tobytes().decode()}\n"
                             for i, t in enumerate(refs)))
    idx = str(d / "idx")
    r = _cli("movi_tpu.cli", ["build", "--fasta", str(fasta), "--index",
                              idx])
    assert r.returncode == 0, r.stderr
    rng = np.random.default_rng(4)
    reads = mixed_reads(refs[0], seed=5, count=20)
    for i in range(20):
        L = int(rng.integers(150, 400))
        src = refs[1] if i % 2 else random_text(L + 1, 100 + i)
        s = int(rng.integers(0, len(src) - L))
        seq = src[s:s + L].copy()
        seq[rng.integers(0, L, size=3)] = ord("N")
        seq[rng.integers(0, L, size=3)] = rng.choice(ACGT, size=3)
        reads.append((f"long{i}", seq.tobytes()))
    rpath = d / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in reads))
    return idx, str(rpath)


@pytest.mark.parametrize("extra,layout", [
    ([], []),
    (["--lanes", "7"], ["--no-paired-records"]),
    (["--filter", "--invert"], ["--paired-records"])])
def test_cli_stdout_byte_identical(built, extra, layout):
    """The JAX CLI picks its own layout; both layouts give one output."""
    idx, reads = built
    args = ["query", "--index", idx, "--read", reads, "--pml", "--stdout",
            "--platform", "cpu"] + extra
    want = _cli("movi_tpu.cli", args)
    assert want.returncode == 0, want.stderr
    got = _cli("movi_tpu_torch.cli", args + layout)
    assert got.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert len(got.stdout) > 0


def test_cli_classify_report_identical(built):
    idx, reads = built
    report = f"{reads}.regular-thresholds.pml.report"
    args = ["query", "--index", idx, "--read", reads, "--pml", "--classify",
            "--platform", "cpu", "--out-file", reads + ".out"]
    texts = []
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        if os.path.exists(report):
            os.unlink(report)
        r = _cli(module, args)
        assert r.returncode == 0, r.stderr
        with open(report) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert len(texts[0].splitlines()) == 1 + 40


def _query_both(built, args, layout, output=None):
    """Run `query` with `args` through both CLIs (the port with `layout`
    added); return their stdouts, or the texts of the file `output`."""
    idx, reads = built
    base = ["query", "--index", idx, "--read", reads, "--platform", "cpu"]
    texts = []
    for module, extra in (("movi_tpu.cli", []),
                          ("movi_tpu_torch.cli", layout)):
        if output and os.path.exists(output):
            os.unlink(output)
        r = _cli(module, base + args + extra)
        assert r.returncode == 0, r.stderr
        if output:
            with open(output) as f:
                texts.append(f.read())
        else:
            texts.append(r.stdout)
    return texts


LAYOUTS = [["--paired-records"], ["--no-paired-records"]]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_count_stdout_byte_identical(built, layout):
    want, got = _query_both(built, ["--count", "--stdout"], layout)
    assert got == want
    assert len(want.splitlines()) == 40


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_count_matches_file_identical(built, layout):
    _, reads = built
    out = reads + ".cnt"
    want, got = _query_both(built, ["--count", "--out-file", out], layout,
                            output=out + ".count.matches")
    assert got == want
    assert len(want.splitlines()) == 40


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_zml_stdout_byte_identical(built, layout):
    want, got = _query_both(built, ["--zml", "--stdout"], layout)
    assert got == want
    assert len(want) > 0


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_zml_classify_report_identical(built, layout):
    _, reads = built
    want, got = _query_both(
        built, ["--zml", "--classify", "--out-file", reads + ".z"], layout,
        output=f"{reads}.regular-thresholds.zml.report")
    assert got == want
    assert len(want.splitlines()) == 1 + 40


@pytest.mark.parametrize("flag", ["--mem", "--kmer"])
def test_cli_other_queries_not_yet_ported(built, flag):
    idx, reads = built
    r = _cli("movi_tpu_torch.cli", ["query", "--index", idx, "--read",
                                    reads, flag, "--platform", "cpu"])
    assert r.returncode != 0
    assert "not yet ported" in r.stderr


@pytest.mark.parametrize("paired,early_stop", [(None, False), (True, True),
                                               (False, True)])
def test_api_multi_classify_equals_jax(paired, early_stop):
    """Index.multi_classify's cells equal the JAX API's, and
    query_multiclass's streams equal ColorEngine's (with --report-colors)."""
    from movi_tpu.color import ColorEngine
    from movi_tpu_torch.testing import early_stop_reads, small_color_index

    _, ix, ct, reads = small_color_index()
    reads = reads + early_stop_reads(reads)
    kw = dict(early_stop=early_stop, report_all=early_stop)
    want = japi.Index(ix).multi_classify(reads, ct, lanes=16, paired=paired,
                                         **kw)
    index = tapi.Index(ix)
    assert index.multi_classify(reads, ct, lanes=16, paired=paired,
                                device="cpu", **kw) == want
    sc = ColorEngine(ix, ct, report_colors=True, **kw)
    got = index.query_multiclass(reads, ct, lanes=16, paired=paired,
                                 device="cpu", **kw)
    for (name, seq), (gname, res) in zip(reads, got):
        pmls, cell = sc.query_pml_multiclass(seq)
        assert gname == name and res == (pmls, cell, sc.last_colors)


@pytest.fixture(scope="module")
def built_color(tmp_path_factory):
    """A colored index (`movi_tpu.cli build --color`) of three documents,
    two sharing a stretch, and reads from them plus random ones long
    enough to stop early."""
    d = tmp_path_factory.mktemp("torch_cli_color")
    refs = [random_text(3000, 21), random_text(2500, 22)]
    refs.append(np.concatenate([refs[0][:1500], random_text(1500, 23)]))
    fasta = d / "ref.fa"
    fasta.write_text("".join(f">doc{i}\n{t.tobytes().decode()}\n"
                             for i, t in enumerate(refs)))
    idx = str(d / "idx")
    r = _cli("movi_tpu.cli", ["build", "--fasta", str(fasta), "--index",
                              idx, "--color"])
    assert r.returncode == 0, r.stderr
    reads = []
    for i, ref in enumerate(refs):
        reads += [(f"d{i}_{n}", s) for n, s in mixed_reads(ref, seed=30 + i,
                                                           count=8)]
    reads += [(f"u{i}", random_text(250 + 40 * i, 60 + i).tobytes())
              for i in range(6)]
    rpath = d / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in reads))
    return idx, str(rpath)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_multi_classify_csv_and_colors_identical(built_color, layout):
    """query --pml --multi-classify --report-colors: the CSV and the
    .colors file equal the JAX CLI's."""
    idx, reads = built_color
    csv = reads + ".mc.csv"
    colors = f"{reads}.regular-thresholds.colors"
    base = ["query", "--index", idx, "--read", reads, "--pml",
            "--multi-classify", "--report-colors", "--out-file", csv,
            "--platform", "cpu"]
    texts = []
    for module, extra in (("movi_tpu.cli", []),
                          ("movi_tpu_torch.cli", layout)):
        for p in (csv, colors):
            if os.path.exists(p):
                os.unlink(p)
        r = _cli(module, base + extra)
        assert r.returncode == 0, r.stderr
        with open(csv) as f, open(colors) as g:
            texts.append((f.read(), g.read()))
    assert texts[0] == texts[1]
    assert len(texts[0][0].splitlines()) == 30
    assert len(texts[0][1].splitlines()) == 60


@pytest.mark.parametrize("layout", LAYOUTS)
def test_cli_multi_classify_early_stop_stdout_identical(built_color, layout):
    want, got = _query_both(
        built_color, ["--pml", "--multi-classify", "--early-stop",
                      "--report-all", "--min-match-len", "2", "--stdout"],
        layout)
    assert got == want
    assert len(want.splitlines()) == 30
