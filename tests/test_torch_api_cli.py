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


@pytest.fixture(scope="module")
def built_unbounded(tmp_path_factory, built):
    """`movi_tpu_torch.cli build --type regular` of the `built` fixture's
    reference: no thresholds and no NT splitting, so not bound_ff=1."""
    from movi_tpu_torch.engine.fused import is_bounded
    from movi_tpu_torch.index.structure import MoveIndex

    idx, reads = built
    d = tmp_path_factory.mktemp("torch_cli_unbounded")
    fasta = os.path.join(os.path.dirname(idx), "ref.fa")
    out = str(d / "idx")
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", fasta, "--index", out,
                                    "--type", "regular", "--skip-null"])
    assert r.returncode == 0, r.stderr
    assert not is_bounded(MoveIndex.load(os.path.join(out, "index.npz")))
    return out, reads


@pytest.mark.parametrize("flags,where", [
    # MEMs on an index not built with bound_ff=1 take the scalar
    # AdvancedEngine, in both packages
    pytest.param(["--mem", "--min-mem-length", "12"], "built_unbounded",
                 id="--mem"),
    # --multi-ftab matters on the scalar k-mer path only: on a bounded
    # index both CLIs run the membership engine with ftab-4 anchors
    pytest.param(["--kmer", "--multi-ftab", "--ftab-k", "4"], "built",
                 id="--kmer")])
def test_cli_other_queries_not_yet_ported(request, flags, where):
    """Routes that once raised "not yet ported" now equal the JAX CLI's
    output file byte for byte."""
    idx, reads = request.getfixturevalue(where)
    mode = "regular" if where == "built_unbounded" else "regular-thresholds"
    out = f"{reads}.{mode}." + ("mems" if "--mem" in flags else "kmers.31")
    texts = []
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        if os.path.exists(out):
            os.unlink(out)
        r = _cli(module, ["query", "--index", idx, "--read", reads, *flags,
                          "--platform", "cpu"])
        assert r.returncode == 0, r.stderr
        with open(out) as f:
            texts.append(f.read())
    assert texts[0] == texts[1]
    assert len(texts[0].splitlines()) > 0
    assert "not yet ported" not in r.stderr


def _rc_text():
    """One document and its reverse complement (a reverse-complement
    closed index), 2,500 random bases, seed 9."""
    from movi_tpu.build.prepare_ref import revcomp

    fw = random_text(2500, 9)
    return np.concatenate([fw, revcomp(fw)])


@pytest.mark.parametrize("counts,paired", [(False, None), (True, False),
                                           (True, True)])
def test_api_query_kmers_equals_jax(counts, paired):
    """Index.query_kmers (membership with ftab-10 anchors; exact counts
    one-step and paired) equals the JAX API on a forward-only index."""
    text, ix = small_index()
    reads = mixed_reads(text, seed=12, count=30) + [("tiny", b"AC")]
    for k in (9, 31):
        want = japi.Index(ix).query_kmers(reads, k=k, counts=counts,
                                          lanes=16, paired=paired)
        got = tapi.Index(ix).query_kmers(reads, k=k, counts=counts, lanes=16,
                                         paired=paired, device="cpu")
        assert got == want, k


def test_api_rc_closed_paired_counts_not_ported():
    """On a reverse-complement closed index the paired exact-count route
    (paired=True, and paired=None where the paired table fits) is the
    bidirectional engine, and equals the JAX API; the one-step route and
    membership equal it too."""
    from movi_tpu_torch.engine.fused_kmer2 import FusedKmer2CountEngine
    from movi_tpu_torch.testing import index_from_text

    text = _rc_text()
    ix = index_from_text(text)
    index = tapi.Index(ix)
    reads = mixed_reads(text, seed=2, count=12)
    jix = japi.Index(ix)
    for paired in (True, None):
        assert isinstance(index.kmer_engine(15, True, paired, "cpu"),
                          FusedKmer2CountEngine)
        assert (index.query_kmers(reads, k=15, counts=True, paired=paired,
                                  device="cpu")
                == jix.query_kmers(reads, k=15, counts=True, paired=paired))
    assert (index.query_kmers(reads, k=15, counts=True, paired=False,
                              device="cpu")
            == jix.query_kmers(reads, k=15, counts=True, paired=False))
    assert (index.query_kmers(reads, k=15, device="cpu")
            == jix.query_kmers(reads, k=15))


@pytest.fixture(scope="module")
def built_fw(tmp_path_factory, built):
    """`movi_tpu_torch.cli build --fw` of the `built` fixture's reference
    (not reverse-complement closed, so --paired-records runs kernel 7b's
    path)."""
    idx, reads = built
    d = tmp_path_factory.mktemp("torch_cli_fw")
    fasta = os.path.join(os.path.dirname(idx), "ref.fa")
    fw = str(d / "idx")
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", fasta, "--index", fw,
                                    "--fw", "--skip-null"])
    assert r.returncode == 0, r.stderr
    return fw, reads


@pytest.mark.parametrize("flags,layout", [
    (["--kmer", "--k", "15"], []),
    (["--kmer", "--k", "9", "--ftab-k", "4"], ["--lanes", "16"]),
    (["--kmer-count", "--k", "15"], ["--no-paired-records"]),
    (["--kmer-count", "--k", "12"], ["--paired-records"])])
def test_cli_kmer_stdout_byte_identical(built_fw, flags, layout):
    """query --kmer / --kmer-count --stdout on a `build --fw` index equal
    the JAX CLI's byte for byte (the JAX CLI picks its own layout)."""
    want, got = _query_both(built_fw, flags + ["--stdout"], layout)
    assert got == want
    lines = want.splitlines()
    assert len(lines) == 40 and lines[0].count("\t") == 2


def test_cli_kmer_files_identical(built):
    """Without --stdout both branches write <reads>.<mode>.kmers.<k>, equal
    to the JAX CLI's, on the default (reverse-complement) index."""
    _, reads = built
    out = f"{reads}.regular-thresholds.kmers.21"
    for flags in (["--kmer"], ["--kmer-count", "--no-paired-records"]):
        want, got = _query_both(built, flags + ["--k", "21"], [], output=out)
        assert got == want
        assert len(want.splitlines()) == 40


def test_cli_kmer_count_rc_closed_paired_not_ported(tmp_path):
    """An index of one document and its reverse complement is
    reverse-complement closed: --kmer-count --paired-records (the
    bidirectional route) and --no-paired-records both equal the JAX CLI
    byte for byte."""
    fasta = tmp_path / "ref.fa"
    fasta.write_text(f">d\n{_rc_text()[:2500].tobytes().decode()}\n")
    idx = str(tmp_path / "idx")
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", str(fasta),
                                    "--index", idx, "--skip-null"])
    assert r.returncode == 0, r.stderr
    rpath = tmp_path / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in
                             mixed_reads(_rc_text(), seed=4, count=10)))
    for layout in ("--paired-records", "--no-paired-records"):
        want, got = _query_both((idx, str(rpath)),
                                ["--kmer-count", "--k", "15", "--stdout",
                                 layout], [])
        assert got == want and len(want.splitlines()) == 10


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


@pytest.fixture(scope="module", params=[100, 37])
def built_sa(request, tmp_path_factory):
    """An index with its sampled SA (`movi_tpu_torch.cli build
    --sa-entries` at the rate given) of two documents, and the reads of
    `built`'s recipe from it (with N's)."""
    rate = request.param
    d = tmp_path_factory.mktemp(f"torch_cli_sa{rate}")
    refs = [random_text(3000, 41), random_text(2500, 42)]
    fasta = d / "ref.fa"
    fasta.write_text("".join(f">doc{i}\n{t.tobytes().decode()}\n"
                             for i, t in enumerate(refs)))
    idx = str(d / "idx")
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", str(fasta),
                                    "--index", idx, "--sa-entries",
                                    "--sa-sample-rate", str(rate),
                                    "--skip-null"])
    assert r.returncode == 0, r.stderr
    reads = mixed_reads(refs[1], seed=7, count=16)
    reads += [(f"u{i}", random_text(120 + 30 * i, 80 + i).tobytes())
              for i in range(4)]
    rpath = d / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in reads))
    return idx, str(rpath), reads


def test_cli_sa_entries_bpf_byte_identical(built_sa):
    """query --pml --sa-entries: <out>.pml.sa_entries.bpf (64-bit) and
    <out>.pml.bpf equal the JAX CLI's byte for byte, and hold
    ScalarEngine's PMLs and SA entries for every read."""
    from movi_tpu.cpu_ref.scalar import ScalarEngine
    from movi_tpu.index.structure import MoveIndex
    from movi_tpu_torch.io.outputs import read_bpf

    idx, reads, seqs = built_sa
    out = reads + ".sa"
    files = [out + ".pml.sa_entries.bpf", out + ".pml.bpf"]
    got = []
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        for p in files:
            if os.path.exists(p):
                os.unlink(p)
        r = _cli(module, ["query", "--index", idx, "--read", reads, "--pml",
                          "--sa-entries", "--out-file", out, "--platform",
                          "cpu"])
        assert r.returncode == 0, r.stderr
        got.append([open(p, "rb").read() for p in files])
    assert got[0] == got[1]
    oracle = ScalarEngine(MoveIndex.load(os.path.join(idx, "index.npz")))
    sas, pmls = read_bpf(files[0]), read_bpf(files[1])
    assert len(sas) == len(pmls) == len(seqs) == 20
    for (name, seq), (sn, sa), (pn, ml) in zip(seqs, sas, pmls):
        assert sn == pn == name
        assert (ml, sa) == oracle.query_pml(seq, collect_sa=True), name


def test_cli_sa_entries_stdout_byte_identical(built_sa):
    """With --no-output --stdout, the PML lines, as the JAX CLI prints."""
    idx, reads, _ = built_sa
    want, got = _query_both((idx, reads), ["--pml", "--sa-entries",
                                           "--no-output", "--stdout"], [])
    assert got == want
    assert len(want.splitlines()) == 2 * 20


def test_cli_sa_entries_without_sampled_sa_not_yet_ported(built):
    """Without a sampled SA both CLIs take the scalar SA path, which
    stops on the index's missing SA with the same error."""
    idx, reads = built
    errs = []
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        r = _cli(module, ["query", "--index", idx, "--read", reads, "--pml",
                          "--sa-entries", "--platform", "cpu"])
        assert r.returncode == 1
        assert r.stdout == ""
        errs.append(r.stderr)
    for err in errs:
        assert "index has no sampled SA" in err
    assert "not yet ported" not in errs[1]


@pytest.mark.parametrize("flags", [["--movi-format"], ["--mmap"],
                                   ["--fused-cache"], ["--paired-cache"],
                                   ["--ftab-k", "4"], ["--bwt-file", "x"],
                                   ["--resume"], ["--verify"]])
def test_cli_build_unported_flags_raise(tmp_path, flags):
    fasta = tmp_path / "ref.fa"
    fasta.write_text(f">d\n{random_text(500, 3).tobytes().decode()}\n")
    idx = tmp_path / "idx"
    r = _cli("movi_tpu_torch.cli", ["build", "--fasta", str(fasta),
                                    "--index", str(idx), "--skip-null"]
             + flags)
    assert r.returncode == 1
    assert "not yet ported" in r.stderr
    assert not os.path.exists(idx / "index.npz")
