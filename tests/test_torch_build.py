"""The port's own copies of the JAX package's host modules (build/,
index/, color.py) against the originals, the converters of convert.py,
and `movi_tpu_torch.cli build` against `movi_tpu.cli build`: the same
arrays from the same text, and index files that either package loads
and queries to the same answers."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

from movi_tpu import color as jcolor
from movi_tpu.build import suffix as jsuffix
from movi_tpu.classify import EmpNullDatabase as JNullDB
from movi_tpu.index import structure as jstructure
from movi_tpu_torch import color as tcolor
from movi_tpu_torch.build import suffix as tsuffix
from movi_tpu_torch.classify import EmpNullDatabase as TNullDB
from movi_tpu_torch.convert import color_table_from_jax, move_index_from_jax
from movi_tpu_torch.index import structure as tstructure
from movi_tpu_torch.testing import mixed_reads, random_text

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ["regular-thresholds", "regular", "constant", "blocked-thresholds"]


def _same(a, b, where="") -> None:
    """Assert a and b hold the same values, field by field: arrays with
    their dtypes, lists, dicts, dataclasses of either package."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, where
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), where
        assert a.dtype == b.dtype and np.array_equal(a, b), where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
    elif isinstance(a, dict):
        assert a.keys() == b.keys(), where
        for k in a:
            _same(a[k], b[k], f"{where}[{k}]")
    else:
        assert a == b, where


def _docs():
    return [random_text(1800, 61), random_text(1500, 62)]


@pytest.mark.parametrize("mode", MODES)
def test_copied_builders_equal_jax(mode):
    """build_bwt_runs and build_move_index (NT split where the mode takes
    thresholds) give the same arrays in both packages."""
    text = np.concatenate(_docs())
    truns, jruns = tsuffix.build_bwt_runs(text), jsuffix.build_bwt_runs(text)
    _same(truns, jruns, "runs")
    bound_ff = 1 if mode.endswith("thresholds") else None
    tix = tstructure.build_move_index(truns, mode, bound_ff=bound_ff)
    jix = jstructure.build_move_index(jruns, mode, bound_ff=bound_ff)
    assert isinstance(tix, tstructure.MoveIndex)
    _same(tix, jix, mode)
    _same(truns.sampled_sa(37), jruns.sampled_sa(37), "sampled_sa")


def test_multihost_host_copies_equal_jax():
    """parallel/multihost.py's host helpers are copies of movi_tpu's,
    source line for source line (their behaviour:
    tests/test_torch_multihost.py)."""
    import inspect

    from movi_tpu.parallel import multihost as jmh
    from movi_tpu_torch.parallel import multihost as tmh

    for name in ("_find_record_start", "byte_range_reads", "merge_parts",
                 "bpf_header"):
        assert inspect.getsource(getattr(tmh, name)) == \
            inspect.getsource(getattr(jmh, name)), name
    assert "movi_tpu/parallel/multihost.py" in tmh.__doc__


def test_copied_color_table_equals_jax():
    docs = _docs()
    text = np.concatenate(docs)
    offs = np.cumsum([len(d) for d in docs]).astype(np.int64)
    runs = tsuffix.build_bwt_runs(text)
    ix = tstructure.build_move_index(runs, "regular-thresholds", bound_ff=1)
    tct = tcolor.build_color_table(
        ix, runs.sa, tcolor.DocumentInfo.create(offs, taxon_ids=[7, 8]))
    jct = jcolor.build_color_table(
        ix, runs.sa, jcolor.DocumentInfo.create(offs, taxon_ids=[7, 8]))
    _same(tct, jct, "colors")
    _same(tcolor.compress_color_table(tct, 2),
          jcolor.compress_color_table(jct, 2), "compressed")


def _rc_index():
    from movi_tpu.build.prepare_ref import revcomp

    fw = random_text(1500, 63)
    text = np.concatenate([fw, revcomp(fw)])
    runs = tsuffix.build_bwt_runs(text)
    return text, tstructure.build_move_index(runs, "regular-thresholds",
                                             bound_ff=1)


@pytest.mark.parametrize("ftab_k", [0, 4])
def test_copied_advanced_engine_equals_jax(ftab_k):
    """cpu_ref/advanced.py: the ftab, k-mer membership, exact counts and
    MEMs of the port's AdvancedEngine equal the original's."""
    from movi_tpu.cpu_ref.advanced import AdvancedEngine as JAdv
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine as TAdv

    text, ix = _rc_index()
    t, j = TAdv(ix, ftab_k=ftab_k), JAdv(ix, ftab_k=ftab_k)
    _same(t.ftab, j.ftab, "ftab")
    for name, seq in mixed_reads(text, seed=14, count=12):
        for k in (7, 15):
            assert t.query_all_kmers(seq, k) == j.query_all_kmers(seq, k)
            assert (t.count_kmers_bidirectional(seq, k)
                    == j.count_kmers_bidirectional(seq, k)), name
        assert t.query_mems(seq, 0) == j.query_mems(seq, 0), name
        assert t.query_mems(seq, 9) == j.query_mems(seq, 9), name
    _same(vars(t.kmer_stats), vars(j.kmer_stats), "kmer_stats")


def test_copied_native_search_equals_jax():
    """cpu_ref/native_search.py: the skip tables, the slot map and the
    prepared native arguments equal the original's, and both see the
    same native library."""
    from movi_tpu.cpu_ref import native_search as jns
    from movi_tpu_torch.cpu_ref import native_search as tns

    text, ix = _rc_index()
    _same(tns.build_skip_tables(ix), jns.build_skip_tables(ix), "skip")
    reads = np.stack([text[i:i + 40] for i in range(0, 400, 40)])
    reads[3, 5] = ord("N")
    _same(tns.reads_to_slots(ix, reads), jns.reads_to_slots(ix, reads),
          "slots")
    tc, jc = tns.NativeSearchCtx(ix, True), jns.NativeSearchCtx(ix, True)
    _same(vars(tc), vars(jc), "ctx")
    assert tns.native_search_available() == jns.native_search_available()
    slots = tns.reads_to_slots(ix, reads)
    assert (tns.native_kmer_count(tc, slots, 11)
            == jns.native_kmer_count(jc, slots, 11))


def test_copied_native_pml_equals_jax():
    """cpu_ref/native_pml.py: the same library and the same checksum
    (None for both when the library is not built)."""
    from movi_tpu.cpu_ref import native_pml as jnp_
    from movi_tpu_torch.cpu_ref import native_pml as tnp_

    text, ix = _rc_index()
    assert tnp_.native_pml_available() == jnp_.native_pml_available()
    slots = np.stack([text[i:i + 50] for i in range(0, 500, 50)])
    amap = np.full(256, ix.sigma, dtype=np.uint8)
    amap[ix.alphabet] = np.arange(ix.sigma)
    reads = amap[slots[:, ::-1]]
    assert (tnp_.native_pml_checksum(ix, reads)
            == jnp_.native_pml_checksum(ix, reads))


def test_move_index_from_jax_round_trips(tmp_path):
    """A movi_tpu MoveIndex becomes the port's with the same arrays; the
    port's index.npz loads in movi_tpu as the original, and back."""
    runs = jsuffix.build_bwt_runs(np.concatenate(_docs()))
    jix = jstructure.build_move_index(runs, "regular-thresholds", bound_ff=1)
    jix.sampled_SA = runs.sampled_sa(100)
    jix.next_tables()  # a cached table crosses too
    tix = move_index_from_jax(jix)
    assert isinstance(tix, tstructure.MoveIndex)
    _same(tix, jix, "converted")
    path = str(tmp_path / "index.npz")
    tix.save(path)
    back = jstructure.MoveIndex.load(path)
    jpath = str(tmp_path / "jax.npz")
    jix.save(jpath)
    again = tstructure.MoveIndex.load(jpath)
    for f in ("n_arr", "offset_arr", "id_arr", "c_arr", "all_p", "thr",
              "sampled_SA"):
        _same(getattr(back, f), getattr(jix, f), f)
        _same(getattr(again, f), getattr(jix, f), f)
    assert (back.r, back.length, back.mode) == (jix.r, jix.length, jix.mode)


def test_color_table_from_jax_round_trips(tmp_path):
    docs = _docs()
    runs = jsuffix.build_bwt_runs(np.concatenate(docs))
    jix = jstructure.build_move_index(runs, "regular-thresholds", bound_ff=1)
    offs = np.cumsum([len(d) for d in docs]).astype(np.int64)
    jct = jcolor.build_color_table(jix, runs.sa,
                                   jcolor.DocumentInfo.create(offs))
    tct = color_table_from_jax(jct)
    assert isinstance(tct, tcolor.ColorTable)
    assert isinstance(tct.doc_info, tcolor.DocumentInfo)
    _same(tct, jct, "converted")
    tct.save(str(tmp_path / "t.npz"))
    _same(jcolor.ColorTable.load(str(tmp_path / "t.npz")), jct, "loaded")


def _cli(module, args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-m", module] + args, cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    return r


@pytest.fixture(scope="module")
def both_builds(tmp_path_factory):
    """One FASTA of two documents built by each CLI with --color
    --sa-entries --sa-sample-rate 37 (null databases included), and reads
    from it with N's."""
    d = tmp_path_factory.mktemp("torch_build")
    docs = _docs()
    fasta = d / "ref.fa"
    fasta.write_text("".join(f">doc{i}\n{t.tobytes().decode()}\n"
                             for i, t in enumerate(docs)))
    flags = ["--color", "--sa-entries", "--sa-sample-rate", "37"]
    dirs = {}
    for module in ("movi_tpu.cli", "movi_tpu_torch.cli"):
        dirs[module] = str(d / module)
        _cli(module, ["build", "--fasta", str(fasta), "--index",
                      dirs[module]] + flags)
    reads = mixed_reads(docs[1], seed=8, count=25)
    rpath = d / "reads.fa"
    rpath.write_text("".join(f">{n}\n{s.decode()}\n" for n, s in reads))
    return dirs, str(rpath)


def test_cli_build_writes_what_movi_tpu_writes(both_builds):
    """The same files, and each loads in both packages to the same
    arrays: index.npz (with the sampled SA), colors.npz, the null
    databases, the document offsets."""
    dirs, _ = both_builds
    tdir, jdir = dirs["movi_tpu_torch.cli"], dirs["movi_tpu.cli"]
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    for d in (tdir, jdir):
        npz = os.path.join(d, "index.npz")
        _same(tstructure.MoveIndex.load(npz),
              jstructure.MoveIndex.load(os.path.join(jdir, "index.npz")), d)
        _same(jcolor.ColorTable.load(os.path.join(d, "colors.npz")),
              tcolor.ColorTable.load(os.path.join(jdir, "colors.npz")), d)
        for q in ("pml", "zml"):
            name = f"movi.{q}.nulldb"
            _same(vars(JNullDB.load(os.path.join(d, name))),
                  vars(TNullDB.load(os.path.join(jdir, name))), name)
    for name in ("ref.fa.doc_offsets", "null_reads.fasta"):
        with open(os.path.join(tdir, name)) as f, \
                open(os.path.join(jdir, name)) as g:
            assert f.read() == g.read(), name


def test_cli_build_sampled_sa_equals_jax(both_builds):
    dirs, _ = both_builds
    t = tstructure.MoveIndex.load(os.path.join(dirs["movi_tpu_torch.cli"],
                                               "index.npz"))
    j = jstructure.MoveIndex.load(os.path.join(dirs["movi_tpu.cli"],
                                               "index.npz"))
    assert t.sampled_SA is not None and t.sa_sample_rate == 37
    assert len(t.sampled_SA) == (t.length - 1) // 37 + 1
    _same(t.sampled_SA, j.sampled_SA, "sampled_SA")


@pytest.mark.parametrize("query", [["--pml", "--classify"],
                                   ["--zml", "--classify"],
                                   ["--pml", "--multi-classify"]])
def test_cli_queries_agree_on_either_build(both_builds, query):
    """Either CLI, on either package's index, prints the same output."""
    dirs, reads = both_builds
    outs = set()
    for idx in dirs.values():
        for module in dirs:
            r = _cli(module, ["query", "--index", idx, "--read", reads,
                              *query, "--stdout", "--platform", "cpu"])
            outs.add(r.stdout)
    assert len(outs) == 1 and len(outs.pop()) > 0
