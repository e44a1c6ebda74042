"""The port never imports JAX or anything of the JAX package, and its
wrappers never reach the CUDA kernel loader for a CPU tensor."""

import ast
import os
import subprocess
import sys

import pytest
import torch

import movi_tpu_torch
from movi_tpu_torch import device, kernels
from movi_tpu_torch.engine import dense as td
from movi_tpu_torch.engine import device_index as tdi
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.engine import fused_color as tfc
from movi_tpu_torch.engine import fused_kmer as tk
from movi_tpu_torch.engine import fused_kmer2 as tk2
from movi_tpu_torch.engine import fused_mem as tm1
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_sa as tsa
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.engine import pml as tpml
from movi_tpu_torch.engine import search as tsearch
from movi_tpu_torch.parallel import mesh as tmesh
from movi_tpu_torch.parallel import sharded_index as tsi
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.testing import (mixed_reads, small_color_index,
                                    small_index, small_sa_index)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(movi_tpu_torch.__file__)


def _modules():
    mods = []
    for root, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(root, f), REPO)[:-3]
                mods.append(rel.replace(os.sep, ".").removesuffix(".__init__"))
    return sorted(mods)


def test_port_imports_no_jax():
    """In a fresh interpreter (this one has JAX loaded by conftest)."""
    mods = _modules()
    assert "movi_tpu_torch.cli" in mods and len(mods) >= 10
    assert "movi_tpu_torch.engine.fused_color" in mods
    assert "movi_tpu_torch.engine.fused_kmer2" in mods
    assert "movi_tpu_torch.engine.search" in mods
    assert "movi_tpu_torch.engine.fused_mem" in mods
    # the multi-device runtime and the dense engine
    assert {"movi_tpu_torch.engine.dense", "movi_tpu_torch.parallel",
            "movi_tpu_torch.parallel.mesh",
            "movi_tpu_torch.parallel.sharded_index",
            "movi_tpu_torch.parallel.multihost",
            "movi_tpu_torch.parallel.dryrun"} <= set(mods)
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' "
            "or k.startswith('jax.'))\n"
            "print('JAX', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_port_imports_nothing_of_movi_tpu():
    """Importing every port module and chip_smoke.py in a fresh
    interpreter loads no `movi_tpu` or `movi_tpu.*` module."""
    mods = _modules() + ["chip_smoke"]
    assert "movi_tpu_torch.logs" in mods
    assert "movi_tpu_torch.parallel.dryrun" in mods
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules if k == 'movi_tpu' "
            "or k.startswith('movi_tpu.'))\n"
            "print('MOVI_TPU', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_names(path):
    """Every module an import statement of `path` names (absolute, or
    relative with its dots), and every string constant in it."""
    tree = ast.parse(open(path).read(), path)
    names, strings = [], []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append("." * node.level + (node.module or ""))
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            strings.append(node.value)
    return names, strings


def test_no_source_names_movi_tpu():
    """No import in the port's sources or chip_smoke.py names `movi_tpu`
    or `jax` (a relative import stays inside the port), and none runs the
    JAX package's CLI."""
    paths = [os.path.join(root, f) for root, _, files in os.walk(PKG)
             for f in files if f.endswith(".py")]
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(paths) > 30
    for path in paths:
        names, strings = _imported_names(path)
        for name in names:
            top = name.split(".")[0]
            assert top not in ("movi_tpu", "jax", "jaxlib"), (path, name)
        assert not any("movi_tpu.cli" in s and "movi_tpu_torch.cli" not in s
                       for s in strings), path


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_loader(*_a, **_k):
        raise AssertionError("kernel loader touched for a CPU tensor")

    monkeypatch.setattr(kernels, "_load", no_loader)
    monkeypatch.setattr(kernels, "build", no_loader)
    kernels.reset_launches()
    text, ix = small_index(n=600)
    fi = tf.build_fused_index(ix)
    slots = fi.sigma + 1
    alphas = torch.randint(0, slots, (9, 4), dtype=torch.uint8)
    tf.fused_pml_scan(fi.records, slots, fi.p_dollar, alphas,
                      tf.initial_state(fi, 4, "cpu"))
    f2 = tf2.build_fused2_index(fi)
    a12 = torch.randint(0, slots * slots, (5, 4), dtype=torch.uint8)
    tf2.fused2_pml_scan(f2.records, slots, f2.p_dollar, a12,
                        tf.initial_state(f2, 4, "cpu"))
    si = ts.build_fused_search_index(ix)
    chars = torch.randint(-2, si.sigma, (9, 4), dtype=torch.int8)
    ts.fused_count_scan(si.rec_all, si.init_rec, si.all_p, si.r, si.sigma,
                        chars)
    ts.fused_zml_scan(si.rec_all, si.init_rec, si.r, si.sigma, chars)
    s2 = ts2.build_fused_search2_index(ix, "cpu")  # runs the compose
    a12 = torch.randint(0, s2.sigma + 2, (2, 5, 4))
    pairs = (a12[0] * 8 + a12[1]).to(torch.uint8)
    ts2.fused2_count_scan(s2.rec_all, s2.init_rec, s2.all_p, s2.r, s2.sigma,
                          pairs, a0=chars[0])
    ts2.fused2_zml_scan(s2.rec_all, s2.init_rec, s2.restart_rec, s2.r,
                        s2.sigma, pairs)
    _, cix, ct, _ = small_color_index()
    cfi = tf.build_fused_index(cix)
    ci = tfc.build_fused_color_index(cix, ct, cfi)
    lens = torch.full((4,), 9, dtype=torch.int32)
    for es in (False, True):
        st = tfc.color_state(cfi, 4, "cpu", es)
        tfc.fused_color_scan(ci.records3, slots, cfi.p_dollar, alphas, st,
                             lens=lens if es else None)
        tfc.fused_color_scan(cfi.records, slots, cfi.p_dollar, alphas, st,
                             ci.doc_set_inds, lens if es else None)
        c2 = tf2.build_fused2_color_index(cfi, ct)  # runs the compose
        a12 = torch.randint(0, slots * slots, (5, 4), dtype=torch.uint8)
        tf2.fused2_color_scan(c2.f2.records, slots, cfi.p_dollar, a12, st,
                              lens if es else None)
    _, six, _ = small_sa_index(37)
    sfi = tf.build_fused_index(six)
    sx = tsa.build_fused_sa_index(six, sfi)
    _, sml, pre_idx, pre_off = tsa.pml_pre_state_scan(
        sfi.records, sx.pre_tab, slots, sfi.p_dollar, alphas,
        tf.initial_state(sfi, 4, "cpu"))
    tsa.sa_entries(sfi.records, slots, sx.all_p, sx.sampled, sx.rate, sx.n,
                   pre_idx, pre_off, sml, alphas)
    ksi = ts.build_fused_search_index(ix, ftab_k=4)
    al8 = torch.randint(-1, 4, (4, 9), dtype=torch.int8)
    lengths = torch.tensor([9, 8, 3, 0], dtype=torch.int32)
    for fk in (0, 4):
        alc = tm2.prep_alc(al8, fk)
        tk.kmer_scan(ksi, alc, tk.make_kmer_state(4, 9, lengths, 7), 7, 50,
                     fk > 0)
    lane = torch.tensor([0, 1, 1, 3], dtype=torch.int32)
    start = torch.tensor([0, 2, 0, 3], dtype=torch.int32)
    tk.kmer_count_scan(si, al8, lane, start, 5)
    ts2.fused2_kmer_count_scan(s2, al8, lane, start, 5)
    m2 = tm2.build_fused_mem2_index(ix, 4)
    for fk, L in ((0, 5), (4, 5)):
        alc = tm2.prep_alc(al8, fk)
        tm2.mem2_scan(m2, alc,
                      tm2.entry_state(tm2.MEM2_STATE_KEYS, 4, 9, "cpu"), L,
                      50, fk > 0)
    alc = tm2.prep_alc(al8, 0)
    tm2.all_mem2_scan(m2, alc,
                      tm2.entry_state(tm2.AM2_STATE_KEYS, 4, 9, "cpu"), 50)
    own = torch.tensor([0, 0, 1], dtype=torch.int32)
    anchor = torch.tensor([0, 3, 1], dtype=torch.int32)
    right = tk2.kmer2_right_scan(m2, al8, own, anchor, 5)
    tk2.kmer2_left_scan(m2, s2, *right, al8, own, anchor, 5, 2)
    for cap in (1 << 27, 0):  # pos2rba (kernel 13a), then the directory
        monkeypatch.setattr(tm1, "POS2RUN_MAX_N", cap)
        m1 = tm1.build_fused_mem_index(ix, "cpu")  # kernel 13d past the cap
        assert (m1.pos2rba is None) == (cap == 0) == (m1.run_dir is not None)
        tm1.mem_scan(m1, al8,
                     tm2.entry_state(tm1.MEM1_STATE_KEYS, 4, 9, "cpu"), 5,
                     tm1.mem_tick_cap(9))
        tm1.all_mem_scan(m1, al8,
                         tm2.entry_state(tm1.AM1_STATE_KEYS, 4, 9, "cpu"),
                         tm1.mem_tick_cap(9))
    for mode in ("regular-thresholds", "regular"):
        cix = build_move_index(build_bwt_runs(text), mode)
        di = tdi.build_device_index(cix)
        codes = torch.randint(-1, di.sigma, (9, 4), dtype=torch.int8)
        for rr in ([False, True] if cix.thr is not None else [True]):
            tpml.compact_pml_scan(di, codes, tpml.initial_state(di, 4, "cpu"),
                                  rr)
        tsearch.compact_count_scan(di, chars)
        tsearch.compact_zml_scan(di, chars)
    dense = td.build_dense_index(ix)
    td.dense_pml_scan(dense.table, slots, alphas,
                      td.initial_state(dense, 4, "cpu"))
    ml = torch.zeros((9, 4), dtype=torch.int32)
    tmesh.classify_from_ml(ml, lengths, 3, 4)
    state = torch.tensor([fi.start_idx, fi.start_offset, 0],
                         dtype=torch.int32)[:, None].repeat(1, 4)
    rec = tsi.sharded_pml_gather(fi.records[:7], 0, slots, fi.p_dollar,
                                 alphas, 0, None, state, ml)
    tsi.sharded_pml_gather(fi.records[:7], 0, slots, fi.p_dollar, alphas,
                           1, rec, state, ml)
    sst = torch.zeros((6, 4), dtype=torch.int32)
    rec = tsi.sharded_search_gather(si.rec_all[5:], 5, si.r, si.sigma,
                                    si.init_rec, chars, 0, True, None, sst,
                                    ml)
    tsi.sharded_search_gather(si.rec_all[5:], 5, si.r, si.sigma, si.init_rec,
                              chars, 1, True, rec, sst, ml)
    assert all(v == 0 for v in kernels.launches.values())
    assert set(kernels.launches) == {"fused_pml_scan",
                                     "compose_paired_records",
                                     "fused2_pml_scan", "fused_count_scan",
                                     "fused_zml_scan",
                                     "compose_search2_records",
                                     "fused2_count_scan", "fused2_zml_scan",
                                     "fused_color_scan",
                                     "compose_paired_color_records",
                                     "fused2_color_scan",
                                     "fused_sa_pre_scan", "sa_mark",
                                     "sa_walk", "sa_fill",
                                     "kmer_member_scan", "kmer_count_scan",
                                     "fused2_kmer_count_scan", "prep_alc",
                                     "mem2_scan", "all_mem2_scan",
                                     "kmer2_right_scan", "kmer2_left_scan",
                                     "compact_pml_scan", "compact_count_scan",
                                     "compact_zml_scan", "pos2rba_build",
                                     "run_dir_build", "mem1_scan",
                                     "all_mem1_scan",
                                     "dense_pml_scan", "sharded_pml_gather",
                                     "sharded_search_gather",
                                     "sharded_pml_scan",
                                     "sharded_search_scan",
                                     "classify_from_ml"}


def test_kernel_wrappers_refuse_cpu_tensors():
    rec = torch.zeros((10, 2), dtype=torch.int32)
    st = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError):
        kernels.fused_pml_scan(rec, 5, (0, 0),
                               torch.zeros((3, 4), dtype=torch.uint8), st)
    with pytest.raises(ValueError):
        kernels.compose_paired_records(rec, 2, 5, (0, 0))
    srec = torch.zeros((2 * 4 * 3, 4), dtype=torch.int32)
    init = torch.zeros((5, 4), dtype=torch.int32)
    all_p = torch.zeros(4, dtype=torch.int32)
    chars = torch.zeros((3, 4), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.fused_count_scan(srec, init, all_p, 3, 4, chars)
    with pytest.raises(ValueError):
        kernels.fused_zml_scan(srec, init, 3, 4, chars)
    prec = torch.zeros((2 * 3 * 16, 6), dtype=torch.int32)
    pairs = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.fused2_count_scan(prec, init, all_p, 3, 4, pairs,
                                  a0=chars[0])
    with pytest.raises(ValueError):
        kernels.fused2_zml_scan(prec, init,
                                torch.zeros((16, 5), dtype=torch.int32), 3,
                                4, pairs)
    runs = torch.zeros(3, dtype=torch.int32)
    nxt = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.compose_search2_records(runs, runs, runs, nxt, nxt, 3, 4)
    codes = torch.zeros((3, 4), dtype=torch.uint8)
    with pytest.raises(ValueError):
        kernels.fused_color_scan(torch.zeros((10, 3), dtype=torch.int32), 5,
                                 (0, 0), codes, st)
    with pytest.raises(ValueError):
        kernels.fused_color_scan(rec, 5, (0, 0), codes, st,
                                 cids=torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):
        kernels.compose_paired_color_records(
            rec, torch.zeros(2, dtype=torch.int32), 2, 5, (0, 0))
    with pytest.raises(ValueError):
        kernels.fused2_color_scan(torch.zeros((50, 8), dtype=torch.int32), 5,
                                  (0, 0), codes, st)
    with pytest.raises(ValueError):
        kernels.fused_sa_pre_scan(rec, torch.zeros((10, 3), dtype=torch.int32),
                                  5, (0, 0), codes, st)
    i64 = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError):
        kernels.sa_walk(rec, 5, i64, i64, 100, 10, st[0], st[1],
                        (i64, i64, i64, i64[:1]))
    grid32 = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.sa_mark(i64, i64, 100, grid32, grid32, grid32, codes, 4)
    with pytest.raises(ValueError):
        kernels.sa_fill(torch.zeros((3, 4), dtype=torch.int64),
                        torch.zeros((3, 4), dtype=torch.int64), 10)
    slots8 = torch.zeros((4, 9), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.prep_alc(slots8, 4)
    kst = {key: torch.zeros(4, dtype=torch.int32)
           for key in kernels.KMER_STATE_KEYS}
    kst["out"] = torch.zeros((4, 9), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.kmer_member_scan(srec, init, 3, 4, 0,
                                 torch.zeros((4, 9), dtype=torch.int32), kst,
                                 7, 10, False)
    idx32 = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.kmer_count_scan(srec, init, all_p, 3, 4, slots8, idx32,
                                idx32, 5)
    with pytest.raises(ValueError):
        kernels.fused2_kmer_count_scan(prec, init, all_p, 3, 4, slots8,
                                       idx32, idx32, 5)


def test_compact_wrappers_refuse_cpu_tensors():
    """The three compact wrappers launch on CUDA tensors only."""
    _, ix = small_index(n=600)
    di = tdi.build_device_index(ix)
    codes = torch.zeros((3, 4), dtype=torch.int8)
    st = tpml.initial_state(di, 4, "cpu")
    for rr in (False, True):
        with pytest.raises(ValueError):
            kernels.compact_pml_scan(di.n, di.lf_abs, di.all_p, di.c,
                                     di.thr_full, di.rep_up, di.rep_down,
                                     di.run_dir, di.dir_shift, di.length,
                                     di.r, di.sigma, codes, st, rr)
    search = (di.n, di.lf_abs, di.all_p, di.c_search, di.ch_up_s,
              di.ch_down_s, di.first_runs, di.first_offsets, di.last_runs,
              di.last_offsets, di.run_dir, di.dir_shift, di.length, di.r,
              di.sigma, codes)
    with pytest.raises(ValueError):
        kernels.compact_count_scan(*search)
    with pytest.raises(ValueError):
        kernels.compact_zml_scan(*search)


def test_mem2_wrappers_refuse_cpu_tensors():
    """The four MEM v2 wrappers launch on CUDA tensors only."""
    r, sigma, n = 3, 4, 10
    rec = torch.zeros((2 * sigma * r + n, 8), dtype=torch.int32)
    init6 = torch.zeros((sigma + 1, 6), dtype=torch.int32)
    alc = torch.zeros((4, 9), dtype=torch.int32)
    st = tm2.entry_state(tm2.MEM2_STATE_KEYS, 4, 9, "cpu")
    with pytest.raises(ValueError):
        kernels.mem2_scan(rec, init6, r, sigma, n, 0, alc, st, 5, 10, False)
    ast = {key: torch.zeros(4, dtype=torch.int32)
           for key in kernels.AM2_STATE_KEYS}
    ast["ends"] = ast["counts"] = torch.zeros((4, 9), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.all_mem2_scan(rec, init6, r, sigma, n, 0, 1, alc, ast, 10)
    slots8 = torch.zeros((4, 9), dtype=torch.int8)
    g = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.kmer2_right_scan(rec, init6, r, sigma, n, 0, slots8, g, g, 5)
    alive = torch.zeros((4, 2), dtype=torch.bool)
    fs = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.kmer2_left_scan(rec, r, sigma, n, 0,
                                torch.zeros((2 * r * 16, 6),
                                            dtype=torch.int32),
                                torch.zeros(r + 1, dtype=torch.int32),
                                slots8, g, g, alive, fs, fs, 5, 2)


def test_mem1_wrappers_refuse_cpu_tensors():
    """The four MEM v1 wrappers launch on CUDA tensors only."""
    r, sigma, n = 3, 4, 10
    n_arr = torch.zeros(r, dtype=torch.int32)
    all_p = torch.zeros(r + 1, dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.pos2rba_build(n_arr, all_p, n)
    with pytest.raises(ValueError):
        kernels.run_dir_build(all_p, n, 0)
    tabs = (torch.zeros((2 * sigma * r, 4), dtype=torch.int32),
            torch.zeros((sigma + 1, 4), dtype=torch.int32), all_p,
            torch.zeros((sigma * r, 2), dtype=torch.int32),
            torch.zeros((n, 2), dtype=torch.int32), None, 0, r, sigma, n)
    al8 = torch.zeros((4, 9), dtype=torch.int8)
    with pytest.raises(ValueError):
        kernels.mem1_scan(*tabs, al8,
                          tm2.entry_state(tm1.MEM1_STATE_KEYS, 4, 9, "cpu"),
                          5, 10)
    st = {key: torch.zeros(4, dtype=torch.int32)
          for key in kernels.AM1_STATE_KEYS}
    st["ends"] = st["counts"] = torch.zeros((4, 9), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.all_mem1_scan(*tabs, al8, st, 10)


def test_dense_and_parallel_wrappers_refuse_cpu_tensors():
    """The wrappers of kernels 14, 15a, 15b and 16a launch on CUDA
    tensors only."""
    codes = torch.zeros((3, 4), dtype=torch.uint8)
    st = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(2))
    with pytest.raises(ValueError):
        kernels.dense_pml_scan(torch.zeros(20, dtype=torch.int32), 5, codes,
                               st)
    ml = torch.zeros((3, 4), dtype=torch.int32)
    with pytest.raises(ValueError):
        kernels.sharded_pml_gather(torch.zeros((6, 2), dtype=torch.int32), 0,
                                   5, (0, 0), codes, 0, None,
                                   torch.zeros((3, 4), dtype=torch.int32),
                                   ml)
    with pytest.raises(ValueError):
        kernels.sharded_search_gather(
            torch.zeros((6, 4), dtype=torch.int32), 0, 3, 4,
            torch.zeros((5, 4), dtype=torch.int32),
            torch.zeros((3, 4), dtype=torch.int8), 0, True, None,
            torch.zeros((6, 4), dtype=torch.int32), ml)
    with pytest.raises(ValueError):
        kernels.classify_from_ml(ml, torch.zeros(4, dtype=torch.int32), 2, 4)


def test_mesh_needs_its_ranks(monkeypatch):
    """Without torch.distributed only the one-rank mesh exists: a larger
    one raises instead of running unsharded; the default device is the
    card, and without one the mesh raises rather than move to the CPU."""
    from movi_tpu_torch import parallel

    one = parallel.make_mesh(1, "cpu")
    assert (one.data, one.model, one.d, one.m) == (1, 1, 0, 0)
    assert one.device == torch.device("cpu") and one.backend is None
    t = torch.arange(4)
    assert one.gather(t, 0) is t
    for shape in ((2, 1), (1, 2)):
        with pytest.raises(RuntimeError, match="torch.distributed"):
            parallel.make_2d_mesh(*shape, device="cpu")
    assert parallel.backend_for(torch.device("cuda", 0)) == "nccl"
    assert parallel.backend_for(torch.device("cpu")) == "gloo"
    assert parallel.backend_for(torch.device("cuda", 0), "gloo") == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        parallel.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.ShardedPMLEngine(tf.build_fused_index(small_index(n=600)[1]))


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.memory_budget_bytes("cpu") > 0
    # every route resolves its device first, the scalar and compact ones
    # too: without a card the default raises before any query runs
    from movi_tpu_torch.api import Index

    text, ix = small_index(n=600)
    reads = mixed_reads(text, count=3)
    unbounded = Index(build_move_index(build_bwt_runs(text), "regular"))
    for index in (Index(ix), unbounded):
        for call in (lambda: index.query_pml(reads, jax=False),
                     lambda: index.query_count(reads),
                     lambda: index.query_zml(reads, jax=False),
                     lambda: index.query_kmers(reads, k=5, jax=False),
                     lambda: index.query_mems(reads, 5, ftab_k=4),
                     lambda: index.multi_classify(reads, None, jax=False),
                     lambda: index.compact_engine("zml"),
                     lambda: index.engine()):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
