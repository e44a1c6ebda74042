"""The port never imports JAX, and its wrappers never reach the CUDA
kernel loader for a CPU tensor."""

import os
import subprocess
import sys

import pytest
import torch

import movi_tpu_torch
from movi_tpu_torch import device, kernels
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.engine import fused_color as tfc
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.testing import small_color_index, small_index

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


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    def no_loader(*_a, **_k):
        raise AssertionError("kernel loader touched for a CPU tensor")

    monkeypatch.setattr(kernels, "_load", no_loader)
    monkeypatch.setattr(kernels, "build", no_loader)
    kernels.reset_launches()
    _, ix = small_index(n=600)
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
    assert all(v == 0 for v in kernels.launches.values())
    assert set(kernels.launches) == {"fused_pml_scan",
                                     "compose_paired_records",
                                     "fused2_pml_scan", "fused_count_scan",
                                     "fused_zml_scan",
                                     "compose_search2_records",
                                     "fused2_count_scan", "fused2_zml_scan",
                                     "fused_color_scan",
                                     "compose_paired_color_records",
                                     "fused2_color_scan"}


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


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.memory_budget_bytes("cpu") > 0
