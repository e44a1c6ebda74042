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
from movi_tpu_torch.testing import small_index

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
    assert all(v == 0 for v in kernels.launches.values())
    assert set(kernels.launches) == {"fused_pml_scan",
                                     "compose_paired_records",
                                     "fused2_pml_scan"}


def test_kernel_wrappers_refuse_cpu_tensors():
    rec = torch.zeros((10, 2), dtype=torch.int32)
    st = tuple(torch.zeros(4, dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError):
        kernels.fused_pml_scan(rec, 5, (0, 0),
                               torch.zeros((3, 4), dtype=torch.uint8), st)
    with pytest.raises(ValueError):
        kernels.compose_paired_records(rec, 2, 5, (0, 0))


def test_no_silent_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    assert device.memory_budget_bytes("cpu") > 0
