"""Build, load and launch the hand-written CUDA kernels.

At first use, `nvcc` compiles every `movi_tpu_torch/csrc/*.cu` for
`sm_90a` into one shared library with a plain C interface, kept in
`movi_tpu_torch/_build/` under a hash of the sources and flags, and loads
it with ctypes.  Each C entry launches on PyTorch's current stream and
returns `cudaGetLastError()`; the wrappers here check their tensors,
launch, raise on a nonzero code, and count their launches in `launches`.

Nothing here is imported or built for a CPU tensor: the engines route
CPU tensors to the plain PyTorch versions and only CUDA tensors here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Tuple

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

# launches per kernel; each wrapper adds one where it launches, nowhere else
launches = {"fused_pml_scan": 0, "compose_paired_records": 0,
            "fused2_pml_scan": 0}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "movi_fused_pml_scan": [_P, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "movi_compose_paired_records": [_P, _I, _I, _I, _I, _P, _P, _P],
    "movi_fused2_pml_scan": [_P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P],
}


def reset_launches():
    for k in launches:
        launches[k] = 0


def _sources():
    return sorted(os.path.join(SRC_DIR, f) for f in os.listdir(SRC_DIR)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> str:
    """Compile csrc/*.cu into one .so (cached by content); return its
    path.  Raises if the build fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"movi_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[p for p in srcs if p.endswith(".cu")]]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                           f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


def _load():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check(t: torch.Tensor, name: str, dtype, device, shape=None):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")


def _raise_on(code: int, name: str):
    if code != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {code}")


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _scan(entry: str, counter: str, records, rec_words: int, codes,
          code_dtypes, slots: int, p_dollar, state, rows_per_step: int,
          lead=()):
    """Shared launch of the two PML scans: check, allocate, launch.
    `lead` are the entry's arguments between the codes and the widths."""
    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    if records.dim() != 2 or records.shape[1] != rec_words:
        raise ValueError(f"records must be [rows, {rec_words}]")
    _check(records, "records", torch.int32, dev)
    if codes.dtype not in code_dtypes:
        raise ValueError(f"codes have dtype {codes.dtype}, expected one "
                         f"of {code_dtypes}")
    if codes.dim() != 2:
        raise ValueError("codes must be [steps, lanes]")
    _check(codes, "codes", codes.dtype, dev)
    steps, lanes = codes.shape
    for i, s in enumerate(state):
        _check(s, f"state[{i}]", torch.int32, dev, (lanes,))
    new_state = tuple(torch.empty_like(s) for s in state)
    ml = torch.empty((rows_per_step * steps, lanes), dtype=torch.int32,
                     device=dev)
    lib = _load()
    code = getattr(lib, entry)(
        records.data_ptr(), codes.data_ptr(), *lead, steps, lanes, slots,
        int(p_dollar[0]), int(p_dollar[1]),
        *[s.data_ptr() for s in state], *[s.data_ptr() for s in new_state],
        ml.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    return new_state, ml


def fused_pml_scan(records: torch.Tensor, slots: int, p_dollar,
                   alphas_t: torch.Tensor,
                   state) -> Tuple[tuple, torch.Tensor]:
    """Kernel 1: one-step PML over alphas_t [W, lanes] (uint8 slots) from
    state (idx, off, ml) int32 [lanes].  Returns (state, ml [W, lanes])."""
    return _scan("movi_fused_pml_scan", "fused_pml_scan", records, 2,
                 alphas_t, (torch.uint8,), slots, p_dollar, state, 1)


def fused2_pml_scan(records: torch.Tensor, slots: int, p_dollar,
                    a12_t: torch.Tensor, state) -> Tuple[tuple, torch.Tensor]:
    """Kernel 3: paired PML over a12_t [W2, lanes] (uint8 or int32 pair
    codes).  Returns (state, ml [2*W2, lanes])."""
    return _scan("movi_fused2_pml_scan", "fused2_pml_scan", records, 4,
                 a12_t, (torch.uint8, torch.int32), slots, p_dollar, state,
                 2, lead=(a12_t.element_size(),))


def compose_paired_records(records1: torch.Tensor, r: int, slots: int,
                           p_dollar):
    """Kernel 2: the paired table int32 [r*slots^2, 4] from the one-step
    records int32 [r*slots, 2].  Returns (table, (b_min, b_max))."""
    dev = records1.device
    if dev.type != "cuda":
        raise ValueError("compose_paired_records launches on CUDA tensors "
                         "only")
    _check(records1, "records1", torch.int32, dev, (r * slots, 2))
    out = torch.empty((r * slots * slots, 4), dtype=torch.int32, device=dev)
    bminmax = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                           device=dev)
    lib = _load()
    code = lib.movi_compose_paired_records(
        records1.data_ptr(), r, slots, int(p_dollar[0]), int(p_dollar[1]),
        out.data_ptr(), bminmax.data_ptr(), _stream(dev))
    _raise_on(code, "compose_paired_records")
    launches["compose_paired_records"] += 1
    bmin, bmax = bminmax.tolist()
    return out, (bmin, bmax)
