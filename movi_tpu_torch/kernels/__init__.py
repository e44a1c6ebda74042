"""Build, load and launch the hand-written CUDA kernels.

At first use, `nvcc` compiles every `movi_tpu_torch/csrc/*.cu` for
`sm_90a` (one process per source, all started together) and links them
into one shared library with a plain C interface, kept in
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
              "-O3", "-Xcompiler", "-fPIC"]

# launches per kernel; each wrapper adds one where it launches, nowhere else
launches = {"fused_pml_scan": 0, "compose_paired_records": 0,
            "fused2_pml_scan": 0, "fused_count_scan": 0,
            "fused_zml_scan": 0, "compose_search2_records": 0,
            "fused2_count_scan": 0, "fused2_zml_scan": 0,
            "fused_color_scan": 0, "compose_paired_color_records": 0,
            "fused2_color_scan": 0}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
# the four search scans share one C signature: (rec_all, init_rec, aux,
# a0, chars, steps, lanes, r, sigma, first, state_in, state_out, out,
# stream); aux is all_p (count) or restart_rec (paired ZML), a0 the paired
# count's first chars, each NULL where the scan takes none
_SEARCH = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_SIGNATURES = {
    "movi_fused_pml_scan": [_P, _P, _I, _I, _I, _I, _I,
                            _P, _P, _P, _P, _P, _P, _P, _P],
    "movi_compose_paired_records": [_P, _I, _I, _I, _I, _P, _P, _P],
    "movi_fused2_pml_scan": [_P, _P, _I, _I, _I, _I, _I, _I,
                             _P, _P, _P, _P, _P, _P, _P, _P],
    "movi_fused_count_scan": _SEARCH,
    "movi_fused_zml_scan": _SEARCH,
    "movi_fused2_count_scan": _SEARCH,
    "movi_fused2_zml_scan": _SEARCH,
    "movi_compose_search2_records": [_P, _P, _P, _P, _P, _I, _I, _P, _P],
    # the color scans: (records, rec_words [, cids] or pair_bytes, codes,
    # steps, lanes, slots, pd_run, pd_off, lens, t0, 5 state in, 5 state
    # out, ml, cid, stream); lens NULL runs without early stop
    "movi_fused_color_scan": [_P, _I, _P, _P, _I, _I, _I, _I, _I, _P, _I,
                              *[_P] * 13],
    "movi_compose_paired_color_records": [_P, _P, _I, _I, _I, _I, _P, _P,
                                          _P],
    "movi_fused2_color_scan": [_P, _I, _P, _I, _I, _I, _I, _I, _P, _I,
                               *[_P] * 13],
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
    path.  Raises if any compile or the link fails."""
    srcs = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in srcs:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read())
    so = os.path.join(BUILD_DIR, f"movi_kernels_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in srcs if p.endswith(".cu")):
            obj = os.path.join(tmp, os.path.basename(src) + ".o")
            log = open(obj + ".log", "w+")
            cmd = [nvcc, *NVCC_FLAGS, "-c", src, "-o", obj]
            jobs.append((cmd, obj, log, subprocess.Popen(
                cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for cmd, _, log, proc in jobs:
            rc = proc.wait()
            log.seek(0)
            if rc != 0:
                failed.append(f"{' '.join(cmd)} (rc {rc}):\n{log.read()}")
            log.close()
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        out = os.path.join(tmp, "movi_kernels.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", out,
               *[obj for _, obj, _, _ in jobs]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(out, so)  # atomic: a concurrent loader sees all or nothing
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


def compose_paired_color_records(records1: torch.Tensor, cids: torch.Tensor,
                                 r: int, slots: int, p_dollar):
    """Kernel B: the paired color table int32 [r*slots^2, 8] from the
    one-step records int32 [r*slots, 2] and the clamped color ids int32
    [r].  Returns (table, (b_min, b_max))."""
    dev = records1.device
    if dev.type != "cuda":
        raise ValueError("compose_paired_color_records launches on CUDA "
                         "tensors only")
    _check(records1, "records1", torch.int32, dev, (r * slots, 2))
    _check(cids, "cids", torch.int32, dev, (r,))
    out = torch.empty((r * slots * slots, 8), dtype=torch.int32, device=dev)
    bminmax = torch.tensor([2**31 - 1, -2**31], dtype=torch.int32,
                           device=dev)
    lib = _load()
    code = lib.movi_compose_paired_color_records(
        records1.data_ptr(), cids.data_ptr(), r, slots, int(p_dollar[0]),
        int(p_dollar[1]), out.data_ptr(), bminmax.data_ptr(), _stream(dev))
    _raise_on(code, "compose_paired_color_records")
    launches["compose_paired_color_records"] += 1
    bmin, bmax = bminmax.tolist()
    return out, (bmin, bmax)


def _color_scan(entry: str, counter: str, records, codes, code_dtypes,
                slots: int, p_dollar, state, lens, t0: int, rows_per_step,
                lead):
    """Shared launch of the two color scans: check, allocate, launch.
    state is (idx, off, ml) int32 [lanes], plus (csum int64, stop int32)
    when lens (int32 [lanes]) asks for early stop; the outputs are then
    zero-filled, so rows past a lane's retirement read zero.  `lead` are
    the entry's arguments between the records and the codes pointer."""
    dev = records.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check(records, "records", torch.int32, dev)
    if codes.dtype not in code_dtypes:
        raise ValueError(f"codes have dtype {codes.dtype}, expected one "
                         f"of {code_dtypes}")
    if codes.dim() != 2:
        raise ValueError("codes must be [steps, lanes]")
    _check(codes, "codes", codes.dtype, dev)
    steps, lanes = codes.shape
    es = lens is not None
    if len(state) != (5 if es else 3):
        raise ValueError("state is (idx, off, ml), plus (csum, stop) with "
                         "lens")
    for i, s in enumerate(state):
        _check(s, f"state[{i}]", torch.int64 if i == 3 else torch.int32,
               dev, (lanes,))
    if es:
        _check(lens, "lens", torch.int32, dev, (lanes,))
    new_state = tuple(torch.empty_like(s) for s in state)
    fill = torch.zeros if es else torch.empty
    ml = fill((rows_per_step * steps, lanes), dtype=torch.int32, device=dev)
    cid = fill((rows_per_step * steps, lanes), dtype=torch.int32, device=dev)
    es_ptrs = ([state[3].data_ptr(), state[4].data_ptr()] if es
               else [None, None])
    es_out = ([new_state[3].data_ptr(), new_state[4].data_ptr()] if es
              else [None, None])
    lib = _load()
    code = getattr(lib, entry)(
        records.data_ptr(), *lead, codes.data_ptr(), steps, lanes, slots,
        int(p_dollar[0]), int(p_dollar[1]),
        None if lens is None else lens.data_ptr(), int(t0),
        *[s.data_ptr() for s in state[:3]], *es_ptrs,
        *[s.data_ptr() for s in new_state[:3]], *es_out,
        ml.data_ptr(), cid.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    return new_state, ml, cid


def fused_color_scan(records: torch.Tensor, slots: int, p_dollar,
                     alphas_t: torch.Tensor, state, cids=None, lens=None,
                     t0: int = 0):
    """Kernel A: one-step PML and color ids over alphas_t [W, lanes]
    (uint8 slots), from the 3-word color records int32 [rows, 3], or from
    the PML records int32 [rows, 2] and cids int32 [r].  With lens, early
    stop from global step t0.  Returns (state, ml, cid [W, lanes])."""
    words = 3 if cids is None else 2
    if records.dim() != 2 or records.shape[1] != words:
        raise ValueError(f"records must be [rows, {words}]"
                         + ("" if cids is None else " with cids"))
    if cids is not None:
        _check(cids, "cids", torch.int32, records.device,
               (records.shape[0] // slots,))
    return _color_scan("movi_fused_color_scan", "fused_color_scan", records,
                       alphas_t, (torch.uint8,), slots, p_dollar, state,
                       lens, t0, 1,
                       (words, None if cids is None else cids.data_ptr()))


def fused2_color_scan(records: torch.Tensor, slots: int, p_dollar,
                      a12_t: torch.Tensor, state, lens=None, t0: int = 0):
    """Kernel C: paired PML and color ids over a12_t [W2, lanes] (uint8
    or int32 pair codes) on the 8-word color records.  With lens, early
    stop from global step t0 (even).  Returns (state, ml, cid [2*W2,
    lanes])."""
    if records.dim() != 2 or records.shape[1] != 8:
        raise ValueError("records must be [rows, 8]")
    if t0 % 2:
        raise ValueError("a paired scan starts on a pair boundary (even "
                         "t0)")
    return _color_scan("movi_fused2_color_scan", "fused2_color_scan",
                       records, a12_t, (torch.uint8, torch.int32), slots,
                       p_dollar, state, lens, t0, 2,
                       (a12_t.element_size(),))


SEARCH_STATE_ROWS = 6  # (rs, os, re, oe) + (matched, done) or (have, ml)


def _search_scan(entry: str, counter: str, rec_all, rec_shape, init_rec,
                 aux, chars, char_dtype, r: int, sigma: int, state, a0,
                 out_rows: int):
    """Shared launch of the four search scans: check, allocate, launch.
    state None starts the scan (from a0 when given, else from the first
    row of chars for the one-step scans, else from nothing matched);
    `aux` is (tensor, name, shape) or None.  out_rows 0 gives count
    [lanes], else ml [out_rows, lanes]."""
    dev = rec_all.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check(rec_all, "rec_all", torch.int32, dev, rec_shape)
    _check(init_rec, "init_rec", torch.int32, dev, (sigma + 1, 4))
    if aux is not None:
        _check(aux[0], aux[1], torch.int32, dev, aux[2])
    if chars.dim() != 2:
        raise ValueError("chars must be [steps, lanes]")
    _check(chars, "chars", char_dtype, dev)
    steps, lanes = chars.shape
    if state is not None:
        _check(state, "state", torch.int32, dev, (SEARCH_STATE_ROWS, lanes))
    if a0 is not None:
        _check(a0, "a0", torch.int8, dev, (lanes,))
    new_state = torch.empty((SEARCH_STATE_ROWS, lanes), dtype=torch.int32,
                            device=dev)
    out = torch.empty((out_rows, lanes) if out_rows else (lanes,),
                      dtype=torch.int32, device=dev)
    lib = _load()
    code = getattr(lib, entry)(
        rec_all.data_ptr(), init_rec.data_ptr(),
        None if aux is None else aux[0].data_ptr(),
        None if a0 is None else a0.data_ptr(), chars.data_ptr(),
        steps, lanes, r, sigma, int(state is None),
        None if state is None else state.data_ptr(), new_state.data_ptr(),
        out.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    return new_state, out


def _first_char_needed(state, alphas_t):
    if state is None and alphas_t.shape[0] == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")


def fused_count_scan(rec_all, init_rec, all_p, r: int, sigma: int,
                     alphas_t: torch.Tensor, state=None):
    """Kernel 4, count: one-step backward search over alphas_t [W, lanes]
    (int8 chars).  Returns (state [6, lanes], count [lanes])."""
    _first_char_needed(state, alphas_t)
    return _search_scan("movi_fused_count_scan", "fused_count_scan",
                        rec_all, (2 * sigma * r, 4), init_rec,
                        (all_p, "all_p", (r + 1,)), alphas_t, torch.int8,
                        r, sigma, state, None, 0)


def fused_zml_scan(rec_all, init_rec, r: int, sigma: int,
                   alphas_t: torch.Tensor, state=None):
    """Kernel 4, ZML: returns (state [6, lanes], ml [W, lanes])."""
    _first_char_needed(state, alphas_t)
    return _search_scan("movi_fused_zml_scan", "fused_zml_scan", rec_all,
                        (2 * sigma * r, 4), init_rec, None, alphas_t,
                        torch.int8, r, sigma, state, None,
                        alphas_t.shape[0])


def _pair_sigma(sigma: int):
    if sigma > 6:
        raise ValueError(f"pair codes hold sigma <= 6 chars, got {sigma}")


def fused2_count_scan(rec_all, init_rec, all_p, r: int, sigma: int,
                      pairs_t: torch.Tensor, state=None, a0=None):
    """Kernel 6, count: paired backward search over pairs_t [W2, lanes]
    (uint8 pair codes), from the first chars a0 [lanes] (int8) or from
    state.  Returns (state [6, lanes], count [lanes])."""
    _pair_sigma(sigma)
    if (state is None) == (a0 is None):
        raise ValueError("give either the first chars a0 or a state")
    return _search_scan("movi_fused2_count_scan", "fused2_count_scan",
                        rec_all, (2 * r * sigma * sigma, 6), init_rec,
                        (all_p, "all_p", (r + 1,)), pairs_t, torch.uint8,
                        r, sigma, state, a0, 0)


def fused2_zml_scan(rec_all, init_rec, restart_rec, r: int, sigma: int,
                    pairs_t: torch.Tensor, state=None):
    """Kernel 6, ZML: returns (state [6, lanes], ml [2*W2, lanes])."""
    _pair_sigma(sigma)
    return _search_scan("movi_fused2_zml_scan", "fused2_zml_scan", rec_all,
                        (2 * r * sigma * sigma, 6), init_rec,
                        (restart_rec, "restart_rec", (sigma * sigma, 5)),
                        pairs_t, torch.uint8, r, sigma, state, None,
                        2 * pairs_t.shape[0])


def compose_search2_records(id_a, off_a, n_a, nu, nd, r: int, sigma: int):
    """Kernel 5: the paired search table int32 [2*r*sigma^2, 6] from the
    run arrays id/offset/n int32 [r] and the next-run tables nu/nd int32
    [sigma, r]."""
    dev = id_a.device
    if dev.type != "cuda":
        raise ValueError("compose_search2_records launches on CUDA tensors "
                         "only")
    for t, name in ((id_a, "id"), (off_a, "offset"), (n_a, "n")):
        _check(t, name, torch.int32, dev, (r,))
    for t, name in ((nu, "nu"), (nd, "nd")):
        _check(t, name, torch.int32, dev, (sigma, r))
    out = torch.empty((2 * r * sigma * sigma, 6), dtype=torch.int32,
                      device=dev)
    lib = _load()
    code = lib.movi_compose_search2_records(
        id_a.data_ptr(), off_a.data_ptr(), n_a.data_ptr(), nu.data_ptr(),
        nd.data_ptr(), r, sigma, out.data_ptr(), _stream(dev))
    _raise_on(code, "compose_search2_records")
    launches["compose_search2_records"] += 1
    return out
