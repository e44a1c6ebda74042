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
            "fused2_color_scan": 0, "fused_sa_pre_scan": 0, "sa_walk": 0,
            "kmer_member_scan": 0, "kmer_count_scan": 0,
            "fused2_kmer_count_scan": 0, "prep_alc": 0, "mem2_scan": 0,
            "all_mem2_scan": 0, "kmer2_right_scan": 0,
            "kmer2_left_scan": 0, "compact_pml_scan": 0,
            "compact_count_scan": 0, "compact_zml_scan": 0,
            "pos2rba_build": 0, "mem1_scan": 0, "all_mem1_scan": 0}

_lib = None
_lib_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# the four search scans share one C signature: (rec_all, init_rec, aux,
# a0, chars, steps, lanes, r, sigma, first, state_in, state_out, out,
# stream); aux is all_p (count) or restart_rec (paired ZML), a0 the paired
# count's first chars, each NULL where the scan takes none
_SEARCH = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_KMER_COUNT = [_P, _P, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P, _P]
# the compact count and ZML scans: (n, lf_abs, all_p, c_search, ch_up_s,
# ch_down_s, first_runs, first_offsets, last_runs, last_offsets, r, sigma,
# codes, W, lanes, first, state in, state out, out, stream)
_COMPACT_SEARCH = [*[_P] * 10, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P]
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
    # (records, pre_tab, codes, steps, lanes, slots, pd_run, pd_off, 3 state
    # in, 3 state out, ml, pre_idx, pre_off, stream)
    "movi_fused_sa_pre_scan": [_P, _P, _P, _I, _I, _I, _I, _I, *[_P] * 10],
    # (records, slots, all_p, sampled, rate, max_steps, idx, off, n, out,
    # stream)
    "movi_sa_walk": [_P, _I, _P, _P, _LL, _LL, _P, _P, _LL, _P, _P],
    # (rec_all, init_rec, alc, W, alc_w, lanes, r, sigma, fk, k, ticks,
    # use_ftab, state in, state out, out, work, stream)
    "movi_kmer_member_scan": [_P, _P, _P, *[_I] * 7, _LL, _I, *[_P] * 5],
    # the two k-mer counts: (rec_all, init_rec, all_p, slots, W, lane,
    # start, nk, r, sigma, k, found, cnt, stream)
    "movi_kmer_count_scan": _KMER_COUNT,
    "movi_fused2_kmer_count_scan": _KMER_COUNT,
    # (slots, lanes, W, fk, out, stream)
    "movi_prep_alc": [_P, _I, _I, _I, _P, _P],
    # (rec_all, init6, alc, W, alc_w, lanes, r, sigma, n, fk, L, ticks,
    # use_ftab, state in, state out, ends, counts, work, stream)
    "movi_mem2_scan": [_P, _P, _P, *[_I] * 8, _LL, _I, *[_P] * 6],
    # (rec_all, init6, alc, W, lanes, r, sigma, n, p1, ticks, state in,
    # state out, ends, counts, work, stream)
    "movi_all_mem2_scan": [_P, _P, _P, *[_I] * 6, _LL, *[_P] * 6],
    # (rec_all, init6, slots, W, own, anchor, G, r, sigma, k, alive, fs,
    # fe, stream)
    "movi_kmer2_right_scan": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _I,
                              *[_P] * 4],
    # (m2 rec_all, r, sigma, n, s2 rec_all, s2 all_p, slots, W, own,
    # anchor, G, k, p, alive, fs, fe, found, count, stream)
    "movi_kmer2_left_scan": [_P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I,
                             _I, _I, *[_P] * 6],
    # (n, lf_abs, all_p, c, thr_full, rep_up, rep_down, codes, W, lanes, r,
    # sigma, rpml, 3 state in, 3 state out, ml, err, stream)
    "movi_compact_pml_scan": [*[_P] * 8, *[_I] * 5, *[_P] * 9],
    "movi_compact_count_scan": _COMPACT_SEARCH,
    "movi_compact_zml_scan": _COMPACT_SEARCH,
    # (n_arr, all_p, r, n, out, stream)
    "movi_pos2rba_build": [_P, _P, _I, _I, _P, _P],
    # (rec_all, init_rec, all_p, skip_rec, pos2rba or NULL, r, sigma, n,
    # alphas, W, lanes, L, ticks, state in, state out, ends, counts, work,
    # stream)
    "movi_mem1_scan": [*[_P] * 5, _I, _I, _I, _P, _I, _I, _I, _LL,
                       *[_P] * 6],
    # the same without L
    "movi_all_mem1_scan": [*[_P] * 5, _I, _I, _I, _P, _I, _I, _LL,
                           *[_P] * 6],
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


def fused_sa_pre_scan(records: torch.Tensor, pre_tab: torch.Tensor,
                      slots: int, p_dollar, alphas_t: torch.Tensor, state):
    """Kernel 8a: the one-step PML scan over alphas_t [W, lanes] (uint8
    slots) from state (idx, off, ml) int32 [lanes], also writing each
    base's pre-LF (run, offset) from pre_tab int32 [rows, 3].  Returns
    (state, ml, pre_idx, pre_off), the last three int32 [W, lanes]."""
    dev = records.device
    if dev.type != "cuda":
        raise ValueError("fused_sa_pre_scan launches on CUDA tensors only")
    if records.dim() != 2 or records.shape[1] != 2:
        raise ValueError("records must be [rows, 2]")
    _check(records, "records", torch.int32, dev)
    _check(pre_tab, "pre_tab", torch.int32, dev, (records.shape[0], 3))
    if alphas_t.dim() != 2:
        raise ValueError("codes must be [steps, lanes]")
    _check(alphas_t, "codes", torch.uint8, dev)
    steps, lanes = alphas_t.shape
    for i, s in enumerate(state):
        _check(s, f"state[{i}]", torch.int32, dev, (lanes,))
    new_state = tuple(torch.empty_like(s) for s in state)
    ml, pre_idx, pre_off = (torch.empty((steps, lanes), dtype=torch.int32,
                                        device=dev) for _ in range(3))
    lib = _load()
    code = lib.movi_fused_sa_pre_scan(
        records.data_ptr(), pre_tab.data_ptr(), alphas_t.data_ptr(), steps,
        lanes, slots, int(p_dollar[0]), int(p_dollar[1]),
        *[s.data_ptr() for s in state], *[s.data_ptr() for s in new_state],
        ml.data_ptr(), pre_idx.data_ptr(), pre_off.data_ptr(), _stream(dev))
    _raise_on(code, "fused_sa_pre_scan")
    launches["fused_sa_pre_scan"] += 1
    return new_state, ml, pre_idx, pre_off


def sa_walk(records: torch.Tensor, slots: int, all_p: torch.Tensor,
            sampled: torch.Tensor, rate: int, max_steps: int,
            idx: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """Kernel 8b: LF-walk every flat (run, offset) int32 [n] to a row whose
    absolute position is a multiple of rate, through the one-step records
    int32 [r*slots, 2] and the run starts all_p int64 [r]; returns the SA
    values sampled[pos / rate] + steps, int64 [n] (-1 for a walk past
    max_steps)."""
    dev = records.device
    if dev.type != "cuda":
        raise ValueError("sa_walk launches on CUDA tensors only")
    if records.dim() != 2 or records.shape[1] != 2 or \
            records.shape[0] % slots:
        raise ValueError("records must be [r*slots, 2]")
    _check(records, "records", torch.int32, dev)
    _check(all_p, "all_p", torch.int64, dev, (records.shape[0] // slots,))
    if sampled.dim() != 1:
        raise ValueError("sampled must be 1-D")
    _check(sampled, "sampled", torch.int64, dev)
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    _check(idx, "idx", torch.int32, dev)
    _check(off, "off", torch.int32, dev, tuple(idx.shape))
    if int(rate) <= 0:
        raise ValueError(f"rate must be positive, got {rate}")
    out = torch.empty(idx.shape, dtype=torch.int64, device=dev)
    lib = _load()
    code = lib.movi_sa_walk(
        records.data_ptr(), slots, all_p.data_ptr(), sampled.data_ptr(),
        int(rate), int(max_steps), idx.data_ptr(), off.data_ptr(),
        idx.numel(), out.data_ptr(), _stream(dev))
    _raise_on(code, "sa_walk")
    launches["sa_walk"] += 1
    return out


# the membership machine's registers, in the rows of its [10, lanes] state
KMER_STATE_KEYS = ("phase", "pos", "cur", "pc", "pok", "pinit", "rs", "os",
                   "re", "oe")
MAX_FTAB_K = 15  # a fk-mer code is 2*fk bits of an int32


def kmer_member_scan(rec_all, init_rec, r: int, sigma: int, ftab_k: int,
                     alc: torch.Tensor, state, k: int, ticks: int,
                     use_ftab: bool):
    """Kernel 9a: the k-mer membership machine over alc int32 [lanes, W]
    (read-order slots) or, with use_ftab, [lanes, 2W] (slots and fk-mer
    codes), on the one-step search records int32 [2*sigma*r (+ 4^ftab_k),
    4].  state: the int32 [lanes] registers of KMER_STATE_KEYS and out
    int32 [lanes, W].  Each lane runs until it is done or has run `ticks`
    ticks.  Returns (state, work int32 [2, lanes]: the ticks each lane ran
    and the 16 B record rows it loaded)."""
    dev = alc.device
    if dev.type != "cuda":
        raise ValueError("kmer_member_scan launches on CUDA tensors only")
    rows = 2 * sigma * r + (4 ** ftab_k if ftab_k > 1 else 0)
    _check(rec_all, "rec_all", torch.int32, dev, (rows, 4))
    _check(init_rec, "init_rec", torch.int32, dev, (sigma + 1, 4))
    if alc.dim() != 2:
        raise ValueError("alc must be [lanes, W] or [lanes, 2W]")
    _check(alc, "alc", torch.int32, dev)
    lanes, alc_w = alc.shape
    if use_ftab and (alc_w % 2 or not 1 < ftab_k <= MAX_FTAB_K):
        raise ValueError("ftab anchors need alc [lanes, 2W] and an index "
                         "with 1 < ftab_k <= 15 rows")
    W = alc_w // 2 if use_ftab else alc_w
    if W < 1 or ticks < 0:
        raise ValueError("a membership scan needs W >= 1 and ticks >= 0")
    st_in = torch.stack([state[key] for key in KMER_STATE_KEYS])
    _check(st_in, "state", torch.int32, dev, (len(KMER_STATE_KEYS), lanes))
    _check(state["out"], "out", torch.int32, dev, (lanes, W))
    out = state["out"].clone()
    st_out = torch.empty_like(st_in)
    work = torch.empty((2, lanes), dtype=torch.int32, device=dev)
    lib = _load()
    code = lib.movi_kmer_member_scan(
        rec_all.data_ptr(), init_rec.data_ptr(), alc.data_ptr(), W, alc_w,
        lanes, r, sigma, ftab_k, k, int(ticks), int(use_ftab),
        st_in.data_ptr(), st_out.data_ptr(), out.data_ptr(),
        work.data_ptr(), _stream(dev))
    _raise_on(code, "kmer_member_scan")
    launches["kmer_member_scan"] += 1
    new_state = dict(zip(KMER_STATE_KEYS, st_out.unbind(0)))
    new_state["out"] = out
    return new_state, work


def _kmer_count(entry: str, counter: str, rec_all, rec_shape, init_rec,
                all_p, r: int, sigma: int, slots, lane, start, k: int):
    """Shared launch of the two exact k-mer counts: check, allocate,
    launch.  Returns (found bool [nk], count int32 [nk])."""
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check(rec_all, "rec_all", torch.int32, dev, rec_shape)
    _check(init_rec, "init_rec", torch.int32, dev, (sigma + 1, 4))
    _check(all_p, "all_p", torch.int32, dev, (r + 1,))
    if slots.dim() != 2 or lane.dim() != 1:
        raise ValueError("slots must be [lanes, W] and lane, start [nk]")
    _check(slots, "slots", torch.int8, dev)
    _check(lane, "lane", torch.int32, dev)
    _check(start, "start", torch.int32, dev, tuple(lane.shape))
    W = slots.shape[1]
    if not 1 <= k <= W:
        raise ValueError(f"k = {k} must be in [1, W = {W}]")
    nk = lane.shape[0]
    found = torch.empty(nk, dtype=torch.bool, device=dev)
    cnt = torch.empty(nk, dtype=torch.int32, device=dev)
    lib = _load()
    code = getattr(lib, entry)(
        rec_all.data_ptr(), init_rec.data_ptr(), all_p.data_ptr(),
        slots.data_ptr(), W, lane.data_ptr(), start.data_ptr(), nk, r, sigma,
        k, found.data_ptr(), cnt.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    return found, cnt


def kmer_count_scan(rec_all, init_rec, all_p, r: int, sigma: int, slots,
                    lane, start, k: int):
    """Kernel 9b: exact counts of the k-mers at (lane, start) int32 [nk]
    of the read-order slots int8 [lanes, W] (each start <= W - k), on the
    one-step search records (ftab rows, if any, unused)."""
    rows = rec_all.shape[0] if rec_all.dim() == 2 else -1
    if rows < 2 * sigma * r:
        raise ValueError("rec_all must hold the 2*sigma*r search records")
    return _kmer_count("movi_kmer_count_scan", "kmer_count_scan", rec_all,
                       (rows, 4), init_rec, all_p, r, sigma, slots, lane,
                       start, k)


def fused2_kmer_count_scan(rec_all, init_rec, all_p, r: int, sigma: int,
                           slots, lane, start, k: int):
    """Kernel 7b: the same counts on the paired search records int32
    [2*r*sigma^2, 6], two extensions per step."""
    _pair_sigma(sigma)
    return _kmer_count("movi_fused2_kmer_count_scan",
                       "fused2_kmer_count_scan", rec_all,
                       (2 * r * sigma * sigma, 6), init_rec, all_p, r, sigma,
                       slots, lane, start, k)


def prep_alc(al8: torch.Tensor, fk: int) -> torch.Tensor:
    """Kernel 10a: int8 read-order slots [lanes, W] -> int32 [lanes, W],
    or with fk > 0 [lanes, 2W] with each position's fk-mer code appended
    (-1 where a char is illegal or p < fk-1)."""
    dev = al8.device
    if dev.type != "cuda":
        raise ValueError("prep_alc launches on CUDA tensors only")
    if al8.dim() != 2:
        raise ValueError("slots must be [lanes, W]")
    _check(al8, "slots", torch.int8, dev)
    if not 0 <= fk <= MAX_FTAB_K:
        raise ValueError(f"fk = {fk} must be in [0, {MAX_FTAB_K}]")
    lanes, W = al8.shape
    out = torch.empty((lanes, 2 * W if fk else W), dtype=torch.int32,
                      device=dev)
    lib = _load()
    code = lib.movi_prep_alc(al8.data_ptr(), lanes, W, fk, out.data_ptr(),
                             _stream(dev))
    _raise_on(code, "prep_alc")
    launches["prep_alc"] += 1
    return out


# the MEM machines' registers, in the rows of their [16, lanes] states
MEM2_STATE_KEYS = ("phase", "pos", "jc", "end", "frs", "fos", "fre", "foe",
                   "fas", "fae", "rrs", "ros", "rre", "roe", "ras", "rae")
AM2_STATE_KEYS = ("phase", "s", "ml", "e") + MEM2_STATE_KEYS[4:]


def _check_mem2_table(rec_all, init6, r: int, sigma: int, n: int,
                      ftab_k: int, dev):
    """The MEM v2 table int32 [2*sigma*r + n (+ 4^ftab_k), 8] and init6
    int32 [sigma+1, 6] on dev."""
    if not 0 <= ftab_k <= MAX_FTAB_K:
        raise ValueError(f"ftab_k = {ftab_k} must be in [0, {MAX_FTAB_K}]")
    rows = 2 * sigma * r + n + (4 ** ftab_k if ftab_k > 1 else 0)
    _check(rec_all, "rec_all", torch.int32, dev, (rows, 8))
    if init6 is not None:
        _check(init6, "init_rec6", torch.int32, dev, (sigma + 1, 6))


def _machine(entry: str, counter: str, keys, rec_all, init6, r: int,
             sigma: int, n: int, ftab_k: int, alc, state, W: int, lead,
             ticks: int, tail):
    """Shared launch of the two MEM machines: check, allocate, launch.
    `lead` are the entry's integer arguments between the widths and the
    tick budget, `tail` those between it and the state."""
    dev = alc.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check_mem2_table(rec_all, init6, r, sigma, n, ftab_k, dev)
    _check(alc, "alc", torch.int32, dev)
    lanes = alc.shape[0]
    if W < 1 or ticks < 0:
        raise ValueError("a MEM scan needs W >= 1 and ticks >= 0")
    st_in = torch.stack([state[key] for key in keys])
    _check(st_in, "state", torch.int32, dev, (len(keys), lanes))
    for key in ("ends", "counts"):
        _check(state[key], key, torch.int32, dev, (lanes, W))
    ends, counts = state["ends"].clone(), state["counts"].clone()
    st_out = torch.empty_like(st_in)
    work = torch.empty((2, lanes), dtype=torch.int32, device=dev)
    lib = _load()
    code = getattr(lib, entry)(
        rec_all.data_ptr(), init6.data_ptr(), alc.data_ptr(), *lead,
        int(ticks), *tail, st_in.data_ptr(), st_out.data_ptr(),
        ends.data_ptr(), counts.data_ptr(), work.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    new_state = dict(zip(keys, st_out.unbind(0)))
    new_state["ends"], new_state["counts"] = ends, counts
    return new_state, work


def mem2_scan(rec_all, init6, r: int, sigma: int, n: int, ftab_k: int,
              alc: torch.Tensor, state, L: int, ticks: int, use_ftab: bool):
    """Kernel 10b: the BML machine over alc int32 [lanes, W] (read-order
    slots) or, with use_ftab, [lanes, 2W] (slots and fk-mer codes), on the
    MEM v2 table.  state: the int32 [lanes] registers of MEM2_STATE_KEYS
    (a lane at phase -1, ENTRY, starts from its slots), ends and counts
    int32 [lanes, W].  Each lane runs until it is done or has run `ticks`
    ticks.  Returns (state, work int32 [2, lanes]: the
    ticks each lane ran and the 32 B rows it loaded)."""
    if alc.dim() != 2:
        raise ValueError("alc must be [lanes, W] or [lanes, 2W]")
    alc_w = alc.shape[1]
    if use_ftab and (alc_w % 2 or ftab_k <= 1):
        raise ValueError("ftab anchors need alc [lanes, 2W] and a table "
                         "with ftab_k > 1 rows")
    if L < 2:
        raise ValueError(f"BML needs L >= 2, got {L}")
    W = alc_w // 2 if use_ftab else alc_w
    return _machine("movi_mem2_scan", "mem2_scan", MEM2_STATE_KEYS, rec_all,
                    init6, r, sigma, n, ftab_k, alc, state, W,
                    (W, alc_w, alc.shape[0], r, sigma, n, ftab_k, L), ticks,
                    (int(use_ftab),))


def all_mem2_scan(rec_all, init6, r: int, sigma: int, n: int, ftab_k: int,
                  p1: int, alc: torch.Tensor, state, ticks: int):
    """Kernel 10c: the all-MEMs machine over alc int32 [lanes, W], from
    the registers of AM2_STATE_KEYS (p1: the canonical empty interval's
    abs start).  Returns (state, work) as kernel 10b."""
    if alc.dim() != 2:
        raise ValueError("alc must be [lanes, W]")
    W = alc.shape[1]
    return _machine("movi_all_mem2_scan", "all_mem2_scan", AM2_STATE_KEYS,
                    rec_all, init6, r, sigma, n, ftab_k, alc, state, W,
                    (W, alc.shape[0], r, sigma, n, p1), ticks, ())


def _check_groups(slots, own, anchor, k: int, dev):
    if slots.dim() != 2 or own.dim() != 1:
        raise ValueError("slots must be [lanes, W] and own, anchor [G]")
    _check(slots, "slots", torch.int8, dev)
    _check(own, "own", torch.int32, dev)
    _check(anchor, "anchor", torch.int32, dev, tuple(own.shape))
    if not 2 <= k <= slots.shape[1]:
        raise ValueError(f"k = {k} must be in [2, W = {slots.shape[1]}]")


def kmer2_right_scan(rec_all, init6, r: int, sigma: int, n: int,
                     ftab_k: int, slots, own, anchor, k: int):
    """Kernel 11a: per group, init at slots[own, anchor] and k-1
    extend_right steps with the chars after it, on the MEM v2 table (each
    anchor <= W - k).  Returns (alive bool, fw_abs_s, fw_abs_e int32),
    each [k-1, G]."""
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError("kmer2_right_scan launches on CUDA tensors only")
    _check_mem2_table(rec_all, init6, r, sigma, n, ftab_k, dev)
    _check_groups(slots, own, anchor, k, dev)
    G = own.shape[0]
    alive = torch.empty((k - 1, G), dtype=torch.bool, device=dev)
    fs, fe = (torch.empty((k - 1, G), dtype=torch.int32, device=dev)
              for _ in range(2))
    lib = _load()
    code = lib.movi_kmer2_right_scan(
        rec_all.data_ptr(), init6.data_ptr(), slots.data_ptr(),
        slots.shape[1], own.data_ptr(), anchor.data_ptr(), G, r, sigma, k,
        alive.data_ptr(), fs.data_ptr(), fe.data_ptr(), _stream(dev))
    _raise_on(code, "kmer2_right_scan")
    launches["kmer2_right_scan"] += 1
    return alive, fs, fe


def kmer2_left_scan(rec_all, r: int, sigma: int, n: int, ftab_k: int,
                    s2_rec, s2_all_p, slots, own, anchor, alive, fs, fe,
                    k: int, p: int):
    """Kernel 11b: for every (depth d < p, group) whose partial is alive
    after step k-2-d and d <= anchor, resolve its abs interval (fs, fe
    [k-1, G]) through the MEM v2 table's pos2rba rows and take ceil(d/2)
    paired left steps on the paired search records int32
    [2*r*sigma^2, 6].  Returns (found bool, count int32), each [p, G]."""
    dev = slots.device
    if dev.type != "cuda":
        raise ValueError("kmer2_left_scan launches on CUDA tensors only")
    _check_mem2_table(rec_all, None, r, sigma, n, ftab_k, dev)
    _pair_sigma(sigma)
    _check(s2_rec, "s2 rec_all", torch.int32, dev, (2 * r * sigma * sigma, 6))
    _check(s2_all_p, "s2 all_p", torch.int32, dev, (r + 1,))
    _check_groups(slots, own, anchor, k, dev)
    G = own.shape[0]
    if not 1 <= p <= k - 1:
        raise ValueError(f"p = {p} must be in [1, k-1 = {k - 1}]")
    _check(alive, "alive", torch.bool, dev, (k - 1, G))
    _check(fs, "fs", torch.int32, dev, (k - 1, G))
    _check(fe, "fe", torch.int32, dev, (k - 1, G))
    found = torch.empty((p, G), dtype=torch.bool, device=dev)
    cnt = torch.empty((p, G), dtype=torch.int32, device=dev)
    lib = _load()
    code = lib.movi_kmer2_left_scan(
        rec_all.data_ptr(), r, sigma, n, s2_rec.data_ptr(),
        s2_all_p.data_ptr(), slots.data_ptr(), slots.shape[1],
        own.data_ptr(), anchor.data_ptr(), G, k, p, alive.data_ptr(),
        fs.data_ptr(), fe.data_ptr(), found.data_ptr(), cnt.data_ptr(),
        _stream(dev))
    _raise_on(code, "kmer2_left_scan")
    launches["kmer2_left_scan"] += 1
    return found, cnt


# ScalarEngine's message where a reposition finds no run either way
NOT_FOUND = "character not found in index"


def _check_runs(tables, dev):
    """The compact tables, (name, tensor, dtype, shape) each, on dev."""
    for name, t, dtype, shape in tables:
        _check(t, name, dtype, dev, shape)


def compact_pml_scan(n, lf_abs, all_p, c, thr_full, rep_up, rep_down,
                     r: int, sigma: int, codes: torch.Tensor, state,
                     random_repositioning: bool):
    """Kernel 12a: compact PML over codes [W, lanes] (int8 chars, -1
    illegal) from state (idx, off, ml) int32 [lanes] on the run tables of
    engine/device_index.py; thr_full may be None with
    random_repositioning.  Returns (state, ml [W, lanes]); raises
    AssertionError(NOT_FOUND) where a reposition finds no run."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError("compact_pml_scan launches on CUDA tensors only")
    if thr_full is None and not random_repositioning:
        raise ValueError("threshold repositioning needs thr_full")
    tables = [("n", n, torch.int32, (r,)),
              ("lf_abs", lf_abs, torch.int32, (r,)),
              ("all_p", all_p, torch.int32, (r + 1,)),
              ("c", c, torch.uint8, (r,)),
              ("rep_up", rep_up, torch.int32, (sigma, r)),
              ("rep_down", rep_down, torch.int32, (sigma, r))]
    if thr_full is not None:
        tables.append(("thr_full", thr_full, torch.int32, (r, sigma)))
    _check_runs(tables, dev)
    if codes.dim() != 2:
        raise ValueError("codes must be [steps, lanes]")
    _check(codes, "codes", torch.int8, dev)
    steps, lanes = codes.shape
    for i, s in enumerate(state):
        _check(s, f"state[{i}]", torch.int32, dev, (lanes,))
    new_state = tuple(torch.empty_like(s) for s in state)
    ml = torch.empty((steps, lanes), dtype=torch.int32, device=dev)
    err = torch.zeros(1, dtype=torch.int32, device=dev)
    lib = _load()
    code = lib.movi_compact_pml_scan(
        n.data_ptr(), lf_abs.data_ptr(), all_p.data_ptr(), c.data_ptr(),
        None if thr_full is None else thr_full.data_ptr(), rep_up.data_ptr(),
        rep_down.data_ptr(), codes.data_ptr(), steps, lanes, r, sigma,
        int(random_repositioning), *[s.data_ptr() for s in state],
        *[s.data_ptr() for s in new_state], ml.data_ptr(), err.data_ptr(),
        _stream(dev))
    _raise_on(code, "compact_pml_scan")
    launches["compact_pml_scan"] += 1
    if int(err.item()):
        raise AssertionError(NOT_FOUND)
    return new_state, ml


def _compact_search(entry: str, counter: str, n, lf_abs, all_p, c_search,
                    ch_up_s, ch_down_s, first_runs, first_offsets, last_runs,
                    last_offsets, r: int, sigma: int, codes, state,
                    out_rows: int):
    """Shared launch of the compact count and ZML scans: check, allocate,
    launch.  state None starts from the first row of codes.  out_rows 0
    gives count [lanes], else ml [out_rows, lanes]."""
    dev = codes.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check_runs([("n", n, torch.int32, (r,)),
                 ("lf_abs", lf_abs, torch.int32, (r,)),
                 ("all_p", all_p, torch.int32, (r + 1,)),
                 ("c_search", c_search, torch.int32, (r,)),
                 ("ch_up_s", ch_up_s, torch.int32, (sigma, r)),
                 ("ch_down_s", ch_down_s, torch.int32, (sigma, r)),
                 *[(name, t, torch.int32, (sigma + 1,)) for name, t in (
                     ("first_runs", first_runs),
                     ("first_offsets", first_offsets),
                     ("last_runs", last_runs),
                     ("last_offsets", last_offsets))]], dev)
    if codes.dim() != 2:
        raise ValueError("codes must be [steps, lanes]")
    _check(codes, "codes", torch.int8, dev)
    steps, lanes = codes.shape
    if state is None and steps == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")
    if state is not None:
        _check(state, "state", torch.int32, dev, (SEARCH_STATE_ROWS, lanes))
    new_state = torch.empty((SEARCH_STATE_ROWS, lanes), dtype=torch.int32,
                            device=dev)
    out = torch.empty((out_rows, lanes) if out_rows else (lanes,),
                      dtype=torch.int32, device=dev)
    lib = _load()
    code = getattr(lib, entry)(
        n.data_ptr(), lf_abs.data_ptr(), all_p.data_ptr(),
        c_search.data_ptr(), ch_up_s.data_ptr(), ch_down_s.data_ptr(),
        first_runs.data_ptr(), first_offsets.data_ptr(),
        last_runs.data_ptr(), last_offsets.data_ptr(), r, sigma,
        codes.data_ptr(), steps, lanes, int(state is None),
        None if state is None else state.data_ptr(), new_state.data_ptr(),
        out.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    return new_state, out


def compact_count_scan(n, lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                       first_runs, first_offsets, last_runs, last_offsets,
                       r: int, sigma: int, codes: torch.Tensor, state=None):
    """Kernel 12b: the compact count scan over codes [W, lanes] (int8
    chars, -1 illegal, -2 past the read).  Returns (state [6, lanes],
    count [lanes])."""
    return _compact_search("movi_compact_count_scan", "compact_count_scan",
                           n, lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                           first_runs, first_offsets, last_runs, last_offsets,
                           r, sigma, codes, state, 0)


def compact_zml_scan(n, lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                     first_runs, first_offsets, last_runs, last_offsets,
                     r: int, sigma: int, codes: torch.Tensor, state=None):
    """Kernel 12c: the compact ZML scan.  Returns (state [6, lanes], ml
    [W, lanes])."""
    return _compact_search("movi_compact_zml_scan", "compact_zml_scan", n,
                           lf_abs, all_p, c_search, ch_up_s, ch_down_s,
                           first_runs, first_offsets, last_runs, last_offsets,
                           r, sigma, codes, state, codes.shape[0])


# the MEM v1 machines' registers, in the rows of their [12, lanes] states
MEM1_STATE_KEYS = ("phase", "pos", "jc", "end", "frs", "fos", "fre", "foe",
                   "rrs", "ros", "rre", "roe")
AM1_STATE_KEYS = ("phase", "s", "ml", "e") + MEM1_STATE_KEYS[4:]
_MEM1_DONE = {"mem1_scan": 4, "all_mem1_scan": 2}  # the machines' DONE


def _check_positions(n: int):
    if not 0 < n < (1 << 31):
        raise ValueError(f"n = {n} BWT rows: the MEM v1 kernels take "
                         f"0 < n < 2^31 (int32 positions)")


def pos2rba_build(n_arr: torch.Tensor, all_p: torch.Tensor, n: int):
    """Kernel 13a: the (run, all_p[run]) row of every BWT row, int32 [n,
    2], from the run lengths n_arr int32 [r] and all_p int32 [r+1]."""
    dev = n_arr.device
    if dev.type != "cuda":
        raise ValueError("pos2rba_build launches on CUDA tensors only")
    if n_arr.dim() != 1:
        raise ValueError("n_arr must be [r]")
    r = n_arr.shape[0]
    _check(n_arr, "n_arr", torch.int32, dev)
    _check(all_p, "all_p", torch.int32, dev, (r + 1,))
    _check_positions(n)
    out = torch.empty((n, 2), dtype=torch.int32, device=dev)
    lib = _load()
    code = lib.movi_pos2rba_build(n_arr.data_ptr(), all_p.data_ptr(), r, n,
                                  out.data_ptr(), _stream(dev))
    _raise_on(code, "pos2rba_build")
    launches["pos2rba_build"] += 1
    return out


def _mem1_machine(counter: str, keys, rec_all, init_rec, all_p, skip_rec,
                  pos2rba, r: int, sigma: int, n: int, alphas, state,
                  ticks: int, L=()):
    """Shared launch of the two MEM v1 machines: check, allocate, launch,
    and raise where a lane is still running after `ticks` ticks."""
    dev = alphas.device
    if dev.type != "cuda":
        raise ValueError(f"{counter} launches on CUDA tensors only")
    _check_positions(n)
    _check(rec_all, "rec_all", torch.int32, dev, (2 * sigma * r, 4))
    _check(init_rec, "init_rec", torch.int32, dev, (sigma + 1, 4))
    _check(all_p, "all_p", torch.int32, dev, (r + 1,))
    _check(skip_rec, "skip_rec", torch.int32, dev, (sigma * r, 2))
    if pos2rba is not None:
        _check(pos2rba, "pos2rba", torch.int32, dev, (n, 2))
    if alphas.dim() != 2:
        raise ValueError("alphas must be [lanes, W]")
    _check(alphas, "alphas", torch.int8, dev)
    lanes, W = alphas.shape
    if W < 1 or ticks < 0:
        raise ValueError("a MEM scan needs W >= 1 and ticks >= 0")
    st_in = torch.stack([state[key] for key in keys])
    _check(st_in, "state", torch.int32, dev, (len(keys), lanes))
    for key in ("ends", "counts"):
        _check(state[key], key, torch.int32, dev, (lanes, W))
    ends, counts = state["ends"].clone(), state["counts"].clone()
    st_out = torch.empty_like(st_in)
    work = torch.empty((2, lanes), dtype=torch.int32, device=dev)
    lib = _load()
    code = getattr(lib, "movi_" + counter)(
        rec_all.data_ptr(), init_rec.data_ptr(), all_p.data_ptr(),
        skip_rec.data_ptr(), None if pos2rba is None else pos2rba.data_ptr(),
        r, sigma, n, alphas.data_ptr(), W, lanes, *L, int(ticks),
        st_in.data_ptr(), st_out.data_ptr(), ends.data_ptr(),
        counts.data_ptr(), work.data_ptr(), _stream(dev))
    _raise_on(code, counter)
    launches[counter] += 1
    if bool((st_out[0] != _MEM1_DONE[counter]).any()):
        raise RuntimeError(f"MEM scan did not converge within {ticks} ticks")
    new_state = dict(zip(keys, st_out.unbind(0)))
    new_state["ends"], new_state["counts"] = ends, counts
    return new_state, work


def mem1_scan(rec_all, init_rec, all_p, skip_rec, pos2rba, r: int,
              sigma: int, n: int, alphas: torch.Tensor, state, L: int,
              ticks: int):
    """Kernel 13b: the BML machine over alphas int8 [lanes, W] (read-order
    slots: -1 illegal, -3 '#', -2 past the read) on the MEM v1 table (the
    one-step search records int32 [2*sigma*r, 4] and init_rec [sigma+1,
    4], all_p [r+1], skip_rec [sigma*r, 2], pos2rba [n, 2] or None for
    the binary search).  state: the int32 [lanes] registers of
    MEM1_STATE_KEYS (a lane at phase -1, ENTRY, starts from its slots),
    ends and counts int32 [lanes, W].  Each lane runs
    until it is done; one still running after `ticks` ticks raises.
    Returns (state, work int32 [2, lanes]: each lane's ticks and table
    bytes)."""
    if L < 2:
        raise ValueError(f"BML needs L >= 2, got {L}")
    return _mem1_machine("mem1_scan", MEM1_STATE_KEYS, rec_all, init_rec,
                         all_p, skip_rec, pos2rba, r, sigma, n, alphas,
                         state, ticks, (L,))


def all_mem1_scan(rec_all, init_rec, all_p, skip_rec, pos2rba, r: int,
                  sigma: int, n: int, alphas: torch.Tensor, state,
                  ticks: int):
    """Kernel 13c: the all-MEMs machine over alphas int8 [lanes, W] from
    the registers of AM1_STATE_KEYS, on kernel 13b's tables.  Returns
    (state, work) as kernel 13b."""
    return _mem1_machine("all_mem1_scan", AM1_STATE_KEYS, rec_all, init_rec,
                         all_p, skip_rec, pos2rba, r, sigma, n, alphas,
                         state, ticks)
