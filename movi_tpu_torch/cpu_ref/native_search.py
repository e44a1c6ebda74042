"""Copy of movi_tpu/cpu_ref/native_search.py: the port keeps its
own, so it imports nothing of the JAX package.

ctypes bindings for the native single-core search/kmer/MEM baselines.

`bench.py` MEASURES a CPU denominator for every query type with these
loops (native/movi_native.cpp), mirroring the reference's algorithms:
count = query_backward_search, zml = query_zml, kmer membership =
query_all_kmers with look-ahead skipping, kmer counts =
query_kmers_from_bidirectional (the k/2 partial-interval cache), MEM =
query_mem_bml.  Each is also tested against the Python oracles
(tests/test_native_search.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..index.structure import MoveIndex

_I32P = ctypes.POINTER(ctypes.c_int32)
_I64P = ctypes.POINTER(ctypes.c_int64)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I8P = ctypes.POINTER(ctypes.c_int8)

_LIB = None

_BASE_ARGS = [_I32P, _I32P, _I64P, _I32P, _I32P, _I64P, _I64P,
              ctypes.c_int64, ctypes.c_int32, _I8P, ctypes.c_int64,
              ctypes.c_int64]


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    from .native_pml import _load as _load_pml

    lib = _load_pml()
    if not lib:
        _LIB = False
        return False
    try:
        lib.movi_scalar_count.argtypes = _BASE_ARGS
        lib.movi_scalar_count.restype = ctypes.c_int64
        lib.movi_scalar_zml.argtypes = _BASE_ARGS
        lib.movi_scalar_zml.restype = ctypes.c_int64
        lib.movi_scalar_kmer_membership.argtypes = (
            _BASE_ARGS + [ctypes.c_int64])
        lib.movi_scalar_kmer_membership.restype = ctypes.c_int64
        kc = _BASE_ARGS[:7] + [_I64P, _U8P] + _BASE_ARGS[7:]
        lib.movi_scalar_kmer_count.argtypes = kc + [ctypes.c_int64, _I64P]
        lib.movi_scalar_kmer_count.restype = ctypes.c_int64
        lib.movi_scalar_mem_bml.argtypes = kc + [ctypes.c_int64, _I64P]
        lib.movi_scalar_mem_bml.restype = ctypes.c_int64
    except AttributeError:
        _LIB = False  # stale .so without the symbols
        return False
    _LIB = lib
    return lib


def native_search_available() -> bool:
    return bool(_load())


def build_skip_tables(ix: MoveIndex) -> Tuple[np.ndarray, np.ndarray]:
    """The bidirectional-skip prefix tables (same construction as the
    device engine's skip_rec, engine/fused_mem.py): P[t, run] = weighted
    rows before `run`, U[t, run] = per-row weight (comp(char) < t, '$'
    rows always weigh 1)."""
    r, sigma = ix.r, ix.sigma
    n64 = ix.n_arr.astype(np.int64)
    comp_c = (sigma - 1 - ix.c_arr).astype(np.int64)
    P = np.zeros((sigma, r), dtype=np.int64)
    U = np.zeros((sigma, r), dtype=np.uint8)
    for t in range(sigma):
        u = (comp_c < t).astype(np.int64)
        u[ix.end_bwt_idx] = 1
        w = u * n64
        w[ix.end_bwt_idx] = 1
        P[t] = np.concatenate([[0], np.cumsum(w)[:-1]])
        U[t] = u.astype(np.uint8)
    return P, U


class NativeSearchCtx:
    """Prepared contiguous arrays for the native calls, so bench timing
    excludes the one-time table preparation."""

    def __init__(self, ix: MoveIndex, with_bidir: bool = False):
        self.r = int(ix.r)
        self.sigma = int(ix.sigma)
        self.n = np.ascontiguousarray(ix.n_arr.astype(np.int32))
        self.off = np.ascontiguousarray(ix.offset_arr.astype(np.int32))
        self.id = np.ascontiguousarray(ix.id_arr.astype(np.int64))
        nu, nd = ix.next_tables_search()
        self.nd = np.ascontiguousarray(nd.astype(np.int32))
        self.nu = np.ascontiguousarray(nu.astype(np.int32))
        self.all_p = np.ascontiguousarray(ix.all_p.astype(np.int64))
        init = np.stack(
            [ix.first_runs[1:], ix.first_offsets[1:],
             ix.last_runs[1:], ix.last_offsets[1:]], axis=1)
        self.init_tab = np.ascontiguousarray(
            init[: self.sigma].astype(np.int64))
        self.skipP = self.skipU = None
        if with_bidir:
            P, U = build_skip_tables(ix)
            self.skipP = np.ascontiguousarray(P)
            self.skipU = np.ascontiguousarray(U)

    def base_args(self, reads: np.ndarray):
        reads = np.ascontiguousarray(reads.astype(np.int8))
        num_reads, read_len = reads.shape
        return [
            self.n.ctypes.data_as(_I32P),
            self.off.ctypes.data_as(_I32P),
            self.id.ctypes.data_as(_I64P),
            self.nd.ctypes.data_as(_I32P),
            self.nu.ctypes.data_as(_I32P),
            self.all_p.ctypes.data_as(_I64P),
            self.init_tab.ctypes.data_as(_I64P),
            ctypes.c_int64(self.r), ctypes.c_int32(self.sigma),
            reads.ctypes.data_as(_I8P),
            ctypes.c_int64(num_reads), ctypes.c_int64(read_len),
        ], reads

    def bidir_args(self, reads: np.ndarray):
        assert self.skipP is not None, "ctx built without with_bidir"
        args, keep = self.base_args(reads)
        return (args[:7]
                + [self.skipP.ctypes.data_as(_I64P),
                   self.skipU.ctypes.data_as(_U8P)]
                + args[7:]), keep


def reads_to_slots(ix: MoveIndex, reads: np.ndarray) -> np.ndarray:
    """[num_reads, read_len] raw bytes -> int8 alphabet slots in NATURAL
    order (-1 = illegal)."""
    amap = np.full(256, -1, dtype=np.int16)
    for a, ch in enumerate(ix.alphabet):
        amap[ch] = a
    from ..constants import SEPARATOR
    if ix.separators:
        amap[SEPARATOR] = -1
    return amap[reads].astype(np.int8)


def native_count_checksum(ctx: NativeSearchCtx,
                          reads_slots: np.ndarray) -> Optional[int]:
    """Sum over reads of (matched + count)."""
    lib = _load()
    if not lib:
        return None
    args, _keep = ctx.base_args(reads_slots)
    return int(lib.movi_scalar_count(*args))


def native_zml_checksum(ctx: NativeSearchCtx,
                        reads_slots: np.ndarray) -> Optional[int]:
    lib = _load()
    if not lib:
        return None
    args, _keep = ctx.base_args(reads_slots)
    return int(lib.movi_scalar_zml(*args))


def native_kmer_membership(ctx: NativeSearchCtx, reads_slots: np.ndarray,
                           k: int) -> Optional[int]:
    lib = _load()
    if not lib:
        return None
    assert k >= 2
    args, _keep = ctx.base_args(reads_slots)
    return int(lib.movi_scalar_kmer_membership(*args, ctypes.c_int64(k)))


def native_kmer_count(ctx: NativeSearchCtx, reads_slots: np.ndarray,
                      k: int) -> Optional[Tuple[int, int]]:
    lib = _load()
    if not lib:
        return None
    assert k >= 2
    args, _keep = ctx.bidir_args(reads_slots)
    total = ctypes.c_int64(0)
    found = int(lib.movi_scalar_kmer_count(
        *args, ctypes.c_int64(k), ctypes.byref(total)))
    return found, int(total.value)


def native_mem_bml(ctx: NativeSearchCtx, reads_slots: np.ndarray,
                   L: int) -> Optional[Tuple[int, int]]:
    """Returns (checksum = sum over MEMs of start*3 + end*5 + count*7,
    number of MEMs)."""
    lib = _load()
    if not lib:
        return None
    assert L >= 2
    args, _keep = ctx.bidir_args(reads_slots)
    nm = ctypes.c_int64(0)
    cs = int(lib.movi_scalar_mem_bml(
        *args, ctypes.c_int64(L), ctypes.byref(nm)))
    return cs, int(nm.value)
