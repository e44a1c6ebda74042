"""Copy of movi_tpu/cpu_ref/native_pml.py: the port keeps its
own, so it imports nothing of the JAX package.

ctypes binding for the native single-core scalar PML loop.

`bench.py` MEASURES the CPU baseline with this loop (the reference's
no-prefetch query path, move_structure_query.cpp:234-361, compiled -O3)
instead of assuming a literature constant for vs_baseline.  It is also
tested bit-exact (as a checksum) against the Python ScalarEngine.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from ..index.structure import MoveIndex

_LIB = None


def _load():
    global _LIB
    if _LIB is not None:
        return _LIB
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    so = os.path.join(here, "native", "libmovi_native.so")
    if not os.path.exists(so):
        _LIB = False
        return False
    lib = ctypes.CDLL(so)
    try:
        fn = lib.movi_scalar_pml
    except AttributeError:
        _LIB = False  # stale .so without the symbol
        return False
    fn.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint16), ctypes.c_int64, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
    ]
    fn.restype = ctypes.c_int64
    _LIB = lib
    return lib


def native_pml_available() -> bool:
    return bool(_load())


def native_pml_checksum(ix: MoveIndex, reads_alpha: np.ndarray
                        ) -> Optional[int]:
    """Run the native scalar PML loop over pre-alphamapped reads.

    reads_alpha: [num_reads, read_len] uint8 of alphabet slots in
    right-to-left processing order (values >= sigma = illegal char).
    Returns the sum of all emitted PMLs, or None if the native library
    is not built.
    """
    lib = _load()
    if not lib:
        return None
    from ..engine.fused import build_thr_full

    assert ix.thr is not None, "native PML baseline needs a thresholds mode"
    n = np.ascontiguousarray(ix.n_arr.astype(np.int32))
    off = np.ascontiguousarray(ix.offset_arr.astype(np.int32))
    id_ = np.ascontiguousarray(ix.id_arr.astype(np.int64))
    c = np.ascontiguousarray(ix.c_arr.astype(np.uint8))
    thr_full = np.ascontiguousarray(build_thr_full(ix).astype(np.uint16))
    reads = np.ascontiguousarray(reads_alpha.astype(np.uint8))
    num_reads, read_len = reads.shape
    return int(lib.movi_scalar_pml(
        n.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        off.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        id_.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        thr_full.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)),
        ctypes.c_int64(ix.r), ctypes.c_int32(ix.sigma),
        reads.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.c_int64(num_reads), ctypes.c_int64(read_len)))
