"""Copy of movi_tpu/index/sweeps.py: the port keeps its own, so it imports nothing
of the JAX package.

O(n) LF-cycle sweeps over a built move index.

The reference derives two artifacts from the index alone (no suffix array
needed) by walking the LF permutation once over all n BWT positions:

  - the sampled suffix array (find_sampled_SA_entries,
    move_structure_build.cpp:1173-1212), used by `build-SA` and the
    --sa-entries query path;
  - per-row document ids ("doc_pats", build_doc_pats,
    move_structure_color.cpp:4-24), used by the standalone `color`
    subcommand when the index was built without colors.

The sweep starts at run 0 offset 0 (BWT row 0, SA value n-1) and decrements
the SA value by one per LF step.  A C++ kernel (native/movi_native.cpp
movi_lf_sweep) handles large indexes; a Python loop is the fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..build.suffix import _load_native


def lf_sweep(ix, sa_sample_rate: int = 0,
             doc_offsets: Optional[np.ndarray] = None,
             doc_ids: Optional[np.ndarray] = None,
             ) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Walk the LF cycle once; return (sampled_SA, doc_pats).

    sampled_SA is int64[n // rate + 1] when sa_sample_rate > 0, else None.
    doc_pats is uint16[n] when doc_offsets/doc_ids are given, else None.
    """
    n_arr = np.ascontiguousarray(ix.n_arr, dtype=np.int32)
    off_arr = np.ascontiguousarray(ix.offset_arr, dtype=np.int32)
    id_arr = np.ascontiguousarray(ix.id_arr, dtype=np.int64)
    all_p = np.ascontiguousarray(ix.all_p, dtype=np.int64)
    r, tot = ix.r, int(ix.length)

    out_sa = (np.zeros(tot // sa_sample_rate + 1, dtype=np.int64)
              if sa_sample_rate > 0 else None)
    want_docs = doc_offsets is not None
    if want_docs:
        doc_offsets = np.ascontiguousarray(doc_offsets, dtype=np.int64)
        if doc_ids is None:
            doc_ids = np.arange(len(doc_offsets), dtype=np.int32)
        doc_ids = np.ascontiguousarray(doc_ids, dtype=np.int32)
        out_doc = np.zeros(tot, dtype=np.uint16)
    else:
        out_doc = None

    lib = _load_native()
    if lib:
        if not hasattr(lib, "_lf_sweep_ready"):
            lib.movi_lf_sweep.argtypes = [
                ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int64, ctypes.c_void_p,
            ]
            lib.movi_lf_sweep.restype = ctypes.c_int
            lib._lf_sweep_ready = True

        def ptr(a):
            return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

        rc = lib.movi_lf_sweep(
            n_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            off_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            id_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            all_p.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            r, tot, sa_sample_rate, ptr(out_sa),
            ptr(doc_offsets if want_docs else None),
            ptr(doc_ids if want_docs else None),
            len(doc_offsets) if want_docs else 0, ptr(out_doc))
        assert rc == 0
        return out_sa, out_doc

    # Python fallback (small indexes / native kernel not built)
    offset, index = 0, 0
    sa_val = tot
    doc_ind = (len(doc_offsets) - 1) if want_docs else 0
    for _ in range(tot):
        sa_val -= 1
        row = int(all_p[index]) + offset
        if want_docs:
            while doc_ind > 0 and sa_val < doc_offsets[doc_ind - 1]:
                doc_ind -= 1
            out_doc[row] = doc_ids[doc_ind]
        if out_sa is not None and row % sa_sample_rate == 0:
            out_sa[row // sa_sample_rate] = sa_val
        offset += int(off_arr[index])
        index = int(id_arr[index])
        while index < r - 1 and offset >= n_arr[index]:
            offset -= int(n_arr[index])
            index += 1
    return out_sa, out_doc
