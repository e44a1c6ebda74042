"""Carry index state from the JAX package into the port.

Both packages keep the same host index (`movi_tpu.index.structure.
MoveIndex`, shared as is) and the same record tables.  These helpers turn
the JAX package's record objects (PML, count/ZML and Movi Color), read as
numpy arrays, into the port's, and read the `*.npz` caches that movi_tpu writes (`build --fused-cache`,
`build --paired-cache`, `Index.save`): the one-step and paired PML
records and the paired search records.  Nothing here imports JAX: a JAX
array is only read through `np.asarray`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .engine.fused import FusedIndex, load_fused_index
from .engine.fused2 import Fused2ColorIndex, Fused2Index, load_fused2_index
from .engine.fused_color import FusedColorIndex
from .engine.fused_search import FusedSearchIndex
from .engine.fused_search2 import FusedSearch2Index, load_fused_search2_index


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _fields(src) -> dict:
    return dict(r=int(src.r), sigma=int(src.sigma),
                records=_tensor(src.records),
                start_idx=int(src.start_idx),
                start_offset=int(src.start_offset),
                p_dollar=(int(src.p_dollar[0]), int(src.p_dollar[1])),
                alphamap_query=np.asarray(src.alphamap_query))


def fused_index_from_jax(fi) -> FusedIndex:
    """A movi_tpu FusedIndex -> the port's (host tensors)."""
    return FusedIndex(**_fields(fi))


def fused2_index_from_jax(f2) -> Fused2Index:
    """A movi_tpu Fused2Index (4-word PML records) -> the port's."""
    return Fused2Index(**_fields(f2))


def fused_color_index_from_jax(ci) -> FusedColorIndex:
    """A movi_tpu FusedColorIndex (3-word records, or None past 16-bit
    color ids) -> the port's."""
    return FusedColorIndex(
        fi=fused_index_from_jax(ci.fi), doc_set_inds=_tensor(ci.doc_set_inds),
        num_colors=int(ci.num_colors),
        records3=None if ci.records3 is None else _tensor(ci.records3))


def fused2_color_index_from_jax(ci2) -> Fused2ColorIndex:
    """A movi_tpu Fused2ColorIndex (8-word color records) -> the port's."""
    return Fused2ColorIndex(f2=fused2_index_from_jax(ci2.f2),
                            num_colors=int(ci2.num_colors))


def fused_search_index_from_jax(si) -> FusedSearchIndex:
    """A movi_tpu FusedSearchIndex (without ftab rows) -> the port's."""
    if int(si.ftab_k) > 1:
        raise NotImplementedError("ftab anchor rows are not yet ported")
    return FusedSearchIndex(r=int(si.r), sigma=int(si.sigma),
                            rec_all=_tensor(si.rec_all),
                            init_rec=_tensor(si.init_rec),
                            all_p=_tensor(si.all_p),
                            alphamap_query=np.asarray(si.alphamap_query))


def fused_search2_index_from_jax(s2) -> FusedSearch2Index:
    """A movi_tpu FusedSearch2Index -> the port's (host tensors)."""
    return FusedSearch2Index(r=int(s2.r), sigma=int(s2.sigma),
                             rec_all=_tensor(s2.rec_all),
                             init_rec=_tensor(s2.init_rec),
                             restart_rec=_tensor(s2.restart_rec),
                             all_p=_tensor(s2.all_p),
                             alphamap_query=np.asarray(s2.alphamap_query))


def load_engine_caches(index_dir: str) -> Tuple[
        Optional[FusedIndex], Optional[Fused2Index],
        Optional[FusedSearch2Index]]:
    """The one-step and paired PML record caches and the paired search
    record cache of an index directory, as written by either package; a
    missing or stale cache gives None."""
    out = []
    for name, load in (("fused_records.npz", load_fused_index),
                       ("paired_records.npz", load_fused2_index),
                       ("paired_search_records.npz",
                        load_fused_search2_index)):
        path = os.path.join(index_dir, name)
        cache = None
        if os.path.exists(path):
            try:
                cache = load(path)
            except ValueError:
                pass  # stale cache format: rebuilt lazily
        out.append(cache)
    return out[0], out[1], out[2]
