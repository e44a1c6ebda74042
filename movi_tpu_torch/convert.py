"""Carry index state from the JAX package into the port.

Both packages keep the same host index (`movi_tpu.index.structure.
MoveIndex`, shared as is) and the same record tables.  These helpers turn
the JAX package's record objects, read as numpy arrays, into the port's,
and read the `*.npz` caches that movi_tpu writes (`build --fused-cache`,
`build --paired-cache`, `Index.save`).  Nothing here imports JAX: a JAX
array is only read through `np.asarray`.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .engine.fused import FusedIndex, load_fused_index
from .engine.fused2 import Fused2Index, load_fused2_index


def _fields(src) -> dict:
    return dict(r=int(src.r), sigma=int(src.sigma),
                records=torch.from_numpy(
                    np.array(src.records, dtype=np.int32)),
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


def load_engine_caches(index_dir: str
                       ) -> Tuple[Optional[FusedIndex], Optional[Fused2Index]]:
    """The one-step and paired record caches of an index directory, as
    written by either package; a missing or stale cache gives None."""
    out = []
    for name, load in (("fused_records.npz", load_fused_index),
                       ("paired_records.npz", load_fused2_index)):
        path = os.path.join(index_dir, name)
        cache = None
        if os.path.exists(path):
            try:
                cache = load(path)
            except ValueError:
                pass  # stale cache format: rebuilt lazily
        out.append(cache)
    return out[0], out[1]
