"""Carry index state from the JAX package into the port.

The port keeps its own copies of the JAX package's host classes
(`index.structure.MoveIndex`, `color.ColorTable`), field for field the
same.  These helpers turn the JAX package's objects, read as numpy arrays,
into the port's: the host index and color table, and the record objects
of PML, count/ZML and k-mers, Movi Color, SA entries and the MEM v1
machines, the compact run tables and the dense PML table; and they read
the `*.npz` caches that movi_tpu writes (`build --fused-cache`, `build
--paired-cache`, `Index.save`): the one-step and paired PML records and
the paired search records.  Nothing here imports JAX or the JAX package:
a JAX array is only read through `np.asarray`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import numpy as np
import torch

from .color import ColorTable, DocumentInfo
from .engine.dense import DenseIndex
from .engine.device_index import DeviceIndex
from .engine.fused import FusedIndex, load_fused_index
from .engine.fused2 import Fused2ColorIndex, Fused2Index, load_fused2_index
from .engine.fused_color import FusedColorIndex
from .engine.fused_mem import FusedMemIndex, with_run_dir
from .engine.fused_search import FusedSearchIndex
from .engine.fused_sa import FusedSAIndex
from .engine.fused_search2 import FusedSearch2Index, load_fused_search2_index
from .index.structure import MoveIndex


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.int32))


def _fields(src) -> dict:
    return dict(r=int(src.r), sigma=int(src.sigma),
                records=_tensor(src.records),
                start_idx=int(src.start_idx),
                start_offset=int(src.start_offset),
                p_dollar=(int(src.p_dollar[0]), int(src.p_dollar[1])),
                alphamap_query=np.asarray(src.alphamap_query))


def _same_fields(cls, src, **override):
    """cls built field by field from the like-named attributes of src."""
    kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(cls)}
    kw.update(override)
    return cls(**kw)


def move_index_from_jax(ix) -> MoveIndex:
    """A movi_tpu MoveIndex -> the port's (the same numpy arrays)."""
    return _same_fields(MoveIndex, ix, extras=dict(ix.extras),
                        sep_row_map=None if ix.sep_row_map is None
                        else dict(ix.sep_row_map))


def color_table_from_jax(ct) -> ColorTable:
    """A movi_tpu ColorTable (and its DocumentInfo) -> the port's."""
    di = None if ct.doc_info is None else _same_fields(DocumentInfo,
                                                       ct.doc_info)
    return _same_fields(ColorTable, ct,
                        unique_doc_sets=list(ct.unique_doc_sets), doc_info=di)


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
    """A movi_tpu FusedSearchIndex -> the port's, its ftab anchor rows (if
    any) included."""
    return FusedSearchIndex(r=int(si.r), sigma=int(si.sigma),
                            rec_all=_tensor(si.rec_all),
                            init_rec=_tensor(si.init_rec),
                            all_p=_tensor(si.all_p),
                            alphamap_query=np.asarray(si.alphamap_query),
                            ftab_k=int(si.ftab_k))


def fused_mem_index_from_jax(mi) -> FusedMemIndex:
    """A movi_tpu FusedMemIndex -> the port's (host tensors): its search
    records, skip rows and pos2rba; where it has no pos2rba, the port's
    row -> run directory at the rule's shift (fused_mem.run_dir_shift)
    built here, since the JAX table searches all_p instead.  all_p64 is the
    search records' all_p in both."""
    out = FusedMemIndex(si=fused_search_index_from_jax(mi.si),
                        skip_rec=_tensor(mi.skip_rec),
                        n=int(np.asarray(mi.all_p64)[-1]))
    if mi.pos2rba is None:
        return with_run_dir(out)
    return dataclasses.replace(out, pos2rba=_tensor(mi.pos2rba))


def fused_search2_index_from_jax(s2) -> FusedSearch2Index:
    """A movi_tpu FusedSearch2Index -> the port's (host tensors)."""
    return FusedSearch2Index(r=int(s2.r), sigma=int(s2.sigma),
                             rec_all=_tensor(s2.rec_all),
                             init_rec=_tensor(s2.init_rec),
                             restart_rec=_tensor(s2.restart_rec),
                             all_p=_tensor(s2.all_p),
                             alphamap_query=np.asarray(s2.alphamap_query))


def fused_sa_index_from_jax(sx) -> FusedSAIndex:
    """A movi_tpu FusedSAIndex -> the port's (host tensors; the run starts
    and the sampled SA as int64, whatever width the JAX arrays have)."""
    return FusedSAIndex(
        fi=fused_index_from_jax(sx.fi), pre_tab=_tensor(sx.pre_tab),
        all_p=torch.from_numpy(np.array(sx.all_p, dtype=np.int64)),
        sampled=torch.from_numpy(np.array(sx.sampled, dtype=np.int64)),
        rate=int(sx.rate), n=int(sx.n))


def dense_index_from_jax(di) -> DenseIndex:
    """A movi_tpu DenseIndex -> the port's (the transition table as a host
    tensor)."""
    return DenseIndex(n=int(di.n), sigma=int(di.sigma),
                      table=_tensor(di.table), start_pos=int(di.start_pos),
                      alphamap_query=np.asarray(di.alphamap_query))


def device_index_from_jax(di) -> DeviceIndex:
    """A movi_tpu DeviceIndex -> the port's (host tensors of the JAX
    arrays' own types), with the row -> run directory the JAX index has
    not, built on the host from all_p at run_dir_shift's shift."""
    meta = ("r", "length", "end_bwt_idx", "sigma")
    kw = {f.name: getattr(di, f.name) for f in dataclasses.fields(DeviceIndex)
          if f.name not in meta + ("mode", "alphamap_query", "run_dir",
                                   "dir_shift")}
    kw = {k: None if v is None else torch.from_numpy(np.array(v))
          for k, v in kw.items()}
    return DeviceIndex(
        mode=di.mode, **{k: int(getattr(di, k)) for k in meta},
        alphamap_query=np.asarray(di.alphamap_query), **kw).with_run_dir()


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
