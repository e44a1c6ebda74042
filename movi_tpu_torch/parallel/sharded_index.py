"""Model-sharded record tables: the capacity-scaling PML, count and ZML
scans.

Port of movi_tpu/parallel/sharded_index.py.  When the record table
exceeds one card, its rows are padded to a multiple of the 'model' axis
and split: the rank at model coordinate m holds rows [m*shard_len,
(m+1)*shard_len); read lanes stay data-parallel on 'data'.  A table is
split once per mesh (`shard_table`) and kept there until `close_tables`.

Two routes, taken from the mesh before any launch (`scan_route`):

- The scans, for CUDA tensors where the 'model' group lies on one host.
  Every rank of a group holds the same lanes and the same state, so the
  all-reduce only carried each row from the rank that owns it.  Here
  each rank opens its peers' shards once (CUDA IPC through PyTorch's own
  tensor sharing; a one-rank group opens none) and a scan is one launch
  of kernel 15a or 15b (csrc/sharded.cu) that reads every row from the
  shard that holds it, with no collective.
- The steps, for a group that spans hosts and for CPU tensors.  Every
  step, each rank gathers the rows of its lanes' keys that it owns (the
  rest zero), one all_reduce(SUM) over the 'model' group gives every
  rank the whole records, and the step math runs.  One launch a step
  does the math of the previous step and the gather of the next (the
  step kernels of csrc/sharded.cu); the plain PyTorch versions below run
  for CPU tensors.  This route is launch- and collective-bound by
  design.

The count's interval size is computed in 64 bits (the JAX version takes
it from int32 all_p and wraps past 2^31 occurrences, ROADMAP §3).
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import kernels
from ..engine.fused import (FusedIndex, fused_pml_scan_plain,
                            fused_step_math, initial_state)
from ..engine.fused_search import (_lf_from_rec, fused_count_scan_plain,
                                   fused_zml_scan_plain, init_interval)
from . import Mesh, make_2d_mesh  # noqa: F401  (make_2d_mesh: the API)

PML_STATE_ROWS = 3        # (idx, off, ml)
SEARCH_STATE_ROWS = kernels.SEARCH_STATE_ROWS


def _pad_records(records: torch.Tensor, model: int) -> torch.Tensor:
    """Records [rows, words] with zero rows appended to a multiple of
    model."""
    pad = (-records.shape[0]) % model
    if pad:
        records = torch.cat([records, records.new_zeros(
            (pad, records.shape[1]))])
    return records


def local_shard(mesh: Mesh, records: torch.Tensor):
    """(this rank's rows of the padded table on its device, their first
    row lo)."""
    records = _pad_records(records, mesh.model)
    shard_len = records.shape[0] // mesh.model
    lo = mesh.m * shard_len
    return records[lo:lo + shard_len].contiguous().to(mesh.device), lo


def scan_route(mesh: Mesh, device) -> bool:
    """Whether the scans on `device` run as one launch each: CUDA tensors
    and a 'model' group on one host.  Otherwise (CPU tensors, or a group
    that spans hosts) the step loop with its all-reduces runs."""
    return torch.device(device).type == "cuda" and mesh.model_on_one_host


@dataclass
class ShardTable:
    """A record table split over a mesh's 'model' axis: this rank's rows
    `local` (rows [lo, lo + shard_len) of the padded table) and, on the
    scan route, every rank's shard in model order (this rank's `local`, a
    peer's opened through IPC) with their addresses on the device (ptrs,
    int64 [model])."""
    local: torch.Tensor
    lo: int
    shards: Optional[List[torch.Tensor]] = None
    ptrs: Optional[torch.Tensor] = None


def shard_ptrs(shards, device) -> torch.Tensor:
    """The shards' addresses, int64 [model] on `device`."""
    return torch.tensor([s.data_ptr() for s in shards], dtype=torch.int64,
                        device=device)


def _open_shards(mesh: Mesh, local: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's shard in model order: each rank exports its own once
    (torch.multiprocessing's CUDA IPC handle, which covers an offset
    inside the allocator's block) and opens its peers'; the handles go
    round the 'model' group once.  A peer's shard on another card of the
    host is read over NVLink.  A handle that does not open raises with
    the CUDA error."""
    if mesh.model == 1:
        return [local]
    from torch.multiprocessing.reductions import (rebuild_cuda_tensor,
                                                  reduce_tensor)

    handles = [None] * mesh.model
    dist.all_gather_object(handles, reduce_tensor(local),
                           group=mesh.model_group)
    # a handle opens into the context of the device it names, with peer
    # access enabled as needed (cudaIpcMemLazyEnablePeerAccess): name this
    # rank's, so that its kernels may read a shard on another card
    at = list(inspect.signature(rebuild_cuda_tensor).parameters) \
        .index("storage_device")
    shards = []
    for m, (rebuild, args) in enumerate(handles):
        if m == mesh.m:
            shards.append(local)
            continue
        args = list(args)
        args[at] = local.device.index
        shards.append(rebuild(*args))
    return shards


def shard_table(mesh: Mesh, records: torch.Tensor) -> ShardTable:
    """records' ShardTable on mesh, made at its first use and kept on the
    mesh (with records, so that its key stays its own) until
    close_tables.  On the scan route with several ranks this is a
    collective over 'model': the ranks of a group make their tables in
    the same order."""
    hit = mesh.tables.get(id(records))
    if hit is not None:
        return hit[1]
    local, lo = local_shard(mesh, records)
    table = ShardTable(local, lo)
    if scan_route(mesh, local.device):
        table.shards = _open_shards(mesh, local)
        table.ptrs = shard_ptrs(table.shards, mesh.device)
    mesh.tables[id(records)] = (records, table)
    return table


def close_tables(mesh: Mesh):
    """Release the mesh's tables, a collective over 'model' where a table
    holds peers' shards: every rank's queued work finishes and the group
    meets at a barrier before any rank closes a peer's shard or frees its
    own, so that no kernel still reads a shard when it goes."""
    opened = any(t.shards is not None and len(t.shards) > 1
                 for _, t in mesh.tables.values())
    if opened:
        torch.cuda.synchronize(mesh.device)
        dist.barrier(group=mesh.model_group)
    mesh.tables.clear()


def split_shards(records: torch.Tensor, model: int,
                 device=None) -> List[torch.Tensor]:
    """records [rows, words] padded to a multiple of model and split into
    `model` tensors of their own, in model order, on `device` (default
    records'): the shards of `model` ranks emulated in one process."""
    padded = _pad_records(records, model)
    n = padded.shape[0] // model
    return [padded[m * n:(m + 1) * n].to(device or records.device).clone()
            for m in range(model)]


def _shard_rows(shards, keys: torch.Tensor) -> torch.Tensor:
    """The rows of keys (int64) of the padded table that the shards split
    in model order: row k from shard k // shard_len, zero past the last
    shard."""
    n = shards[0].shape[0]
    out = shards[0].new_zeros((keys.shape[0], shards[0].shape[1]))
    owner = torch.div(keys, n, rounding_mode="floor")
    for m, shard in enumerate(shards):
        own = owner == m
        out[own] = shard[keys[own] - m * n]
    return out


class _ShardedTable:
    """The padded table that the shards split, indexed by int64 keys as
    the unsharded plain scans index their records."""

    def __init__(self, shards):
        self.shards = shards

    def __getitem__(self, keys: torch.Tensor) -> torch.Tensor:
        return _shard_rows(self.shards, keys)


def sharded_pml_scan_plain(shards, slots: int, p_dollar,
                           codes: torch.Tensor, state):
    """Plain PyTorch version of kernel 15a's scan: the one-step PML scan
    over codes [W, lanes] from state (idx, off, ml) int32 [lanes], each
    step's records read from the shards (every rank's, model order).
    Returns (state, ml [W, lanes])."""
    return fused_pml_scan_plain(_ShardedTable(shards), slots, p_dollar,
                                codes, state)


def sharded_search_scan_plain(shards, r: int, sigma: int,
                              init_rec: torch.Tensor, chars: torch.Tensor,
                              zml: bool, state=None):
    """Plain PyTorch version of kernel 15b's scan: the one-step count
    (zml False) or ZML scan over chars int8 [W, lanes] with its rows read
    from the shards, from row 0 of chars (state None) or from state [6,
    lanes].  Returns (state, ZML's ml [W, lanes] or None)."""
    table = _ShardedTable(shards)
    if zml:
        return fused_zml_scan_plain(table, init_rec, r, sigma, chars, state)
    no_p = torch.zeros(r + 1, dtype=torch.int32, device=chars.device)
    return fused_count_scan_plain(table, init_rec, no_p, r, sigma, chars,
                                  state)[0], None


def sharded_pml_scan(shards, ptrs, slots: int, p_dollar,
                     codes: torch.Tensor, state):
    """The sharded PML scan: kernel 15a on CUDA tensors, the plain
    version on CPU tensors."""
    if codes.device.type == "cuda":
        return kernels.sharded_pml_scan(shards, ptrs, slots, p_dollar,
                                        codes, state)
    if codes.device.type != "cpu":
        raise ValueError(f"no sharded scan for device {codes.device}")
    return sharded_pml_scan_plain(shards, slots, p_dollar, codes, state)


def sharded_search_scan(shards, ptrs, r: int, sigma: int,
                        init_rec: torch.Tensor, chars: torch.Tensor,
                        zml: bool, state=None):
    """The sharded count or ZML scan: kernel 15b on CUDA tensors, the
    plain version on CPU tensors."""
    if chars.device.type == "cuda":
        return kernels.sharded_search_scan(shards, ptrs, r, sigma, init_rec,
                                           chars, zml, state)
    if chars.device.type != "cpu":
        raise ValueError(f"no sharded scan for device {chars.device}")
    return sharded_search_scan_plain(shards, r, sigma, init_rec, chars, zml,
                                     state)


def _owned(local_rec: torch.Tensor, lo: int, keys: torch.Tensor):
    """local_rec's rows of keys (int64), zero where this shard does not
    own the key."""
    local = keys - lo
    owned = (local >= 0) & (local < local_rec.shape[0])
    rec = local_rec[local.clamp(0, local_rec.shape[0] - 1)]
    return torch.where(owned[:, None], rec, 0)


def sharded_pml_gather_plain(local_rec: torch.Tensor, lo: int, slots: int,
                             p_dollar, codes: torch.Tensor, t: int, rec_in,
                             state: torch.Tensor, ml: torch.Tensor):
    """Plain PyTorch step t of the model-sharded PML scan, as kernel
    15a: apply step t-1's summed records rec_in (state [3, lanes] and ml
    row t-1 updated in place), then this shard's masked records of step
    t's keys [lanes, 2], or None at t = W."""
    if rec_in is not None:
        new, m = fused_step_math(rec_in, tuple(state), p_dollar)
        state.copy_(torch.stack(new))
        ml[t - 1] = m
    if t == codes.shape[0]:
        return None
    keys = state[0].to(torch.int64) * slots + codes[t].to(torch.int64)
    return _owned(local_rec, lo, keys)


def sharded_pml_gather(local_rec: torch.Tensor, lo: int, slots: int,
                       p_dollar, codes: torch.Tensor, t: int, rec_in,
                       state: torch.Tensor, ml: torch.Tensor):
    """Step t of the sharded PML scan: kernel 15a on a CUDA tensor, the
    plain version on a CPU tensor."""
    if local_rec.device.type == "cuda":
        return kernels.sharded_pml_gather(local_rec, lo, slots, p_dollar,
                                          codes, t, rec_in, state, ml)
    if local_rec.device.type != "cpu":
        raise ValueError(f"no sharded step for device {local_rec.device}")
    return sharded_pml_gather_plain(local_rec, lo, slots, p_dollar, codes,
                                    t, rec_in, state, ml)


def sharded_search_gather_plain(local_rec: torch.Tensor, lo: int, r: int,
                                sigma: int, init_rec: torch.Tensor,
                                chars: torch.Tensor, t: int, zml: bool,
                                rec_in, state: torch.Tensor, ml):
    """Plain PyTorch step t of the model-sharded count or ZML scan, as
    kernel 15b: start from chars[0] (t = 0) or apply chars[t] with the
    summed records rec_in [2*lanes, 4]; update state [6, lanes] (and
    ZML's ml) in place; return this shard's masked rows of chars[t+1]'s
    keys [2*lanes, 4], or None after the last step."""
    W, lanes = chars.shape
    a_t = chars[t].to(torch.int32)
    if t == 0:
        x = (a_t >= 0).to(torch.int32)
        state.copy_(torch.stack([*init_interval(init_rec, a_t), x,
                                 torch.zeros_like(x) if zml else 1 - x]))
    else:
        rs, os_, re, oe, x, y = state.unbind(0)
        rd, ru = rec_in[:lanes], rec_in[lanes:]
        empty = (a_t < 0) | (rd[:, 0] >= r) | (rd[:, 0] > re)
        nrs, nos = _lf_from_rec(rd, torch.where(rd[:, 0] != rs, 0, os_))
        nre, noe = _lf_from_rec(ru, torch.where(ru[:, 0] != re,
                                                ru[:, 3] - 1, oe))
        nxt = (nrs, nos, nre, noe)
        if zml:
            ml[t - 1] = torch.where(x == 1, y, 0)
            ext_ok = (x == 1) & ~empty
            cur = [torch.where(ext_ok, n, i)
                   for n, i in zip(nxt, init_interval(init_rec, a_t))]
            new = cur + [(ext_ok | (a_t >= 0)).to(torch.int32),
                         torch.where(ext_ok, y + 1, 0)]
        else:
            alive = y == 0
            ok = alive & ~empty
            cur = [torch.where(ok, n, c)
                   for n, c in zip(nxt, (rs, os_, re, oe))]
            new = cur + [x + ok.to(torch.int32),
                         (~alive | empty).to(torch.int32)]
        state.copy_(torch.stack(new))
    if t + 1 == W:
        if zml:
            ml[W - 1] = torch.where(state[4] == 1, state[5], 0)
        return None
    a_s = chars[t + 1].to(torch.int64).clamp(min=0)
    keys = torch.cat([a_s * r + state[0].clamp(0, r - 1),
                      (sigma + a_s) * r + state[2].clamp(0, r - 1)])
    return _owned(local_rec, lo, keys)


def sharded_search_gather(local_rec: torch.Tensor, lo: int, r: int,
                          sigma: int, init_rec: torch.Tensor,
                          chars: torch.Tensor, t: int, zml: bool, rec_in,
                          state: torch.Tensor, ml):
    """Step t of the sharded count / ZML scan: kernel 15b on a CUDA
    tensor, the plain version on a CPU tensor."""
    if local_rec.device.type == "cuda":
        return kernels.sharded_search_gather(local_rec, lo, r, sigma,
                                             init_rec, chars, t, zml,
                                             rec_in, state, ml)
    if local_rec.device.type != "cpu":
        raise ValueError(f"no sharded step for device {local_rec.device}")
    return sharded_search_gather_plain(local_rec, lo, r, sigma, init_rec,
                                       chars, t, zml, rec_in, state, ml)


def _lane_codes(mesh: Mesh, alphas_t, dtype) -> torch.Tensor:
    """This rank's columns of alphas_t [W, lanes] on its device."""
    a = np.asarray(alphas_t)
    sl = mesh.lane_slice(a.shape[1])
    return torch.from_numpy(np.ascontiguousarray(a[:, sl]).astype(dtype)) \
        .to(mesh.device)


def sharded_fused_pml(mesh: Mesh, fi: FusedIndex, alphas_t) -> torch.Tensor:
    """alphas_t: int [W, lanes] slots (sigma = illegal), lanes divisible
    by 'data'.  Returns this rank's ml int32 [W, lanes/data], computed
    with the record table sharded over 'model': one launch of kernel 15a
    on the scan route, else W+1 step launches and W all-reduces."""
    table = shard_table(mesh, fi.records)
    codes = _lane_codes(mesh, alphas_t, np.uint8)
    W, lanes = codes.shape
    if scan_route(mesh, mesh.device):
        return sharded_pml_scan(table.shards, table.ptrs, fi.sigma + 1,
                                fi.p_dollar, codes,
                                initial_state(fi, lanes, mesh.device))[1]
    state = torch.tensor([fi.start_idx, fi.start_offset, 0],
                         dtype=torch.int32, device=mesh.device)[:, None] \
        .repeat(1, lanes)
    ml = torch.empty((W, lanes), dtype=torch.int32, device=mesh.device)
    rec = None
    for t in range(W + 1):
        rec = sharded_pml_gather(table.local, table.lo, fi.sigma + 1,
                                 fi.p_dollar, codes, t, rec, state, ml)
        if rec is not None:
            mesh.all_reduce_model(rec)
    return ml


def _sharded_search_scan(mesh: Mesh, si, alphas_t, zml: bool):
    """The backward-search scan (count, or ZML with zml) with the one-step
    search records sharded over 'model': this rank's state [6,
    lanes/data] and, for ZML, ml [W, lanes/data] (one launch of kernel
    15b on the scan route, else W step launches and W-1 all-reduces)."""
    table = shard_table(mesh, si.rec_all)
    init_rec = si.init_rec.to(mesh.device)   # tiny: on every rank
    chars = _lane_codes(mesh, alphas_t, np.int8)
    W, lanes = chars.shape
    if W == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")
    if scan_route(mesh, mesh.device):
        return sharded_search_scan(table.shards, table.ptrs, si.r,
                                   si.sigma, init_rec, chars, zml)
    state = torch.empty((SEARCH_STATE_ROWS, lanes), dtype=torch.int32,
                        device=mesh.device)
    ml = (torch.empty((W, lanes), dtype=torch.int32, device=mesh.device)
          if zml else None)
    rec = None
    for t in range(W):
        rec = sharded_search_gather(table.local, table.lo, si.r, si.sigma,
                                    init_rec, chars, t, zml, rec, state, ml)
        if rec is not None:
            mesh.all_reduce_model(rec)
    return state, ml


def sharded_fused_count(mesh: Mesh, si, alphas_t):
    """Count with the search records sharded over 'model'.  alphas_t: int
    [W, lanes] chars (-1 illegal, -2 past the read).  Returns this rank's
    (matched int32, count int64) [lanes/data], as
    engine/fused_search.fused_count_scan's (the count in 64 bits)."""
    state, _ = _sharded_search_scan(mesh, si, alphas_t, False)
    rs, os_, re, oe, matched = (state[i] for i in range(5))
    # two entries of all_p a lane, read where all_p lies (the whole of it
    # need not move to the card for each query)
    ends = si.all_p[torch.stack([rs, re]).to(si.all_p.device,
                                             torch.int64)]
    abs_s, abs_e = ends.to(mesh.device, torch.int64).unbind(0)
    return matched, torch.where(matched > 0, abs_e + oe - abs_s - os_ + 1,
                                0)


def sharded_fused_zml(mesh: Mesh, si, alphas_t) -> torch.Tensor:
    """ZML with the search records sharded over 'model': this rank's ml
    int32 [W, lanes/data], as engine/fused_search.fused_zml_scan's."""
    return _sharded_search_scan(mesh, si, alphas_t, True)[1]
