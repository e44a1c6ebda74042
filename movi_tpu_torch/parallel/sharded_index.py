"""Model-sharded record tables: the capacity-scaling PML, count and ZML
scans.

Port of movi_tpu/parallel/sharded_index.py.  When the record table
exceeds one card, its rows are padded to a multiple of the 'model' axis
and split: the rank at model coordinate m holds rows [m*shard_len,
(m+1)*shard_len); read lanes stay data-parallel on 'data'.  Every step,
each rank gathers the rows of its lanes' keys that it owns (the rest
zero), one all_reduce(SUM) over the 'model' group gives every rank the
whole records, and the step math runs.  One launch a step does the math
of the previous step and the gather of the next (kernels 15a and 15b,
csrc/sharded.cu); the plain PyTorch versions below run for CPU tensors.
The host loop between launches is the collective, so the scans are
launch- and collective-bound by design.

The count's interval size is computed in 64 bits (the JAX version takes
it from int32 all_p and wraps past 2^31 occurrences, ROADMAP §3).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..engine.fused import FusedIndex, fused_step_math
from ..engine.fused_search import _lf_from_rec, init_interval
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
    with the record table sharded over 'model' (kernel 15a, W+1 launches
    and W all-reduces)."""
    local, lo = local_shard(mesh, fi.records)
    codes = _lane_codes(mesh, alphas_t, np.uint8)
    W, lanes = codes.shape
    state = torch.tensor([fi.start_idx, fi.start_offset, 0],
                         dtype=torch.int32, device=mesh.device)[:, None] \
        .repeat(1, lanes)
    ml = torch.empty((W, lanes), dtype=torch.int32, device=mesh.device)
    rec = None
    for t in range(W + 1):
        rec = sharded_pml_gather(local, lo, fi.sigma + 1, fi.p_dollar,
                                 codes, t, rec, state, ml)
        if rec is not None:
            mesh.all_reduce_model(rec)
    return ml


def _sharded_search_scan(mesh: Mesh, si, alphas_t, zml: bool):
    """The backward-search scan (count, or ZML with zml) with the one-step
    search records sharded over 'model': this rank's state [6,
    lanes/data] and, for ZML, ml [W, lanes/data] (kernel 15b, W launches
    and W-1 all-reduces)."""
    local, lo = local_shard(mesh, si.rec_all)
    init_rec = si.init_rec.to(mesh.device)   # tiny: on every rank
    chars = _lane_codes(mesh, alphas_t, np.int8)
    W, lanes = chars.shape
    if W == 0:
        raise ValueError("a scan from the first char needs at least one "
                         "step")
    state = torch.empty((SEARCH_STATE_ROWS, lanes), dtype=torch.int32,
                        device=mesh.device)
    ml = (torch.empty((W, lanes), dtype=torch.int32, device=mesh.device)
          if zml else None)
    rec = None
    for t in range(W):
        rec = sharded_search_gather(local, lo, si.r, si.sigma, init_rec,
                                    chars, t, zml, rec, state, ml)
        if rec is not None:
            mesh.all_reduce_model(rec)
    return state, ml


def sharded_fused_count(mesh: Mesh, si, alphas_t):
    """Count with the search records sharded over 'model'.  alphas_t: int
    [W, lanes] chars (-1 illegal, -2 past the read).  Returns this rank's
    (matched int32, count int64) [lanes/data], as
    engine/fused_search.fused_count_scan's (the count in 64 bits)."""
    state, _ = _sharded_search_scan(mesh, si, alphas_t, False)
    all_p = si.all_p.to(device=mesh.device, dtype=torch.int64)
    rs, os_, re, oe, matched = (state[i] for i in range(5))
    abs_s = all_p[rs.to(torch.int64)] + os_
    abs_e = all_p[re.to(torch.int64)] + oe
    return matched, torch.where(matched > 0, abs_e - abs_s + 1, 0)


def sharded_fused_zml(mesh: Mesh, si, alphas_t) -> torch.Tensor:
    """ZML with the search records sharded over 'model': this rank's ml
    int32 [W, lanes/data], as engine/fused_search.fused_zml_scan's."""
    return _sharded_search_scan(mesh, si, alphas_t, True)[1]
