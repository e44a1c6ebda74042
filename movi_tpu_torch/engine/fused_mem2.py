"""The MEM v2 layer's builders and read prep, as far as the k-mer engines
need them.

Port of part of movi_tpu/engine/fused_mem2.py: the ftab anchor rows
(`build_ftab_rows`, numpy, byte-identical), the reverse-complement
closure test `looks_rc_closed`, the `MEM2_MAX_N` capacity rule, and the
batch prep `_prep_alc` (kernel 10a): it widens a read's int8 slots to
int32 and appends each position's fk-mer code.  The prep runs the
hand-written CUDA kernel (the `prep_alc` entry of csrc/fused_kmer.cu) on a
CUDA tensor and the plain version below on a CPU tensor.  The MEM v2
records and machines themselves are not yet ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from ..cpu_ref.native_search import build_skip_tables
from ..index.structure import MoveIndex


def _rc_codes(fk: int) -> np.ndarray:
    """The reverse complement's code of every fk-mer code."""
    codes = np.arange(4 ** fk, dtype=np.int64)
    rc = np.zeros_like(codes)
    tmp = codes.copy()
    for _ in range(fk):
        rc = (rc << 2) | (3 - (tmp & 3))
        tmp >>= 2
    return rc


def build_ftab_rows(ix: MoveIndex, fk: int,
                    rc_merge: bool = True) -> np.ndarray:
    """[4^fk, 8] int32 anchor rows per fk-mer code (kmer_to_number bit
    order): (rs, os, re, oe, abs_s, count, rc_abs_s, valid), built level
    by level with vectorized backward-search steps.  The rc interval
    start is tracked through the levels with the scalar oracle's
    bidirectional skip recurrence (junctions and all), not looked up as
    the reverse complement's own interval.  rc_merge keeps only the rows
    whose reverse-complement fk-mer also exists; the membership anchors
    pass False so forward-only indexes keep their rows."""
    r, sigma = ix.r, ix.sigma
    assert sigma == 4
    nu, nd = ix.next_tables_search()
    id_a = ix.id_arr.astype(np.int64)
    off_a = ix.offset_arr.astype(np.int64)
    n_a = ix.n_arr.astype(np.int64)
    all_p = ix.all_p
    P_tab, U_tab = build_skip_tables(ix)

    def lf(run, off):
        run2 = id_a[run]
        off2 = off_a[run] + off
        ff = (off2 >= n_a[run2]) & (run2 < r - 1)  # bound_ff=1
        off2 = off2 - np.where(ff, n_a[run2], 0)
        return run2 + ff, off2

    rs = ix.first_runs[1:5].astype(np.int64).copy()
    os_ = ix.first_offsets[1:5].astype(np.int64).copy()
    re = ix.last_runs[1:5].astype(np.int64).copy()
    oe = ix.last_offsets[1:5].astype(np.int64).copy()
    # rc side init: abs of comp(a)'s init interval (init_bidirectional)
    comp_first = ix.first_runs[1:5][::-1]
    comp_foff = ix.first_offsets[1:5][::-1]
    rc_abs = (all_p[np.clip(comp_first, 0, r - 1)]
              + comp_foff).astype(np.int64)
    valid = np.ones(4, dtype=bool)
    for _level in range(2, fk + 1):
        rs_t, os_t, re_t, oe_t, v_t, ra_t = [], [], [], [], [], []
        for a in range(4):
            d = nd[a][np.clip(rs, 0, r - 1)]
            ok = valid & (d < r) & (d <= re)
            dc = np.clip(d, 0, r - 1)
            o1 = np.where(d == rs, os_, 0)
            e2 = np.clip(nu[a][np.clip(re, 0, r - 1)], 0, r - 1)
            o2 = np.where(e2 == re, oe, n_a[e2] - 1)
            nrs, nos = lf(dc, o1)
            nre, noe = lf(e2, o2)
            # extend_left's rc advance: skip over the PRE-step fw
            # interval at threshold t = comp(a)
            t = sigma - 1 - a
            rsc = np.clip(rs, 0, r - 1)
            rec = np.clip(re, 0, r - 1)
            skip = (P_tab[t][rec] + U_tab[t][rec] * (oe + 1)
                    - P_tab[t][rsc] - U_tab[t][rsc] * os_)
            rs_t.append(np.where(ok, nrs, 1))
            os_t.append(np.where(ok, nos, 0))
            re_t.append(np.where(ok, nre, 0))
            oe_t.append(np.where(ok, noe, 0))
            ra_t.append(np.where(ok, rc_abs + skip, 0))
            v_t.append(ok)
        rs, os_ = np.concatenate(rs_t), np.concatenate(os_t)
        re, oe = np.concatenate(re_t), np.concatenate(oe_t)
        rc_abs = np.concatenate(ra_t)
        valid = np.concatenate(v_t)
    fabs = np.where(valid, all_p[np.clip(rs, 0, r - 1)] + os_, 0)
    cnt = np.where(valid,
                   all_p[np.clip(re, 0, r - 1)] + oe - fabs + 1, 0)
    if rc_merge:
        valid = valid & valid[_rc_codes(fk)]
    return np.stack([rs, os_, re, oe, fabs, cnt,
                     np.where(valid, rc_abs, 0),
                     valid.astype(np.int64)], axis=1).astype(np.int32)


# past this total-position count the JAX package's 32 B/position combined
# MEM table does not fit its chip (it falls back to the v1 machines); the
# port keeps the rule until MEM v2 is ported and the cap re-derived
MEM2_MAX_N = 1 << 28


def mem2_supported(ix: MoveIndex) -> bool:
    """True when the v2 combined table fits: ACGT alphabet and
    n <= MEM2_MAX_N."""
    return (bytes(ix.alphabet) == b"ACGT"
            and int(ix.all_p[-1]) <= MEM2_MAX_N)


def looks_rc_closed(ix: MoveIndex, fk: int = 6) -> bool:
    """Strong necessary test for reverse-complement closure: per-char
    counts are symmetric AND every fk-mer's occurrence count equals its
    reverse complement's (all 4^fk of them).  A forward-only index, or
    one that is merely count-symmetric, fails this at fk = 6 with
    overwhelming probability."""
    if bytes(ix.alphabet) != b"ACGT":
        return False
    c = ix.counts
    if int(c[0]) != int(c[3]) or int(c[1]) != int(c[2]):
        return False
    fr = build_ftab_rows(ix, fk, rc_merge=False)
    cnt = np.where(fr[:, 7] == 1, fr[:, 5], -1).astype(np.int64)
    return bool((cnt == cnt[_rc_codes(fk)]).all())


def prep_alc_plain(al8: torch.Tensor, fk: int) -> torch.Tensor:
    """Plain PyTorch prep: int8 read-order slots [lanes, W] (-1 illegal or
    past the read) -> int32 [lanes, W]; with fk > 0, [lanes, 2W] whose
    right half holds each position's fk-mer code (the chars at p-fk+1..p,
    first char most significant, two bits each), -1 where any of those
    chars is illegal or p < fk-1."""
    al = al8.to(torch.int32)
    if not fk:
        return al
    W = al.shape[1]
    code = torch.zeros_like(al)
    ok = torch.ones(al.shape, dtype=torch.bool, device=al.device)
    for j in range(fk):
        sh = fk - 1 - j
        a_sh = torch.full_like(al, -1)
        if sh < W:
            a_sh[:, sh:] = al[:, :W - sh]
        code = code * 4 + a_sh.clamp(min=0)
        ok = ok & (a_sh >= 0)
    ok = ok & (torch.arange(W, device=al.device) >= fk - 1)[None, :]
    return torch.cat([al, torch.where(ok, code, -1)], dim=1)


def prep_alc(al8: torch.Tensor, fk: int) -> torch.Tensor:
    """The batch prep: the CUDA kernel on a CUDA tensor, the plain version
    on a CPU tensor."""
    if al8.device.type == "cuda":
        return kernels.prep_alc(al8, fk)
    if al8.device.type != "cpu":
        raise ValueError(f"no prep for device {al8.device}")
    return prep_alc_plain(al8, fk)
