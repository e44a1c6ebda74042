"""Copy of movi_tpu/index/resplit.py: the port keeps its own, so it imports nothing
of the JAX package.

Load-time NT re-splitting of reference-built indexes.

A `movi`-built `index.movi` (or any index without the bound_ff=1
invariant) loads fine but fails the fused engines' bounded-fast-forward
check, silently dropping queries to the compact fallback.  The
reference's launcher guarantees every index runs its fast path
(movi_launcher.cpp:408-434); this module provides the equivalent: the
BWT is reconstructable from the loaded rows (np.repeat of head chars),
`_nt_split` (index/structure.py) inserts the balancing boundaries, and
the row arrays are rebuilt over the refined bounds.

Thresholds need NO LCP recomputation: re-splitting only ADDS
boundaries, and a clamped per-row threshold remaps exactly to each
sub-row.  With T = parent_start + thr_parent (the parent's clamped
absolute view) the sub-row value clip(T - sub_start, 0, n_sub) equals
the true clamp in all three cases: interior thresholds carry over
verbatim, a parent 0 means the true position is at-or-before the
parent (so every sub-row clamps to 0), and a parent n means it is
at-or-after the parent end (every sub-row clamps to its n).
"""

from __future__ import annotations

import numpy as np

from ..constants import END_CHARACTER, MODE_INFO
from .structure import MoveIndex, _nt_split


def needs_resplit(ix: MoveIndex, bound_ff: int = 1) -> bool:
    """True when the index violates the bounded-fast-forward invariant
    the fused engines require."""
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr
    e = lf_abs + ix.n_arr - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    return int((id_end - ix.id_arr).max()) > bound_ff


def resplit_index(ix: MoveIndex, bound_ff: int = 1) -> MoveIndex:
    """Rebuild `ix` with NT splitting (fast_forward <= bound_ff) so the
    fused engines apply.  Supports non-separator indexes; thresholds
    (when present) are remapped, not recomputed."""
    assert not ix.separators, "resplit does not support separator indexes"
    n = int(ix.all_p[-1])
    r_old = ix.r

    # ---- reconstruct the BWT from the rows ----
    head_bytes = ix.alphabet[ix.c_arr].copy()
    head_bytes[ix.end_bwt_idx] = END_CHARACTER
    bwt = np.repeat(head_bytes, ix.n_arr.astype(np.int64))

    # ---- refined bounds: old bounds + max-run chunking + NT cuts ----
    max_run_length = MODE_INFO[ix.mode][1]
    bounds = ix.all_p[:-1].astype(np.int64)
    seg_lens = np.diff(np.concatenate([bounds, [n]]))
    if np.any(seg_lens > max_run_length):
        extra = []
        for s, L in zip(bounds[seg_lens > max_run_length],
                        seg_lens[seg_lens > max_run_length]):
            k = int((L - 1) // max_run_length)
            extra.append(s + max_run_length
                         * (np.arange(k, dtype=np.int64) + 1))
        bounds = np.unique(np.concatenate([bounds] + extra))
    alphamap = ix.alphamap.astype(np.int64)
    bounds = _nt_split(bwt, bounds, 0, ix.counts.astype(np.int64),
                       alphamap, max_span=bound_ff + 1)

    all_p = np.concatenate([bounds, [n]])
    n_arr = np.diff(all_p).astype(np.int32)
    r = len(bounds)
    heads = bwt[bounds]
    parent = np.searchsorted(ix.all_p[:-1], bounds, side="right") - 1

    end_rows = np.flatnonzero(heads == END_CHARACTER)
    assert len(end_rows) == 1
    end_bwt_idx = int(end_rows[0])

    c_arr = np.zeros(r, dtype=np.uint8)
    nz = heads != END_CHARACTER
    c_arr[nz] = alphamap[heads[nz]].astype(np.uint8)

    # ---- LF over the refined bounds (build_move_index semantics) ----
    sigma = len(ix.alphabet)
    heads_rank = np.zeros(r, dtype=np.int64)
    lens64 = n_arr.astype(np.int64)
    for j in range(sigma):
        isj = (c_arr == j) & (np.arange(r) != end_bwt_idx)
        cum = np.cumsum(np.where(isj, lens64, 0))
        prior = np.concatenate([[0], cum[:-1]])
        heads_rank[isj] = prior[isj]
    csum_counts = np.concatenate([[0], np.cumsum(ix.counts)])
    lf = np.zeros(r, dtype=np.int64)
    nz_rows = np.arange(r) != end_bwt_idx
    lf[nz_rows] = 1 + csum_counts[c_arr[nz_rows]] + heads_rank[nz_rows]
    lf[end_bwt_idx] = 0
    id_arr = np.searchsorted(all_p[:-1], lf, side="right") - 1
    offset_arr = (lf - all_p[id_arr]).astype(np.int32)

    # ---- threshold remap (see module docstring) ----
    thr = None
    if ix.thr is not None:
        t_abs = (ix.all_p[:-1][parent][:, None]
                 + ix.thr[parent].astype(np.int64))
        rel = t_abs - all_p[:-1][:, None]
        thr = np.clip(rel, 0, n_arr.astype(np.int64)[:, None]).astype(
            ix.thr.dtype)

    # ---- first/last run tables (build_move_index:694-731) ----
    first_runs = np.zeros(sigma + 1, dtype=np.int64)
    first_offsets = np.zeros(sigma + 1, dtype=np.int64)
    last_runs = np.zeros(sigma + 1, dtype=np.int64)
    last_offsets = np.zeros(sigma + 1, dtype=np.int64)
    char_count = 1
    for i in range(sigma):
        last_run = last_runs[i]
        last_offset = last_offsets[i]
        if last_offset + 1 >= n_arr[last_run]:
            first_runs[i + 1] = last_run + 1
            first_offsets[i + 1] = 0
        else:
            first_runs[i + 1] = last_run
            first_offsets[i + 1] = last_offset + 1
        char_count += int(ix.counts[i])
        occ_rank = int(np.searchsorted(all_p[:-1], char_count - 1,
                                       side="right"))
        last_runs[i + 1] = occ_rank - 1
        last_offsets[i + 1] = char_count - all_p[last_runs[i + 1]] - 1

    # sampled SA is positional over BWT rows, independent of run bounds
    return MoveIndex(
        mode=ix.mode, length=n, r=r, original_r=ix.original_r,
        end_bwt_idx=end_bwt_idx, alphabet=ix.alphabet,
        alphamap=ix.alphamap, counts=ix.counts, n_arr=n_arr,
        offset_arr=offset_arr, id_arr=id_arr, c_arr=c_arr, all_p=all_p,
        thr=thr, end_bwt_idx_thresholds=ix.end_bwt_idx_thresholds,
        first_runs=first_runs, first_offsets=first_offsets,
        last_runs=last_runs, last_offsets=last_offsets,
        separators=False, sep_thresholds=None, sep_row_map=None,
        sampled_SA=ix.sampled_SA, sa_sample_rate=ix.sa_sample_rate,
    )
