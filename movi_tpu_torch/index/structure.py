"""Copy of movi_tpu/index/structure.py: the port keeps its own, so it imports nothing
of the JAX package.

The move structure index as structure-of-arrays (TPU device layout).

Re-architecture of the reference MoveStructure (include/move_structure.hpp:45-404,
src/move_structure_build.cpp) as flat arrays instead of packed bitfield rows:
the TPU query engine consumes plain int32/uint8 arrays via batched gathers, so
each per-mode C++ bit layout (include/move_row_configs.hpp) becomes an
alternative *serialization*, not an in-memory format.

Semantics mirrored for bit-identical query output:
  - run splitting by thresholds and MAX_RUN_LENGTH
    (move_structure_build.cpp:223-426, fill_bits_by_thresholds :733-745)
  - LF table construction via LF_heads + rank (:449-692)
  - threshold computation reverse sweep (:807-935), including the reference's
    treatment of the '$' run as alphabet index 0
  - first/last run tables (:694-731)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from ..constants import ALPHAMAP_3, END_CHARACTER, MODE_INFO, MODE_REGULAR_THR, SEPARATOR
from ..build.suffix import BWTRuns


@dataclass
class MoveIndex:
    """Structure-of-arrays move table.

    Arrays (all length r unless noted):
      n_arr[i]       run length
      offset_arr[i]  offset of the run head's LF image inside run id_arr[i]
      id_arr[i]      destination run of the run head's LF image
      c_arr[i]       alphabet index of the run character (end run: 0, as in
                     the reference's masked set_c; use end_bwt_idx to detect)
      all_p[r+1]     BWT start position of each run (all_p[r] = n)
      thr[i, 3]      clamped threshold values (0..n_i) per threshold slot
                     (slot = ALPHAMAP_3[row_char][other_char])
    """

    mode: str
    length: int
    r: int
    original_r: int
    end_bwt_idx: int
    alphabet: np.ndarray          # uint8[sigma]
    alphamap: np.ndarray          # int64[256], 256 = absent
    counts: np.ndarray            # int64[sigma]
    n_arr: np.ndarray             # int32[r]
    offset_arr: np.ndarray        # int32[r]
    id_arr: np.ndarray            # int64[r]
    c_arr: np.ndarray             # uint8[r]
    all_p: np.ndarray             # int64[r+1]
    thr: Optional[np.ndarray]     # int32[r, 3] or None for no-threshold modes
    end_bwt_idx_thresholds: np.ndarray  # int64[sigma]
    first_runs: np.ndarray        # int64[sigma+1]
    first_offsets: np.ndarray
    last_runs: np.ndarray
    last_offsets: np.ndarray
    separators: bool = False
    sep_thresholds: Optional[np.ndarray] = None   # int64[num_sep_rows, 4]
    sep_row_map: Optional[Dict[int, int]] = None  # row -> sep_thresholds idx
    extras: Dict[str, np.ndarray] = field(default_factory=dict)
    # sampled suffix array (ssa.movi analogue, move_structure_io.cpp:710-744)
    sampled_SA: Optional[np.ndarray] = None
    sa_sample_rate: int = 100

    # ---- lazily computed query acceleration tables (TPU-side design) ----
    _next_q: Optional[tuple] = None
    _next_s: Optional[tuple] = None

    @property
    def sigma(self) -> int:
        return len(self.alphabet)

    def char_of_row(self, i: int) -> int:
        if i == self.end_bwt_idx:
            return END_CHARACTER
        return int(self.alphabet[self.c_arr[i]])

    def _build_next(self, c_eff: np.ndarray):
        r, sigma = self.r, self.sigma
        nu = np.full((sigma, r), r, dtype=np.int64)
        nd = np.full((sigma, r), r, dtype=np.int64)
        idxs = np.arange(r)
        for j in range(sigma):
            isj = c_eff == j
            up = np.where(isj, idxs, -1)
            up = np.maximum.accumulate(up)
            nu[j] = np.where(up >= 0, up, r)
            down = np.where(isj, idxs, r)
            down = np.minimum.accumulate(down[::-1])[::-1]
            nd[j] = down
        return nu.astype(np.uint32), nd.astype(np.uint32)

    def next_tables(self):
        """next_up[j, i] / next_down[j, i]: nearest run with alphabet index j
        at-or-above / at-or-below run i (r if none), for PML repositioning.

        This is the TPU-native replacement for the reference's scan-based
        reposition_up/down (move_structure_query.cpp:188-232): a data-
        dependent-length scan becomes a single gather.  The constant mode
        (compute_nexts, move_structure_build.cpp:1080-1118) stores bounded
        u16 deltas; we store absolute u32 run ids since HBM capacity is
        cheaper than per-step gathers on TPU.

        NOTE: repositioning compares `alphabet[rlbwt[idx].get_c()]`, and the
        '$' run's stored c is 0 -- so the '$' run *matches* alphabet[0] here
        (reference behavior, move_structure_query.cpp:188-232,277).
        """
        if self._next_q is None:
            c_eff = self.c_arr.astype(np.int64)  # end row counts as index 0
            self._next_q = self._build_next(c_eff)
        return self._next_q

    def next_tables_search(self):
        """Like next_tables but for backward-search interval updates, which
        use get_char() and therefore skip the '$' run
        (move_structure_search.cpp:48-61, move_structure.cpp:288-293)."""
        if self._next_s is None:
            c_eff = self.c_arr.astype(np.int64).copy()
            if 0 <= self.end_bwt_idx < self.r:
                c_eff[self.end_bwt_idx] = -1
            self._next_s = self._build_next(c_eff)
        return self._next_s

    # ------------------------------------------------------------------
    def _to_arrays(self) -> dict:
        return dict(
            mode=np.frombuffer(self.mode.encode(), dtype=np.uint8),
            meta=np.array(
                [self.length, self.r, self.original_r, self.end_bwt_idx,
                 int(self.separators)],
                dtype=np.int64,
            ),
            alphabet=self.alphabet,
            alphamap=self.alphamap,
            counts=self.counts,
            n_arr=self.n_arr,
            offset_arr=self.offset_arr,
            id_arr=self.id_arr,
            c_arr=self.c_arr,
            all_p=self.all_p,
            thr=self.thr if self.thr is not None else np.zeros((0, 3), np.int32),
            end_thr=self.end_bwt_idx_thresholds,
            first_runs=self.first_runs,
            first_offsets=self.first_offsets,
            last_runs=self.last_runs,
            last_offsets=self.last_offsets,
            sep_thr=(self.sep_thresholds if self.sep_thresholds is not None
                     else np.zeros((0, 4), np.int64)),
            sep_rows=(np.array(sorted(self.sep_row_map), dtype=np.int64)
                      if self.sep_row_map else np.zeros(0, np.int64)),
            sampled_sa=(self.sampled_SA if self.sampled_SA is not None
                        else np.zeros(0, np.int64)),
            sa_rate=np.array([self.sa_sample_rate], dtype=np.int64),
        )

    def save(self, path: str):
        np.savez_compressed(path, **self._to_arrays())

    def save_mmap(self, dirpath: str):
        """Write the index as one raw .npy per array so queries can map
        the big tables instead of loading them — the analogue of the
        reference's optional mmap of rlbwt.movi
        (move_structure_io.cpp:361-397, --mmap)."""
        import os

        os.makedirs(dirpath, exist_ok=True)
        for k, v in self._to_arrays().items():
            np.save(os.path.join(dirpath, f"{k}.npy"), v)

    @classmethod
    def load_mmap(cls, dirpath: str) -> "MoveIndex":
        """Load a save_mmap() directory with the row arrays memory-mapped
        read-only (demand-paged, like the reference's --mmap)."""
        import os

        class _Dir:
            files = [f[:-4] for f in os.listdir(dirpath)
                     if f.endswith(".npy")]

            def __getitem__(self, k):
                return np.load(os.path.join(dirpath, f"{k}.npy"),
                               mmap_mode="r")

        return cls._from_arrays(_Dir())

    @classmethod
    def load(cls, path: str) -> "MoveIndex":
        z = np.load(path, allow_pickle=False)
        return cls._from_arrays(z)

    @classmethod
    def _from_arrays(cls, z) -> "MoveIndex":
        mode = z["mode"].tobytes().decode()
        length, r, original_r, end_bwt_idx, separators = (int(x) for x in z["meta"])
        thr = z["thr"]
        sep_rows = z["sep_rows"]
        sep_map = ({int(row): i for i, row in enumerate(sep_rows)}
                   if len(sep_rows) else None)
        return cls(
            mode=mode, length=length, r=r, original_r=original_r,
            end_bwt_idx=end_bwt_idx, alphabet=z["alphabet"],
            alphamap=z["alphamap"], counts=z["counts"], n_arr=z["n_arr"],
            offset_arr=z["offset_arr"], id_arr=z["id_arr"], c_arr=z["c_arr"],
            all_p=z["all_p"], thr=thr if thr.shape[0] else None,
            end_bwt_idx_thresholds=z["end_thr"], first_runs=z["first_runs"],
            first_offsets=z["first_offsets"], last_runs=z["last_runs"],
            last_offsets=z["last_offsets"], separators=bool(separators),
            sep_thresholds=z["sep_thr"] if z["sep_thr"].shape[0] else None,
            sep_row_map=sep_map,
            sampled_SA=(z["sampled_sa"] if "sampled_sa" in z.files
                        and z["sampled_sa"].shape[0] else None),
            sa_sample_rate=(int(z["sa_rate"][0]) if "sa_rate" in z.files
                            else 100),
        )


def _nt_split(bwt: np.ndarray, bounds: np.ndarray, end_char_total: int,
              counts: np.ndarray, alphamap: np.ndarray, max_span: int,
              max_rounds: int = 64) -> np.ndarray:
    """Nishimoto-Tabei-style balancing: insert run boundaries until every
    run's LF image spans at most `max_span` runs (=> fast_forward is
    bounded by max_span - 1 steps).

    Replaces the external r-permute tool (movi_launcher.cpp:221-227) and is
    the key enabler of the TPU fused engine: a bounded fast-forward becomes
    a fixed-size cum-length window resolved without data-dependent loops.
    """
    n = len(bwt)
    csum_counts = np.concatenate([[0], np.cumsum(counts)])
    for _ in range(max_rounds):
        all_p = np.concatenate([bounds, [n]])
        lens = np.diff(all_p)
        heads = bwt[bounds]
        r = len(bounds)
        # lf of each run head (LF_heads semantics)
        lf = np.zeros(r, dtype=np.int64)
        for j in range(len(counts)):
            isj = alphamap[heads] == j
            cum = np.cumsum(np.where(isj, lens, 0))
            prior = np.concatenate([[0], cum[:-1]])
            lf[isj] = 1 + csum_counts[j] + prior[isj]
        lf[heads == END_CHARACTER] = 0
        s = lf
        e = lf + lens - 1
        id_start = np.searchsorted(all_p[:-1], s, side="right") - 1
        id_end = np.searchsorted(all_p[:-1], e, side="right") - 1
        span = id_end - id_start + 1
        offenders = np.flatnonzero(span > max_span)
        if len(offenders) == 0:
            return bounds
        new_cuts = []
        for i in offenders:
            # cut at preimages of every max_span-th internal boundary
            js = np.arange(id_start[i] + max_span, id_end[i] + 1, max_span)
            new_cuts.append(all_p[i] + (all_p[js] - s[i]))
        bounds = np.unique(np.concatenate([bounds] + new_cuts))
    raise RuntimeError("NT splitting did not converge")


def build_move_index(runs: BWTRuns, mode: str = MODE_REGULAR_THR,
                     separators: bool = False,
                     bound_ff: int | None = None) -> MoveIndex:
    """Build the move index from original BWT runs + thresholds.

    bound_ff: if set, apply NT-style splitting so fast_forward never
    exceeds bound_ff steps (required by the fused TPU engine).
    """
    _, max_run_length, use_thresholds, split_thresholds = MODE_INFO[mode]
    bwt = runs.bwt
    n = len(bwt)
    original_r = len(runs.starts)

    # ---- alphabet (move_structure_build.cpp:428-447) ----
    present = np.zeros(256, dtype=np.int64)
    np.add.at(present, bwt, 1)
    present[END_CHARACTER] = 0
    alphabet = np.flatnonzero(present).astype(np.uint8)
    counts = present[alphabet]
    alphamap = np.full(256, 256, dtype=np.int64)
    alphamap[alphabet] = np.arange(len(alphabet))
    sigma = len(alphabet)

    # ---- run boundaries after splitting (:223-426, :733-745) ----
    parts = [np.zeros(1, dtype=np.int64), runs.starts.astype(np.int64)]
    if split_thresholds:
        thr = runs.thresholds
        parts.append(thr[(thr > 0) & (thr < n)].astype(np.int64))
    bounds = np.unique(np.concatenate(parts))
    # chunk segments longer than MAX_RUN_LENGTH
    seg_lens = np.diff(np.concatenate([bounds, [n]]))
    if np.any(seg_lens > max_run_length):
        extra = []
        for s, L in zip(bounds[seg_lens > max_run_length],
                        seg_lens[seg_lens > max_run_length]):
            k = int((L - 1) // max_run_length)
            extra.append(s + max_run_length * (np.arange(k, dtype=np.int64) + 1))
        bounds = np.unique(np.concatenate([bounds] + extra))
    if bound_ff is not None:
        bounds = _nt_split(bwt, bounds, int(present[END_CHARACTER]),
                           counts, alphamap, max_span=bound_ff + 1)
    all_p = np.concatenate([bounds, [n]])
    n_arr = np.diff(all_p).astype(np.int32)
    r = len(bounds)
    heads = bwt[bounds]  # uint8[r]

    # row -> original run index
    orig_of = np.searchsorted(runs.starts, bounds, side="right") - 1

    end_rows = np.flatnonzero(heads == END_CHARACTER)
    assert len(end_rows) == 1, "exactly one sentinel run expected"
    end_bwt_idx = int(end_rows[0])

    # c_arr: alphabet index; the end row stores 0 exactly like the
    # reference's masked set_c (move_row.cpp, alphamap[0] wraps to 0).
    c_arr = np.zeros(r, dtype=np.uint8)
    nz = heads != END_CHARACTER
    c_arr[nz] = alphamap[heads[nz]].astype(np.uint8)

    # ---- LF for run heads (:74-122, :503-522) ----
    # heads_rank[i] = # occurrences of heads[i] in BWT before run i
    heads_rank = np.zeros(r, dtype=np.int64)
    lens64 = n_arr.astype(np.int64)
    # vectorized: occurrences of char j before position all_p[i]
    for j in range(sigma):
        isj = (c_arr == j) & (np.arange(r) != end_bwt_idx)
        cum = np.cumsum(np.where(isj, lens64, 0))
        # occurrences before run i = cum[i-1] for rows of char j
        prior = np.concatenate([[0], cum[:-1]])
        heads_rank[isj] = prior[isj]

    csum_counts = np.concatenate([[0], np.cumsum(counts)])
    lf = np.zeros(r, dtype=np.int64)
    nz_rows = np.arange(r) != end_bwt_idx
    lf[nz_rows] = 1 + csum_counts[c_arr[nz_rows]] + heads_rank[nz_rows]
    lf[end_bwt_idx] = 0

    id_arr = np.searchsorted(all_p[:-1], lf, side="right") - 1
    offset_arr = (lf - all_p[id_arr]).astype(np.int32)

    # ---- thresholds (:807-935) ----
    thr = None
    end_thr = np.zeros(sigma, dtype=np.int64)
    sep_thresholds = None
    sep_row_map = None
    if use_thresholds:
        thr, end_thr, sep_thresholds, sep_row_map = _compute_row_thresholds(
            runs, bounds, all_p, n_arr, c_arr, orig_of, end_bwt_idx,
            alphabet, alphamap, sigma, n, separators, split_thresholds,
        )

    # ---- first/last run tables (:694-731) ----
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
        char_count += int(counts[i])
        # rank(bits, char_count) counts set bits in [0, char_count):
        # number of run starts < char_count
        occ_rank = int(np.searchsorted(all_p[:-1], char_count - 1, side="right"))
        last_runs[i + 1] = occ_rank - 1
        last_offsets[i + 1] = char_count - all_p[last_runs[i + 1]] - 1

    return MoveIndex(
        mode=mode, length=n, r=r, original_r=original_r,
        end_bwt_idx=end_bwt_idx, alphabet=alphabet, alphamap=alphamap,
        counts=counts, n_arr=n_arr, offset_arr=offset_arr, id_arr=id_arr,
        c_arr=c_arr, all_p=all_p, thr=thr, end_bwt_idx_thresholds=end_thr,
        first_runs=first_runs, first_offsets=first_offsets,
        last_runs=last_runs, last_offsets=last_offsets,
        separators=separators, sep_thresholds=sep_thresholds,
        sep_row_map=sep_row_map,
    )


def _compute_row_thresholds(runs, bounds, all_p, n_arr, c_arr, orig_of,
                            end_bwt_idx, alphabet, alphamap, sigma, n,
                            separators, split_thresholds):
    """Reverse threshold sweep (move_structure_build.cpp:807-935), vectorized.

    For row i and character j != row_char: the active absolute threshold is
    thresholds[orig_of(i')] where i' is the nearest row *below or equal*
    processed earlier -- i.e. the smallest i' > i with effective char j.
    The '$' row's effective char is alphabet index 0 (set_c masking quirk),
    exactly as in the reference.
    """
    r = len(bounds)
    run_thr = runs.thresholds  # absolute positions per original run

    c_eff = c_arr.astype(np.int64)  # end row already 0

    idxs = np.arange(r)
    # value_j[i] = active threshold for char j at row i (abs position)
    thr_abs = np.full((sigma, r), n, dtype=np.int64)
    for j in range(sigma):
        isj = c_eff == j
        # smallest i' > i with c_eff == j  (shift the "at or after" scan)
        nxt = np.where(isj, idxs, r)
        nxt = np.minimum.accumulate(nxt[::-1])[::-1]
        nxt_after = np.concatenate([nxt[1:], [r]])
        valid = nxt_after < r
        vals = np.full(r, n, dtype=np.int64)
        vals[valid] = run_thr[orig_of[nxt_after[valid]]]
        thr_abs[j] = vals

    # clamp into each row's range
    lo = all_p[:-1]
    hi = all_p[:-1] + n_arr.astype(np.int64)
    thr = np.zeros((r, 3), dtype=np.int32)
    end_thr = np.zeros(sigma, dtype=np.int64)
    sep_list = []
    sep_row_map = {}

    sep_index = alphamap[SEPARATOR] if separators else -1

    is_sep_row = (c_eff == sep_index) if separators else np.zeros(r, bool)
    if separators:
        # The reference pushes a separators_thresholds entry for every row
        # whose *stored* c is the separator index -- including the '$' row
        # (set_c masking quirk), whose values remain zero because
        # set_threshold_for_one_character diverts them to
        # end_bwt_idx_thresholds (move_structure_build.cpp:776-783,828-831).
        # Entries are pushed while scanning rows in DESCENDING order.
        for i in np.flatnonzero(is_sep_row)[::-1]:
            sep_row_map[int(i)] = len(sep_list)
            sep_list.append(np.zeros(4, dtype=np.int64))
        is_sep_row &= idxs != end_bwt_idx

    for j in range(sigma):
        vals = thr_abs[j]
        clamped = np.where(vals >= hi, n_arr.astype(np.int64),
                           np.where(vals <= lo, 0, vals - lo))
        if split_thresholds:
            inside = (vals < hi) & (vals > lo)
            bad = inside & (c_eff != j) & (idxs != end_bwt_idx) & ~is_sep_row
            if np.any(bad):
                raise AssertionError(
                    "threshold strictly inside a split row -- splitting bug")
        # end row stores into end_bwt_idx_thresholds
        if separators:
            if j > 0:
                end_thr[j - 1] = clamped[end_bwt_idx]
        elif c_eff[end_bwt_idx] != j:
            end_thr[j] = clamped[end_bwt_idx]
        # separator rows store all four ACGT thresholds
        if separators and j > 0:
            for i in np.flatnonzero(is_sep_row):
                sep_list[sep_row_map[int(i)]][j - 1] = clamped[i]
        # regular rows: slot via ALPHAMAP_3
        store = (c_eff != j) & (idxs != 0) & (idxs != end_bwt_idx) & ~is_sep_row
        if separators:
            store &= j != 0  # no threshold stored for the separator char
        rows_idx = np.flatnonzero(store)
        if len(rows_idx):
            if separators:
                slots = ALPHAMAP_3[c_eff[rows_idx] - 1, j - 1]
            else:
                slots = ALPHAMAP_3[c_eff[rows_idx], j]
            thr[rows_idx, slots] = clamped[rows_idx]

    # row 0: all slots 0 (:908-931)
    thr[0, :] = 0
    if separators and 0 in sep_row_map:
        sep_list[sep_row_map[0]][:] = 0

    sep_thr = np.stack(sep_list) if sep_list else None
    return thr, end_thr, sep_thr, (sep_row_map or None)
