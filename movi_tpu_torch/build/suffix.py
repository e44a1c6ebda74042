"""Copy of movi_tpu/build/suffix.py: the port keeps its own, so it imports nothing
of the JAX package.

Suffix array, BWT, LCP, and per-run threshold computation.

Replaces the reference's external `pfp-thresholds` toolchain
(CMakeLists.txt:80-94; invoked from movi_launcher.cpp:204-212).  Instead of
prefix-free parsing we compute the suffix array directly (a C++ SA-IS kernel
is used when built, with a NumPy prefix-doubling fallback), then derive:
  - BWT over text + sentinel (END_CHARACTER = 0, utils.hpp:162)
  - LCP array (Kasai)
  - one threshold per original BWT run: the position of the minimum LCP
    value between the previous occurrence of the run's character and the
    run head (the MONI/SPUMONI threshold definition).  First-occurrence
    runs (and the sentinel run) get threshold 0.
"""

from __future__ import annotations

import ctypes
import os
from dataclasses import dataclass

import numpy as np

_NATIVE = None


def _load_native():
    """Load the optional C++ kernel (native/libmovi_native.so)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(here, "native", "libmovi_native.so")
    if not os.path.exists(so):
        _NATIVE = False
        return False
    lib = ctypes.CDLL(so)
    lib.movi_sais.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.movi_sais.restype = ctypes.c_int
    lib.movi_lcp_kasai.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
    ]
    lib.movi_lcp_kasai.restype = ctypes.c_int
    lib.movi_thresholds.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.movi_thresholds.restype = ctypes.c_int
    _NATIVE = lib
    return lib


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of `text` (uint8; must already include the 0 sentinel
    as its unique, smallest, final byte)."""
    assert text.dtype == np.uint8
    assert text[-1] == 0 and not np.any(text[:-1] == 0)
    lib = _load_native()
    n = len(text)
    if lib:
        sa = np.zeros(n, dtype=np.int64)
        rc = lib.movi_sais(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
        )
        if rc == 0:
            return sa
    return _suffix_array_doubling(text)


def _suffix_array_doubling(text: np.ndarray) -> np.ndarray:
    """O(n log^2 n) prefix-doubling suffix array (NumPy)."""
    n = len(text)
    rank = text.astype(np.int64)
    sa = np.argsort(rank, kind="stable")
    k = 1
    tmp = np.empty(n, dtype=np.int64)
    while True:
        # key = (rank[i], rank[i+k]) with out-of-range -> -1
        second = np.full(n, -1, dtype=np.int64)
        second[: n - k] = rank[k:]
        order = np.lexsort((second, rank))
        sa = order
        # recompute ranks
        r_sa = rank[sa]
        s_sa = second[sa]
        new_group = np.empty(n, dtype=bool)
        new_group[0] = True
        new_group[1:] = (r_sa[1:] != r_sa[:-1]) | (s_sa[1:] != s_sa[:-1])
        tmp[sa] = np.cumsum(new_group) - 1
        rank, tmp = tmp.copy(), rank
        if rank[sa[-1]] == n - 1:
            break
        k *= 2
    return sa


def bwt_from_sa(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """BWT[i] = text[SA[i]-1] (text[-1] when SA[i]==0)."""
    return text[sa - 1]  # numpy wraps -1 to the sentinel position


def lcp_kasai(text: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """LCP array: lcp[i] = lcp(suffix(sa[i-1]), suffix(sa[i])), lcp[0] = 0."""
    n = len(text)
    lib = _load_native()
    if lib:
        lcp = np.zeros(n, dtype=np.int64)
        rank = np.zeros(n, dtype=np.int64)
        rc = lib.movi_lcp_kasai(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lcp.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            rank.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(n),
        )
        if rc == 0:
            return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, dtype=np.int64)
    h = 0
    for i in range(n):
        r = rank[i]
        if r > 0:
            j = sa[r - 1]
            m = n - max(i, j)
            while h < m and text[i + h] == text[j + h]:
                h += 1
            lcp[r] = h
            if h > 0:
                h -= 1
        else:
            h = 0
    return lcp


@dataclass
class BWTRuns:
    """Original (maximal) BWT runs and their thresholds."""

    bwt: np.ndarray          # uint8[n]
    heads: np.ndarray        # uint8[original_r] run head characters
    lens: np.ndarray         # int64[original_r]
    starts: np.ndarray       # int64[original_r] run start positions
    thresholds: np.ndarray   # int64[original_r] absolute threshold positions
    sa: Optional[np.ndarray] = None  # int64[n] full suffix array (build-time)

    def sampled_sa(self, rate: int = 100) -> np.ndarray:
        """Sampled SA entries: sampled[p // rate] = SA[p] for p % rate == 0.

        Replaces the reference's O(n) LF-walk construction
        (move_structure_build.cpp:1173-1212) with a direct slice of the
        suffix array the index build already has.
        """
        assert self.sa is not None
        return self.sa[::rate].copy()


def find_runs(bwt: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = len(bwt)
    boundary = np.empty(n, dtype=bool)
    boundary[0] = True
    boundary[1:] = bwt[1:] != bwt[:-1]
    starts = np.flatnonzero(boundary).astype(np.int64)
    lens = np.empty(len(starts), dtype=np.int64)
    lens[:-1] = np.diff(starts)
    lens[-1] = n - starts[-1]
    heads = bwt[starts]
    return heads, lens, starts


def compute_thresholds(bwt: np.ndarray, lcp: np.ndarray,
                       heads: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Threshold per original run.

    For run k with head character c starting at s, let e be the last
    position of the previous run of c (e < s).  The threshold is the
    first position t in (e, s] minimizing LCP[t].  If there is no
    previous run of c (including the sentinel run), the threshold is 0.

    This reproduces the `.thr_pos` values consumed by
    move_structure_build.cpp:17-21 / compute_thresholds (:807-935).
    """
    original_r = len(starts)
    n = len(bwt)
    thresholds = np.zeros(original_r, dtype=np.int64)
    lib = _load_native()
    if lib:
        heads_c = np.ascontiguousarray(heads)
        starts_c = np.ascontiguousarray(starts)
        lcp_c = np.ascontiguousarray(lcp)
        rc = lib.movi_thresholds(
            heads_c.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            starts_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            lcp_c.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            thresholds.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(original_r), ctypes.c_int64(n),
        )
        if rc == 0:
            return thresholds
    ends = np.empty(original_r, dtype=np.int64)
    ends[:-1] = starts[1:]
    ends[-1] = n
    # last position of previous run with the same head char
    prev_end_for_run = np.full(original_r, -1, dtype=np.int64)
    last_end = {}
    for k in range(original_r):
        c = heads[k]
        if c in last_end:
            prev_end_for_run[k] = last_end[c]
        last_end[c] = ends[k] - 1
    for k in range(original_r):
        pe = prev_end_for_run[k]
        if pe < 0:
            thresholds[k] = 0
            continue
        lo, hi = pe + 1, starts[k]  # inclusive range [lo, hi]
        seg = lcp[lo : hi + 1]
        thresholds[k] = lo + int(np.argmin(seg))
    return thresholds


def read_thresholds_file(path: str) -> np.ndarray:
    """Read a `.thr_pos` file of 5-byte little-endian thresholds with the
    reference's overflow recovery (read_thresholds, utils.cpp:150-200):
    a sudden >10x drop while the previous value was large means the 5-byte
    counter wrapped, so add another 2^40."""
    raw = np.fromfile(path, dtype=np.uint8)
    assert len(raw) % 5 == 0, f"invalid thresholds file {path}"
    raw = raw.reshape(-1, 5).astype(np.uint64)
    vals = (raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
            | (raw[:, 3] << 24) | (raw[:, 4] << 32)).astype(np.int64)
    max5 = np.int64(1) << 40
    step = 0
    out = vals.copy()
    for i in range(1, len(vals)):
        prev = out[i - 1] - step * max5
        if vals[i] != 0 and vals[i] < prev // 10 and prev > max5 // 10:
            step += 1
        out[i] = vals[i] + step * max5
    return out


def _write_u40(vals: np.ndarray, path: str):
    v = np.asarray(vals, dtype=np.int64)
    assert int(v.max(initial=0)) < (1 << 40), "value exceeds 5 bytes"
    raw = np.zeros((len(v), 5), dtype=np.uint8)
    for b in range(5):
        raw[:, b] = (v >> (8 * b)) & 0xFF
    raw.tofile(path)


def write_preprocessed(runs: BWTRuns, bwt_file: str):
    """Persist the BWT+thresholds stage in the reference pipeline's own
    intermediate formats: `<bwt>.heads` (run head chars), `<bwt>.len`
    (5-byte run lengths, build_rlbwt movi.cpp:505-559) and
    `<prefix>.thr_pos` (5-byte thresholds, pfp_thresholds output read by
    utils.cpp:150-200).  `runs_from_preprocessed` reads these back, so a
    killed build resumes without recomputing the suffix array -- the
    launcher's --keep/--skip-pfp stage resume (movi_launcher.cpp:20-30),
    with artifacts a reference install can consume directly."""
    runs.heads.astype(np.uint8).tofile(bwt_file + ".heads")
    _write_u40(runs.lens, bwt_file + ".len")
    prefix = bwt_file[:-4] if bwt_file.endswith(".bwt") else bwt_file
    _write_u40(runs.thresholds, prefix + ".thr_pos")


def runs_from_preprocessed(bwt_file: str) -> BWTRuns:
    """BWTRuns from the reference pipeline's preprocessed artifacts:
    `<bwt>.heads` + `<bwt>.len` (from `movi rlbwt` / `pfp_thresholds -r`)
    or the raw `<bwt>` file, plus `<prefix>.thr_pos` thresholds
    (compute_length_from_bwt, move_structure_build.cpp:143-202).
    No suffix array is available on this path (sa=None), so SA sampling
    must go through the LF sweep (index/sweeps.py)."""
    heads_path, len_path = bwt_file + ".heads", bwt_file + ".len"
    if os.path.exists(heads_path) and os.path.exists(len_path):
        heads = np.fromfile(heads_path, dtype=np.uint8)
        raw = np.fromfile(len_path, dtype=np.uint8)
        assert len(raw) % 5 == 0, f"invalid len file {len_path}"
        raw = raw.reshape(-1, 5).astype(np.int64)
        lens = (raw[:, 0] | (raw[:, 1] << 8) | (raw[:, 2] << 16)
                | (raw[:, 3] << 24) | (raw[:, 4] << 32))
        starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
        bwt = np.repeat(heads, lens)
    else:
        bwt = np.fromfile(bwt_file, dtype=np.uint8)
        heads, lens, starts = find_runs(bwt)
    # pfp writes the sentinel as 0x00 (END_CHARACTER, utils.hpp:162)
    prefix = bwt_file[:-4] if bwt_file.endswith(".bwt") else bwt_file
    thr_path = prefix + ".thr_pos"
    if os.path.exists(thr_path):
        thresholds = read_thresholds_file(thr_path)
        assert len(thresholds) == len(starts), (
            f"thresholds count {len(thresholds)} != runs {len(starts)}")
    else:
        thresholds = np.zeros(len(starts), dtype=np.int64)
    return BWTRuns(bwt=bwt, heads=heads, lens=lens, starts=starts,
                   thresholds=thresholds, sa=None)


def build_bwt_runs(text_no_sentinel: np.ndarray) -> BWTRuns:
    """Full pipeline: text -> SA -> BWT -> LCP -> runs + thresholds."""
    text = np.concatenate([text_no_sentinel, np.zeros(1, dtype=np.uint8)])
    sa = suffix_array(text)
    bwt = bwt_from_sa(text, sa)
    lcp = lcp_kasai(text, sa)
    heads, lens, starts = find_runs(bwt)
    thr = compute_thresholds(bwt, lcp, heads, starts)
    return BWTRuns(bwt=bwt, heads=heads, lens=lens, starts=starts,
                   thresholds=thr, sa=sa)
