"""Copy of movi_tpu/cpu_ref/scalar.py: the port keeps its own, so it imports nothing
of the JAX package.

Scalar reference query engine (NumPy, one read at a time).

This is the ground truth the vectorized TPU engine must match bit-for-bit,
in the same way the reference's prefetch engine is tested against its
`--no-prefetch` scalar path (tests/test_pml.cpp).

Mirrored semantics:
  - LF_move / fast_forward: src/move_structure.cpp:59-87, :524-545
  - query_pml + reposition_thresholds: src/move_structure_query.cpp:234-601
  - reposition_randomly tie-break (offset*2 < n): :604-688
  - backward search / count: src/move_structure_search.cpp
  - query_zml: src/move_structure_query.cpp:690-786
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from ..constants import ALPHAMAP_3, SEPARATOR
from ..index.structure import MoveIndex


class ScalarEngine:
    def __init__(self, index: MoveIndex, ignore_illegal_chars: int = 0,
                 seed: int = 0):
        self.ix = index
        # query (PML reposition) tables: '$' run matches alphabet[0]
        self.nu, self.nd = index.next_tables()
        # search tables: '$' run matches nothing
        self.nu_s, self.nd_s = index.next_tables_search()
        # --ignore-illegal-chars: 0 = off, 1 = map to 'A', 2 = random base
        # (check_alphabet, move_structure.cpp:383-397)
        self.ignore_illegal_chars = ignore_illegal_chars
        self._rng = np.random.default_rng(seed)

    def resolve_char(self, c: int) -> int:
        """Apply the --ignore-illegal-chars substitution."""
        if self.ignore_illegal_chars and not self.check_alphabet(c):
            ix = self.ix
            if ix.separators and c == SEPARATOR:
                return c
            if self.ignore_illegal_chars == 1:
                return ord("A")
            return int(ix.alphabet[self._rng.integers(0, ix.sigma)])
        return c

    # ------------------------------------------------------------------
    def lf_move(self, offset: int, i: int) -> Tuple[int, int, int]:
        """Return (offset', idx', ff_count) -- move_structure.cpp:59-87."""
        ix = self.ix
        idx = int(ix.id_arr[i])
        offset = int(ix.offset_arr[i]) + offset
        ff = 0
        while idx < ix.r - 1 and offset >= ix.n_arr[idx]:
            offset -= int(ix.n_arr[idx])
            idx += 1
            ff += 1
        return offset, idx, ff

    def get_SA_entry(self, idx: int, offset: int) -> int:
        """SA value at (run idx, offset): LF-walk to the nearest sampled
        position (move_structure.cpp:35-48)."""
        ix = self.ix
        assert ix.sampled_SA is not None, "index has no sampled SA"
        rate = ix.sa_sample_rate
        abs_offset = int(ix.all_p[idx]) + offset
        distance = 0
        while abs_offset % rate != 0:
            offset, idx, _ = self.lf_move(offset, idx)
            abs_offset = int(ix.all_p[idx]) + offset
            distance += 1
        return int(ix.sampled_SA[abs_offset // rate]) + distance

    def check_alphabet(self, c: int) -> bool:
        ix = self.ix
        if ix.separators and c == SEPARATOR:
            return False
        return ix.alphamap[c] != 256

    def _threshold_value(self, idx: int, read_alpha: int) -> int:
        """reposition_thresholds threshold lookup
        (move_structure_query.cpp:513-566)."""
        ix = self.ix
        alphabet_index = read_alpha
        if ix.separators:
            assert alphabet_index != 0
            alphabet_index -= 1
        if idx == ix.end_bwt_idx:
            return int(ix.end_bwt_idx_thresholds[alphabet_index])
        row_c = int(ix.c_arr[idx])
        if ix.separators and ix.alphabet[row_c] == SEPARATOR:
            return int(ix.sep_thresholds[ix.sep_row_map[idx]][alphabet_index])
        if ix.separators:
            slot = int(ALPHAMAP_3[row_c - 1][alphabet_index])
        else:
            slot = int(ALPHAMAP_3[row_c][alphabet_index])
        assert slot != 3
        return int(ix.thr[idx, slot])

    def reposition_thresholds(self, idx: int, offset: int, read_alpha: int
                              ) -> Tuple[int, bool]:
        """Return (new_idx, went_up)."""
        ix = self.ix
        thr = self._threshold_value(idx, read_alpha)
        if offset >= thr:
            new_idx = int(self.nd[read_alpha, idx + 1]) if idx + 1 < ix.r else ix.r
            return new_idx, False
        else:
            new_idx = int(self.nu[read_alpha, idx - 1]) if idx > 0 else ix.r
            return new_idx, True

    def reposition_randomly(self, idx: int, offset: int, read_alpha: int
                            ) -> Tuple[int, bool]:
        """Deterministic direction choice offset*2 < n
        (move_structure_query.cpp:604-688)."""
        ix = self.ix
        direction_up = 2 * offset < int(ix.n_arr[idx])
        if idx == ix.r - 1:
            direction_up = True
        if idx == 0:
            direction_up = False
        def up():
            return int(self.nu[read_alpha, idx - 1]) if idx > 0 else ix.r
        def down():
            return int(self.nd[read_alpha, idx + 1]) if idx + 1 < ix.r else ix.r
        if direction_up:
            ni = up()
            if ni >= ix.r:
                return down(), False
            return ni, True
        else:
            ni = down()
            if ni >= ix.r:
                return up(), True
            return ni, False

    # ------------------------------------------------------------------
    def query_pml(self, read: bytes, random_repositioning: bool = False,
                  collect_sa: bool = False):
        """PMLs in processing order (right-to-left), as MoveQuery stores
        them (move_structure_query.cpp:234-474).  With collect_sa, returns
        (pmls, sa_entries) like --sa-entries (:354-357)."""
        ix = self.ix
        use_thr = ix.thr is not None
        r_arr = np.frombuffer(read, dtype=np.uint8)
        idx = ix.r - 1
        offset = int(ix.n_arr[idx]) - 1
        match_len = 0
        out: List[int] = []
        sa_out: List[int] = []
        for pos in range(len(r_arr) - 1, -1, -1):
            c = self.resolve_char(int(r_arr[pos]))
            if not self.check_alphabet(c):
                match_len = 0
            else:
                read_alpha = int(ix.alphamap[c])
                # NB: raw stored char -- the '$' run reads as alphabet[0]
                # exactly like `alphabet[row.get_c()]` in the reference
                # (move_structure_query.cpp:277).
                row_char = int(ix.alphabet[ix.c_arr[idx]])
                if row_char == c:
                    match_len += 1
                else:
                    if use_thr and not random_repositioning:
                        idx, up = self.reposition_thresholds(idx, offset,
                                                             read_alpha)
                    else:
                        idx, up = self.reposition_randomly(idx, offset,
                                                           read_alpha)
                    match_len = 0
                    assert idx < ix.r, "character not found in index"
                    offset = int(ix.n_arr[idx]) - 1 if up else 0
            out.append(match_len)
            if collect_sa:
                sa_out.append(self.get_SA_entry(idx, offset))
            offset, idx, _ = self.lf_move(offset, idx)
        if collect_sa:
            return out, sa_out
        return out

    # ------------------------------------------------------------------
    # Backward search (count queries)
    def _update_interval(self, rs, os_, re, oe, read_alpha):
        """move_structure_search.cpp:4-64 scan path, via next tables.

        Interval-update scans use get_char(), so the '$' run never matches
        (search tables).
        """
        ix = self.ix
        if rs <= re and self._row_alpha(rs) != read_alpha:
            rs, os_ = int(self.nd_s[read_alpha, rs]), 0
        if rs >= ix.r or rs > re:
            return 1, 0, 0, 0  # canonical empty interval
        if self._row_alpha(re) != read_alpha:
            # a matching row >= rs exists (rs itself), so this is in range
            re = int(self.nu_s[read_alpha, re])
            oe = int(ix.n_arr[re]) - 1
        return rs, os_, re, oe

    def _row_alpha(self, i: int) -> int:
        ix = self.ix
        if i == ix.end_bwt_idx:
            return -1
        return int(ix.c_arr[i])

    @staticmethod
    def _is_empty(rs, os_, re, oe):
        return not (rs < re or (rs == re and os_ <= oe))

    def interval_count(self, rs, os_, re, oe) -> int:
        ix = self.ix
        if self._is_empty(rs, os_, re, oe):
            return 0
        if rs == re:
            return oe - os_ + 1
        total = (int(ix.n_arr[rs]) - os_) + (oe + 1)
        total += int(np.sum(ix.n_arr[rs + 1 : re]))
        return total

    def initialize_backward_search(self, c: int):
        ix = self.ix
        a = int(ix.alphamap[c])
        if a >= ix.sigma:
            # Illegal character: the reference reads out of bounds here
            # (move_structure_search.cpp:285-291 with an unchecked char,
            # only reachable from the look-ahead probe); we return the
            # canonical empty interval, which makes the probe fail and
            # never changes emissions.
            return (1, 0, 0, 0)
        return (int(ix.first_runs[a + 1]), int(ix.first_offsets[a + 1]),
                int(ix.last_runs[a + 1]), int(ix.last_offsets[a + 1]))

    def backward_search_step(self, c: int, rs, os_, re, oe):
        if not self.check_alphabet(c):
            return 1, 0, 0, 0
        read_alpha = int(self.ix.alphamap[c])
        rs, os_, re, oe = self._update_interval(rs, os_, re, oe, read_alpha)
        if self._is_empty(rs, os_, re, oe):
            return rs, os_, re, oe
        os_, rs, _ = self.lf_move(os_, rs)
        oe, re, _ = self.lf_move(oe, re)
        return rs, os_, re, oe

    def query_count(self, read: bytes) -> Tuple[int, int]:
        """Return (pos_on_r, match_count) as query_backward_search
        (move_structure_search.cpp:340-352)."""
        r_arr = np.frombuffer(read, dtype=np.uint8)
        pos = len(r_arr) - 1
        if not self.check_alphabet(int(r_arr[pos])):
            return pos + 1, 0
        rs, os_, re, oe = self.initialize_backward_search(int(r_arr[pos]))
        prev = (rs, os_, re, oe)
        while pos > 0 and not self._is_empty(rs, os_, re, oe):
            prev = (rs, os_, re, oe)
            rs, os_, re, oe = self.backward_search_step(int(r_arr[pos - 1]),
                                                        rs, os_, re, oe)
            if not self._is_empty(rs, os_, re, oe):
                pos -= 1
        if self._is_empty(rs, os_, re, oe):
            rs, os_, re, oe = prev
        return pos, self.interval_count(rs, os_, re, oe)

    # ------------------------------------------------------------------
    def query_zml(self, read: bytes) -> List[int]:
        """ZML (Ziv-Merhav) matching lengths in processing order
        (move_structure_query.cpp:690-786)."""
        r_arr = np.frombuffer(read, dtype=np.uint8)
        out: List[int] = []
        pos = len(r_arr) - 1
        match_len = 0
        while pos >= 0 and not self.check_alphabet(int(r_arr[pos])):
            out.append(0)
            pos -= 1
        if pos < 0:
            return out
        interval = self.initialize_backward_search(int(r_arr[pos]))
        rs, os_, re, oe = interval
        while pos > 0:
            nrs, nos, nre, noe = self.backward_search_step(
                int(r_arr[pos - 1]), rs, os_, re, oe)
            if not self._is_empty(nrs, nos, nre, noe):
                out.append(match_len)
                pos -= 1
                match_len += 1
                rs, os_, re, oe = nrs, nos, nre, noe
            else:
                out.append(match_len)
                pos -= 1
                match_len = 0
                while pos > 0 and not self.check_alphabet(int(r_arr[pos])):
                    out.append(0)
                    pos -= 1
                if self.check_alphabet(int(r_arr[pos])):
                    rs, os_, re, oe = self.initialize_backward_search(
                        int(r_arr[pos]))
                else:
                    rs, os_, re, oe = 1, 0, 0, 0
        if self._is_empty(rs, os_, re, oe):
            match_len = 0
        out.append(match_len)
        return out

    # ------------------------------------------------------------------
    def verify_lf_loop(self) -> bool:
        """n LF_moves from the end run must visit every (run, offset) once
        and loop back (move_structure_query.cpp:151-186)."""
        ix = self.ix
        idx = ix.end_bwt_idx
        offset = 0
        visited = 0
        seen = np.zeros(ix.length, dtype=bool)
        for _ in range(ix.length):
            offset, idx, _ = self.lf_move(offset, idx)
            pos = int(ix.all_p[idx]) + offset
            if not seen[pos]:
                seen[pos] = True
                visited += 1
        return idx == ix.end_bwt_idx and offset == 0 and visited == ix.length
