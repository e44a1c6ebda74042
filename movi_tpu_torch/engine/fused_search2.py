"""Paired backward-search layout: count and ZML at one 24 B record load per
base and direction (two composed steps per load).

Port of movi_tpu/engine/fused_search2.py.  Each per-direction step is a
micro-decode (off0 = B + u*off_in; ff = off0 >= C; run' = A + ff,
off' = off0 - ff*C), so two steps compose into one record per (run, a1,
a2) and direction; emptiness is the crossed-interval test.  The table is
composed on the device: by the hand-written kernel
csrc/compose_search2.cu on a CUDA tensor (one thread per record, written
straight into the table), by the plain chunked compose below on a CPU
tensor.  The scans run csrc/fused_search2.cu on CUDA and the plain
versions below on the CPU.  The `paired_search_records.npz` cache is the
JAX package's format 2, so both packages share one cache.

Record layout (six int32 words per (run, a1, a2) per direction; rows
[0, r*sigma^2) are the "down" (interval start) records, rows
[r*sigma^2, 2*r*sigma^2) the "up" (interval end) records):
  w0: A1 (0-24) | u1 (25) | u2_lo (26) | u2_hi (27)
  w1: A2_lo (0-24)            w2: A2_hi (0-24)
  w3: B1 (0-11) | C1 (12-23)  w4/w5: B2/C2 for the lo/hi branch
Pair codes are uint8 (a1+2)*8 + (a2+2), chars in {-2, -1, 0..sigma-1}.
Scan state is int32 [6, lanes] as in engine/fused_search.py.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..index.structure import MoveIndex
from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .fused import trim
from .fused_search import (BEYOND, count_init, count_results, init_interval,
                           init_records, interval_count, search_alphamap,
                           search_chars)
from .fused_kmer import count_kmers, count_result, kmer_windows

GUARD = 0xFFF            # C-field value meaning "no fast forward"
SENT_HI = 0x1FFFFFF      # +inf run sentinel (start side, no match)
MAX_RUNS = 1 << 25       # A fields are 25-bit (u bits sit at 25-27)
_AQ_BIAS = 2             # pair packing biases chars {-2,-1,0..} by +2
MAX_SIGMA = 8 - _AQ_BIAS  # a char takes 3 bits of a pair code

# runs per chunk of the plain compose: its [sigma, sigma, chunk] int64
# intermediates stay near 128 MB each for DNA
COMPOSE_CHUNK = 1 << 20


@dataclass
class FusedSearch2Index:
    r: int
    sigma: int
    rec_all: torch.Tensor       # int32 [2*r*sigma^2, 6]
    init_rec: torch.Tensor      # int32 [sigma+1, 4]
    # restart_rec[a1*sigma+a2] = one bs step from init(a1) with a2:
    # (rs, os, re, oe, empty) -- ZML's mid-pair restart
    restart_rec: torch.Tensor   # int32 [sigma^2, 5]
    all_p: torch.Tensor         # int32 [r+1]
    alphamap_query: np.ndarray

    def to(self, device) -> "FusedSearch2Index":
        return replace(self, rec_all=self.rec_all.to(device),
                       init_rec=self.init_rec.to(device),
                       restart_rec=self.restart_rec.to(device),
                       all_p=self.all_p.to(device))


def _compose_search2_chunk_plain(id_a, off_a, n_a, nu, nd, c0: int, r: int,
                                 sigma: int, ch: int):
    """Records of runs [c0, c0+ch) for both directions: a list of two
    int32 [ch*sigma^2, 6] slabs (down, up).  Axes: [a1, a2, run]."""
    dev = id_a.device
    id64, off64, n64 = (x.to(torch.int64) for x in (id_a, off_a, n_a))
    cum = torch.where(id64 < r - 1, n64[id64.clamp(0, r - 1)], GUARD)
    where = torch.where

    def fields(tab, up: bool, a, cur):
        """(A, B, C, u) of one micro-step for chars a at runs cur
        (broadcast together), sentinels folded in."""
        d = tab[a, cur.clamp(0, r - 1)].to(torch.int64)
        ex = (d < r) & (cur < r)
        dc = d.clamp(0, r - 1)
        keep = ex & (d == cur)
        A = where(ex, id64[dc], 0 if up else SENT_HI)
        reset = (n64[dc] - 1) if up else 0
        B = where(ex, off64[dc] + where(keep, 0, reset), 0)
        C = where(ex, cum[dc], GUARD)
        return A, B, C, keep.to(torch.int64)

    idxs = c0 + torch.arange(ch, dtype=torch.int64, device=dev)
    chars = torch.arange(sigma, dtype=torch.int64, device=dev)
    a1, a2 = chars.view(sigma, 1), chars.view(1, sigma, 1)
    slabs = []
    for up, tab in ((False, nd), (True, nu)):
        A1, B1, C1, u1 = fields(tab, up, a1, idxs.view(1, ch))   # [s, ch]
        A1 = A1.view(sigma, 1, ch)
        A2l, B2l, C2l, u2l = fields(tab, up, a2, A1)              # [s, s, ch]
        A2h, B2h, C2h, u2h = fields(tab, up, a2, A1 + 1)
        w0 = A1 | (u1 << 25).view(sigma, 1, ch) | (u2l << 26) | (u2h << 27)
        w3 = (B1 | (C1 << 12)).view(sigma, 1, ch).expand(sigma, sigma, ch)
        words = torch.stack([w0, A2l, A2h, w3, B2l | (C2l << 12),
                             B2h | (C2h << 12)], dim=-1)  # [s, s, ch, 6]
        slabs.append(words.permute(2, 0, 1, 3).reshape(ch * sigma * sigma, 6)
                     .to(torch.int32))
    return slabs


def compose_search2_plain(id_a, off_a, n_a, nu, nd, r: int, sigma: int,
                          chunk_runs: int = 0) -> torch.Tensor:
    """Plain PyTorch compose, chunk by chunk into one preallocated table;
    the last chunk re-composes a few overlapping runs rather than
    composing a ragged tail.  Returns int32 [2*r*sigma^2, 6]."""
    assert chunk_runs >= 0, f"chunk_runs must be >= 0, got {chunk_runs}"
    ch = min(r, chunk_runs or COMPOSE_CHUNK)
    S2 = sigma * sigma
    out = torch.zeros((2 * r * S2, 6), dtype=torch.int32, device=id_a.device)
    for c0 in list(range(0, r - ch, ch)) + [r - ch]:
        down, up = _compose_search2_chunk_plain(id_a, off_a, n_a, nu, nd,
                                                c0, r, sigma, ch)
        out[c0 * S2:(c0 + ch) * S2] = down
        out[(r + c0) * S2:(r + c0 + ch) * S2] = up
    return out


def compose_search2(id_a, off_a, n_a, nu, nd, r: int, sigma: int,
                    chunk_runs: int = 0) -> torch.Tensor:
    """The paired search table from int32 run arrays id/offset/n [r] and
    next-run tables nu/nd [sigma, r]: the CUDA kernel on CUDA tensors
    (which needs no chunks), the plain compose on CPU tensors."""
    if id_a.device.type == "cuda":
        return kernels.compose_search2_records(id_a, off_a, n_a, nu, nd, r,
                                               sigma)
    if id_a.device.type != "cpu":
        raise ValueError(f"no compose for device {id_a.device}")
    return compose_search2_plain(id_a, off_a, n_a, nu, nd, r, sigma,
                                 chunk_runs)


def _restart_table(ix: MoveIndex) -> np.ndarray:
    """One backward-search step from init(a1) with char a2, for every
    (a1, a2) -- the ZML mid-pair restart (host numpy; sigma^2 entries)."""
    r, sigma = ix.r, ix.sigma
    nu, nd = ix.next_tables_search()
    id_a = ix.id_arr.astype(np.int64)
    off_a = ix.offset_arr.astype(np.int64)
    n_a = ix.n_arr.astype(np.int64)

    def lf(d, o):
        run, off0 = int(id_a[d]), int(off_a[d]) + o
        if run < r - 1 and off0 >= n_a[run]:
            off0 -= int(n_a[run])
            run += 1
        return run, off0

    out = np.zeros((sigma * sigma, 5), dtype=np.int32)
    for a1 in range(sigma):
        rs = int(ix.first_runs[a1 + 1])
        os_ = int(ix.first_offsets[a1 + 1])
        re = int(ix.last_runs[a1 + 1])
        oe = int(ix.last_offsets[a1 + 1])
        for a2 in range(sigma):
            k = a1 * sigma + a2
            ds = int(nd[a2][rs])
            de = int(nu[a2][re]) if re < r else r
            if ds >= r or ds > re:
                out[k] = (0, 0, 0, 0, 1)
                continue
            os1 = os_ if ds == rs else 0
            oe1 = oe if de == re else int(n_a[de]) - 1
            nrs, nos = lf(ds, os1)
            nre, noe = lf(de, oe1)
            out[k] = (nrs, nos, nre, noe, 0)
    return out


def build_fused_search2_index(ix: MoveIndex, device: DeviceLike = None
                              ) -> FusedSearch2Index:
    """The paired search records, composed on `device` (CUDA unless the
    caller names the CPU)."""
    r, sigma = ix.r, ix.sigma
    assert r < MAX_RUNS, (
        f"paired search records hold 25-bit run ids; r={r} exceeds "
        f"{MAX_RUNS} (use the one-step fused search engine)")
    assert sigma <= MAX_SIGMA, "pair packing needs sigma <= 6"
    n64 = ix.n_arr.astype(np.int64)
    lf_abs = ix.all_p[ix.id_arr] + ix.offset_arr.astype(np.int64)
    e = lf_abs + n64 - 1
    id_end = np.searchsorted(ix.all_p[:-1], e, side="right") - 1
    assert int(np.max(id_end - ix.id_arr)) <= 1, (
        "paired search requires an index built with bound_ff=1")
    assert int(n64.max()) <= GUARD // 2, (
        "paired search records pack 12-bit B/C fields")

    dev = resolve_device(device)
    nu, nd = ix.next_tables_search()

    def up(x):
        return torch.from_numpy(np.asarray(x).astype(np.int32)).to(dev)

    rec_all = compose_search2(up(ix.id_arr), up(ix.offset_arr),
                              up(ix.n_arr), up(nu), up(nd), r, sigma)
    return FusedSearch2Index(
        r=r, sigma=sigma, rec_all=rec_all,
        init_rec=torch.from_numpy(init_records(ix)),
        restart_rec=torch.from_numpy(_restart_table(ix)),
        all_p=torch.from_numpy(ix.all_p.astype(np.int32)),
        alphamap_query=search_alphamap(ix)).to(dev)


_S2_FMT = 2  # on-disk cache format, shared with movi_tpu (25-bit A)


def save_fused_search2_index(s2: FusedSearch2Index, path: str):
    """Write paired_search_records.npz in the JAX package's format 2."""
    np.savez(path, rec_all=s2.rec_all.cpu().numpy(),
             init_rec=s2.init_rec.cpu().numpy(),
             restart_rec=s2.restart_rec.cpu().numpy(),
             all_p=s2.all_p.cpu().numpy(),
             alphamap_query=s2.alphamap_query,
             meta=np.array([s2.r, s2.sigma, _S2_FMT], dtype=np.int64))


def load_fused_search2_index(path: str) -> FusedSearch2Index:
    """Read paired_search_records.npz (format 2) into host tensors."""
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 3 or meta[2] != _S2_FMT:
        raise ValueError(f"{path}: stale paired search cache; rebuild "
                         f"with `build --paired-cache`")
    return FusedSearch2Index(
        r=meta[0], sigma=meta[1], rec_all=torch.from_numpy(z["rec_all"]),
        init_rec=torch.from_numpy(z["init_rec"]),
        restart_rec=torch.from_numpy(z["restart_rec"]),
        all_p=torch.from_numpy(z["all_p"]),
        alphamap_query=z["alphamap_query"])


def _micro(A, B, C, u, off_in):
    off0 = B + u * off_in
    ff = (off0 >= C).to(torch.int32)
    return A + ff, off0 - ff * C, ff


def _decode_dir(rec: torch.Tensor, off_in: torch.Tensor):
    """Two composed micro-steps of one direction from a gathered
    [lanes, 6] record.  Returns (mid_run, mid_off, fin_run, fin_off)."""
    w0 = rec[:, 0]
    A1 = w0 & 0x1FFFFFF
    u1 = (w0 >> 25) & 1
    w3 = rec[:, 3]
    m_run, m_off, ff1 = _micro(A1, w3 & GUARD, (w3 >> 12) & GUARD, u1,
                               off_in)
    hi = ff1 == 1
    A2 = torch.where(hi, rec[:, 2], rec[:, 1]) & 0x1FFFFFF
    wbc = torch.where(hi, rec[:, 5], rec[:, 4])
    u2 = torch.where(hi, (w0 >> 27) & 1, (w0 >> 26) & 1)
    f_run, f_off, _ = _micro(A2, wbc & GUARD, (wbc >> 12) & GUARD, u2,
                             m_off)
    return m_run, m_off, f_run, f_off


def _crossed(sr, so, er, eo):
    return (sr > er) | ((sr == er) & (so > eo))


def fused2_bs_step(rec_all: torch.Tensor, r: int, sigma: int, rs, os_, re,
                   oe, a12, l1, l2):
    """TWO backward_search_steps from one record per direction.  Returns
    (mid interval, final interval, empty1, empty2); empty2 is meaningful
    only where ~empty1 (the callers gate it)."""
    S2 = sigma * sigma
    a12c = a12.clamp(0, S2 - 1).to(torch.int64)
    rd = rec_all[rs.clamp(0, r - 1).to(torch.int64) * S2 + a12c]
    ru = rec_all[(r + re.clamp(0, r - 1).to(torch.int64)) * S2 + a12c]
    ms_run, ms_off, fs_run, fs_off = _decode_dir(rd, os_)
    me_run, me_off, fe_run, fe_off = _decode_dir(ru, oe)
    empty1 = ~l1 | _crossed(ms_run, ms_off, me_run, me_off)
    empty2 = ~l2 | _crossed(fs_run, fs_off, fe_run, fe_off)
    return ((ms_run, ms_off, me_run, me_off),
            (fs_run, fs_off, fe_run, fe_off), empty1, empty2)


def pack_search_pairs(alphas: np.ndarray, sigma: int):
    """[lanes, W] chars in {-2 (beyond read), -1 (illegal), 0..sigma-1}
    -> ([W2, lanes] packed (a1+2)*8+(a2+2) uint8, W).  Odd widths pad the
    tail with the beyond-read sentinel."""
    W = alphas.shape[1]
    if W % 2:
        alphas = np.concatenate(
            [alphas, np.full((alphas.shape[0], 1), BEYOND, alphas.dtype)],
            axis=1)
    v = ((alphas[:, 0::2].astype(np.int32) + _AQ_BIAS) * 8
         + (alphas[:, 1::2] + _AQ_BIAS)).T
    return np.ascontiguousarray(v).astype(np.uint8), W


def _unpack_pair(v: torch.Tensor, sigma: int):
    """(a1, a2, a12, l1, l2) from uint8 pair codes."""
    v = v.to(torch.int32)
    a1 = (v >> 3) - _AQ_BIAS
    a2 = (v & 7) - _AQ_BIAS
    return (a1, a2, a1.clamp(min=0) * sigma + a2.clamp(min=0),
            a1 >= 0, a2 >= 0)


def fused2_count_scan_plain(rec_all, init_rec, all_p, r: int, sigma: int,
                            pairs_t: torch.Tensor,
                            state: Optional[torch.Tensor] = None,
                            a0: Optional[torch.Tensor] = None):
    """Plain PyTorch paired count scan over pairs_t [W2, lanes].  With
    state None the scan starts from the first chars a0 [lanes] (int8);
    otherwise it continues from state.  Returns (state, count)."""
    if (state is None) == (a0 is None):
        raise ValueError("give either the first chars a0 or a state")
    if state is None:
        state = count_init(init_rec, a0.to(torch.int32))
    rs, os_, re, oe, matched, done = state.unbind(0)
    done = done == 1
    for t in range(pairs_t.shape[0]):
        _, _, a12, l1, l2 = _unpack_pair(pairs_t[t], sigma)
        alive = ~done
        mid, fin, e1, e2 = fused2_bs_step(rec_all, r, sigma, rs, os_, re, oe,
                                          a12, l1, l2)
        ok1 = alive & ~e1
        ok2 = ok1 & ~e2
        rs, os_, re, oe = (torch.where(ok2, f, torch.where(ok1, m, c))
                           for c, m, f in zip((rs, os_, re, oe), mid, fin))
        matched = matched + ok1.to(torch.int32) + ok2.to(torch.int32)
        done = done | (alive & (e1 | e2))
    state = torch.stack([rs, os_, re, oe, matched, done.to(torch.int32)])
    return state, interval_count(all_p, state)


def fused2_zml_scan_plain(rec_all, init_rec, restart_rec, r: int,
                          sigma: int, pairs_t: torch.Tensor,
                          state: Optional[torch.Tensor] = None):
    """Plain PyTorch paired ZML scan over pairs_t [W2, lanes]; state None
    starts from nothing matched.  Returns (state, ml [2*W2, lanes]): rows
    2t and 2t+1 are the match lengths after the pair's two chars."""
    W2, lanes = pairs_t.shape
    if state is None:
        state = torch.zeros((6, lanes), dtype=torch.int32,
                            device=pairs_t.device)
    ml_out = torch.empty((2 * W2, lanes), dtype=torch.int32,
                         device=pairs_t.device)
    rs, os_, re, oe, have, ml = state.unbind(0)
    have = have == 1
    for t in range(W2):
        _, a2, a12, l1, l2 = _unpack_pair(pairs_t[t], sigma)
        _, fin, e1, e2 = fused2_bs_step(rec_all, r, sigma, rs, os_, re, oe,
                                        a12, l1, l2)
        ok1 = have & ~e1
        ml1 = torch.where(ok1, ml + 1, 0)
        rst = restart_rec[a12.clamp(0, sigma * sigma - 1).to(torch.int64)]
        okA = ok1 & ~e2
        okB = ~ok1 & l1 & l2 & (rst[:, 4] == 0)
        ml = torch.where(okA | okB, ml1 + 1, 0)
        ini2 = init_interval(init_rec, a2)
        rs, os_, re, oe = (torch.where(okA, fin[i],
                                       torch.where(okB, rst[:, i], ini2[i]))
                           for i in range(4))
        have = okA | okB | l2
        ml_out[2 * t] = ml1
        ml_out[2 * t + 1] = ml
    state = torch.stack([rs, os_, re, oe, have.to(torch.int32), ml])
    return state, ml_out


def fused2_count_scan(rec_all, init_rec, all_p, r: int, sigma: int,
                      pairs_t: torch.Tensor,
                      state: Optional[torch.Tensor] = None,
                      a0: Optional[torch.Tensor] = None):
    """The paired count scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if rec_all.device.type == "cuda":
        return kernels.fused2_count_scan(rec_all, init_rec, all_p, r, sigma,
                                         pairs_t, state, a0)
    if rec_all.device.type != "cpu":
        raise ValueError(f"no scan for device {rec_all.device}")
    return fused2_count_scan_plain(rec_all, init_rec, all_p, r, sigma,
                                   pairs_t, state, a0)


def fused2_zml_scan(rec_all, init_rec, restart_rec, r: int, sigma: int,
                    pairs_t: torch.Tensor,
                    state: Optional[torch.Tensor] = None):
    """The paired ZML scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if rec_all.device.type == "cuda":
        return kernels.fused2_zml_scan(rec_all, init_rec, restart_rec, r,
                                       sigma, pairs_t, state)
    if rec_all.device.type != "cpu":
        raise ValueError(f"no scan for device {rec_all.device}")
    return fused2_zml_scan_plain(rec_all, init_rec, restart_rec, r, sigma,
                                 pairs_t, state)


def _pair_rows(ext: torch.Tensor):
    """[E, nk] extension char rows -> ([P, nk], [P, nk]) row pairs,
    padding an odd tail with the beyond-read sentinel."""
    if ext.shape[0] % 2:
        ext = torch.cat([ext, torch.full((1, ext.shape[1]), BEYOND,
                                         dtype=ext.dtype, device=ext.device)])
    return ext[0::2], ext[1::2]


def fused2_kmer_count_scan_plain(rec_all, init_rec, all_p, r: int,
                                 sigma: int, alphas: torch.Tensor, k: int):
    """Plain PyTorch exact counts on the paired records, one lane per
    k-mer: alphas int32 [k, nk] in k-mer order.  Init from the last char,
    then the k-1 extensions as ceil((k-1)/2) composed pair steps.
    Returns (found bool [nk], count int32 [nk])."""
    a = alphas.to(torch.int32)
    legal = (a >= 0).all(dim=0)
    rs, os_, re, oe = init_interval(init_rec, a[k - 1])
    dead = ~legal
    a1s, a2s = _pair_rows(a[:-1].flip(0))
    for a1, a2 in zip(a1s, a2s):
        l2 = a2 >= 0
        mid, fin, e1, e2 = fused2_bs_step(
            rec_all, r, sigma, rs, os_, re, oe,
            a1.clamp(min=0) * sigma + a2.clamp(min=0), a1 >= 0, l2)
        alive = ~dead
        ok1 = alive & ~e1
        ok2 = ok1 & ~e2
        dead = dead | (alive & (e1 | (l2 & ~e1 & e2)))
        rs, os_, re, oe = (torch.where(ok2, f, torch.where(ok1, m, c))
                           for c, m, f in zip((rs, os_, re, oe), mid, fin))
    return count_result(all_p, rs, os_, re, oe, ~dead & legal)


def fused2_kmer_count_scan(s2: FusedSearch2Index, slots: torch.Tensor,
                           lane: torch.Tensor, start: torch.Tensor, k: int):
    """Exact counts of the k-mers at (lane, start) of the read-order
    slots int8 [lanes, W] on the paired records: the CUDA kernel on a
    CUDA tensor, the plain version over the [k, nk] windows on a CPU
    tensor.  Returns (found, count)."""
    if slots.device.type == "cuda":
        return kernels.fused2_kmer_count_scan(
            s2.rec_all, s2.init_rec, s2.all_p, s2.r, s2.sigma, slots, lane,
            start, k)
    if slots.device.type != "cpu":
        raise ValueError(f"no scan for device {slots.device}")
    return fused2_kmer_count_scan_plain(
        s2.rec_all, s2.init_rec, s2.all_p, s2.r, s2.sigma,
        kmer_windows(slots, lane, start, k), k)


class _Search2Engine:
    def __init__(self, s2: FusedSearch2Index, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.s2 = s2.to(self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)


class Fused2CountEngine(_Search2Engine):
    """Count queries at one composed record per two bases and
    direction; a batch of any width is one scan."""

    def prepare(self, batch: ReadBatch):
        """First chars int8 [lanes] and the remaining chars' pair codes
        uint8 [W2, lanes], on the device."""
        alphas = search_chars(self.s2.alphamap_query, batch,
                              mark_beyond=True)
        pairs, _ = pack_search_pairs(alphas[:, 1:], self.s2.sigma)
        return self._to_device(alphas[:, 0].astype(np.int8)), \
            self._to_device(pairs)

    def query_batch_device(self, batch: ReadBatch):
        """(matched, count) int32 [lanes] on the device."""
        s2 = self.s2
        a0, pairs = self.prepare(batch)
        state, count = fused2_count_scan(s2.rec_all, s2.init_rec, s2.all_p,
                                         s2.r, s2.sigma, pairs, a0=a0)
        return state[4], count

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        return count_results(batch, *self.query_batch_device(batch))


class Fused2ZMLEngine(_Search2Engine):
    """ZML at one composed record per two bases and direction; a batch of
    any width is one scan."""

    def prepare(self, batch: ReadBatch) -> torch.Tensor:
        """Pair codes uint8 [W2, lanes] on the device."""
        alphas = search_chars(self.s2.alphamap_query, batch,
                              mark_beyond=True)
        return self._to_device(pack_search_pairs(alphas, self.s2.sigma)[0])

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        s2 = self.s2
        _, ml = fused2_zml_scan(s2.rec_all, s2.init_rec, s2.restart_rec,
                                s2.r, s2.sigma, self.prepare(batch))
        return ml[:batch.width]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)


class Fused2KmerCountEngine(_Search2Engine):
    """Exact k-mer counts on the paired search records (one composed
    record per two extensions and direction).  Results identical to
    FusedKmerCountEngine and AdvancedEngine.count_kmers_bidirectional."""

    def __init__(self, s2: FusedSearch2Index, k: int,
                 device: DeviceLike = None):
        super().__init__(s2, device)
        self.k = k

    def query_batch(self, batch: ReadBatch) -> List[Tuple[int, int]]:
        """Per read: (found_kmers, total_counts)."""
        return count_kmers(
            batch, self.s2.alphamap_query, self.k, self.device,
            lambda s, l, p: fused2_kmer_count_scan(self.s2, s, l, p, self.k))
