"""Paired PML layout: one 16 B record per (run, a1, a2), two bases a load.

Port of the PML half of movi_tpu/engine/fused2.py.  The paired table is
composed from the one-step records: on a CUDA tensor by the hand-written
kernel csrc/compose2.cu (one thread per record, written straight into the
table), on a CPU tensor by the plain chunked compose below.  The scan runs
csrc/fused2_pml.cu on CUDA and the plain decode on the CPU.

Packing (4 int32 words; run ids are 25-bit, so r < 2^25):
  w0: T1+4096 (bits 0-12) | match1 (13) | A_lo>>16 (14-22) | A_hi>>16 (23-31)
  w1: B_lo+4096 (0-12) | C_lo (13-24) | kind_lo (25-26) | flags_lo (27-29)
  w2: same fields for the hi branch
  w3: A_lo & 0xFFFF (0-15) | A_hi & 0xFFFF (16-31)
Bit 31 of w0 is set when A_hi >= 2^24: every decode masks after the
arithmetic shift, and the packer builds words in int64 and wraps them to
int32 explicitly.

Paired Movi Color widens each record to 8 words (32 B) with the color
ids of both steps' candidate destinations, 16 bits each:
  w4: step-1 {lo (0-15), hi (16-31)}, selected by the branch bit
  w5: the lo branch's step-2 {a, b}, selected by ff (LF2) or down (MIS2);
      CONST branches carry their one destination in both halves
  w6: the same for the hi branch
  w7: zero (pads the row to 32 B)
Built by csrc/compose2.cu's color entry on CUDA and the plain compose
with `cids` on the CPU; scanned by csrc/fused2_color.cu and
fused2_color_scan_plain.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Tuple

import numpy as np
import torch

from ..io.fastx import ReadBatch

from .. import kernels
from ..device import DeviceLike, resolve_device
from .fused import (BIT_BUMP, BIT_DOLLAR_DN, BIT_DOLLAR_UP, BIT_MATCH,
                    BIT_USE_LF, FA_MASK, FB_MASK, FB_SHIFT, FusedIndex,
                    initial_state, trim)
from .fused_color import (MAX_PACKED_COLORS, ColorTally, color_state,
                          es_update, scanned_rows)

KIND_LF2 = 0
KIND_MIS2 = 1
KIND_CONST = 2

_BIAS = 4096          # 13-bit biased signed fields (T1, B)
MAX_RUNS = 1 << 25    # A fields are 25-bit (16 low in w3 + 9 high in w0)

# runs per chunk of the plain compose: its [chunk, slots, slots] int64
# intermediates stay near 100 MB each for DNA
COMPOSE_CHUNK = 1 << 19


@dataclass
class Fused2Index:
    r: int
    sigma: int
    records: torch.Tensor       # int32 [r*(sigma+1)^2, 4] (8 for color)
    start_idx: int
    start_offset: int
    p_dollar: Tuple[int, int]
    alphamap_query: np.ndarray

    def to(self, device) -> "Fused2Index":
        return replace(self, records=self.records.to(device))


def _decode1(wa, wb):
    """One-step record words -> field dict (engine/fused.py packing)."""
    return dict(
        m=wa, fa=wb & FA_MASK, fb=(wb >> FB_SHIFT) & FB_MASK,
        bump=(wb >> BIT_BUMP) & 1, match=(wb >> BIT_MATCH) & 1,
        use_lf=(wb >> BIT_USE_LF) & 1, d_up=(wb >> BIT_DOLLAR_UP) & 1,
        d_dn=(wb >> BIT_DOLLAR_DN) & 1)


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 bit patterns -> int32 by two's complement (keeps the low 32
    bits, so bit 31 becomes the sign)."""
    x = x & 0xFFFFFFFF
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _pair16(lo, hi) -> torch.Tensor:
    """Two 16-bit ids in one word (int64; bit 31 set when hi >= 2^15)."""
    return lo.to(torch.int64) | (hi.to(torch.int64) << 16)


def pack_words(T1, match1, lo, hi, colors=None) -> torch.Tensor:
    """The four record words from the header (T1, match1) and the lo and
    hi branch descriptors (A, B, C, kind, flags), built in int64 and
    wrapped to int32; with colors ((lo, hi) id pairs of step 1, of the lo
    branch's step 2 and of the hi branch's step 2), the eight words of
    the color records.  Returns int32 [..., 4] or [..., 8]."""
    Al, Bl, Cl, kl, fl = (v.to(torch.int64) for v in lo)
    Ah, Bh, Ch, kh, fh = (v.to(torch.int64) for v in hi)
    T1 = T1.to(torch.int64)
    w0 = ((T1 + _BIAS) | (match1.to(torch.int64) << 13)
          | ((Al >> 16) << 14) | ((Ah >> 16) << 23))
    w1 = (Bl + _BIAS) | (Cl << 13) | (kl << 25) | (fl << 27)
    w2 = (Bh + _BIAS) | (Ch << 13) | (kh << 25) | (fh << 27)
    w3 = (Al & 0xFFFF) | ((Ah & 0xFFFF) << 16)
    words = [w0, w1, w2, w3]
    if colors is not None:
        words += [_pair16(*pair) for pair in colors]
        words.append(torch.zeros_like(w0))
    return _wrap_int32(torch.stack(words, dim=-1))


def _compose_chunk_plain(records1, c0: int, ch: int, r: int, slots: int,
                         p_dollar, cids=None):
    """Records for runs [c0, c0+ch) as int32 [ch*slots^2, 4] (8 with
    cids, int32 [r] clamped color ids), and the chunk's B min and max.
    Axes: [run, a1, a2]."""
    pd_run, pd_off = p_dollar
    dev = records1.device
    chunk = records1[c0 * slots:(c0 + ch) * slots].reshape(ch, slots, 1, 2)
    f1 = _decode1(chunk[..., 0], chunk[..., 1])      # [ch, slots(a1), 1]
    a2 = torch.arange(slots, device=dev, dtype=torch.int64).view(1, 1, -1)
    where = torch.where

    use_lf1 = f1["use_lf"] == 1
    du1 = f1["d_up"] == 1
    dd1 = f1["d_dn"] == 1
    m1, fa1, fb1, bump1 = f1["m"], f1["fa"], f1["fb"], f1["bump"]
    T1 = where(use_lf1, fb1 - fa1, fb1).clamp(-_BIAS, _BIAS - 1)
    # branch states: lo = (x < T1), hi = (x >= T1)
    i_up = where(du1, pd_run, m1)
    y_up = where(du1, pd_off, fa1)
    i_dn = where(dd1, pd_run, m1 + bump1)
    y_dn = where(dd1, pd_off, where(bump1 == 1, 0, fa1 + 1))
    i_lo = where(use_lf1, m1, i_up)
    c_lo = where(use_lf1, fa1, 0)
    y_lo = where(use_lf1, 0, y_up)
    i_hi = where(use_lf1, m1 + 1, i_dn)
    c_hi = where(use_lf1, fa1 - fb1, 0)
    y_hi = where(use_lf1, 0, y_dn)

    def cid(ix_):
        return cids[ix_.clamp(0, r - 1).to(torch.int64)]

    def descriptor(i_b, c_b, y_b):
        """(A, B, C, kind, flags) per [run, a1, a2] for one branch, and
        with cids its step-2 destination color-id pair (a, b)."""
        # unreachable branches may carry out-of-range ids: clip to gather
        i = i_b.clamp(0, r - 1).to(torch.int64)
        rows = records1[i * slots + a2]               # [ch, slots, slots, 2]
        g = _decode1(rows[..., 0], rows[..., 1])
        fl_mis = g["bump"] | (g["d_up"] << 1) | (g["d_dn"] << 2)
        # constant branch: evaluate step 2 on the concrete (i_b, y_b)
        off0 = g["fa"] + y_b
        ff = (off0 >= g["fb"]).to(torch.int32)
        j_lf = g["m"] + ff
        d_lf = off0 - ff * g["fb"]
        dn = y_b >= g["fb"]
        j_up = where(g["d_up"] == 1, pd_run, g["m"])
        d_up = where(g["d_up"] == 1, pd_off, g["fa"])
        j_dn = where(g["d_dn"] == 1, pd_run, g["m"] + g["bump"])
        d_dn = where(g["d_dn"] == 1, pd_off,
                     where(g["bump"] == 1, 0, g["fa"] + 1))
        g_lf = g["use_lf"] == 1
        j_c = where(g_lf, j_lf, where(dn, j_dn, j_up))
        d_c = where(g_lf, d_lf, where(dn, d_dn, d_up))
        fl_c = where(g_lf, g["match"], 0)

        lf2 = use_lf1 & g_lf
        mis2 = use_lf1 & ~g_lf
        A = where(use_lf1, g["m"], j_c).clamp(0, r - 1)
        B = where(lf2, c_b + g["fa"],
                  where(mis2, (g["fb"] - c_b).clamp(-_BIAS, _BIAS - 1), 0))
        C = where(lf2, g["fb"], where(mis2, g["fa"], d_c))
        kind = where(lf2, KIND_LF2, where(mis2, KIND_MIS2, KIND_CONST))
        flags = where(lf2, g["match"], where(mis2, fl_mis, fl_c))
        if cids is None:
            return (A, B, C, kind, flags), None
        # selected at query time by ff (LF2), down (MIS2) or nothing
        up2 = where(g["d_up"] == 1, pd_run, g["m"])
        dn2 = where(g["d_dn"] == 1, pd_run, g["m"] + g["bump"])
        c2a = where(lf2, cid(A), where(mis2, cid(up2), cid(j_c)))
        c2b = where(lf2, cid(A + 1), where(mis2, cid(dn2), cid(j_c)))
        return (A, B, C, kind, flags), (c2a, c2b)

    lo, c2_lo = descriptor(i_lo, c_lo, y_lo)
    hi, c2_hi = descriptor(i_hi, c_hi, y_hi)
    shape = lo[0].shape
    colors = None
    if cids is not None:
        colors = ((cid(i_lo).expand(shape), cid(i_hi).expand(shape)),
                  c2_lo, c2_hi)
    words = pack_words(T1.expand(shape), f1["match"].expand(shape), lo, hi,
                       colors)
    b_min = int(torch.minimum(lo[1].min(), hi[1].min()))
    b_max = int(torch.maximum(lo[1].max(), hi[1].max()))
    return words.reshape(-1, words.shape[-1]), b_min, b_max


def compose_records_plain(records1: torch.Tensor, r: int, slots: int,
                          p_dollar, cids=None, chunk_runs: int = 0):
    """Plain PyTorch compose, chunk by chunk into one preallocated table
    (4 words per record, 8 with cids).  The last chunk re-composes a few
    overlapping runs rather than composing a ragged tail.  Returns
    (table, (b_min, b_max))."""
    assert chunk_runs >= 0, f"chunk_runs must be >= 0, got {chunk_runs}"
    ch = min(r, chunk_runs or COMPOSE_CHUNK)
    s2 = slots * slots
    nw = 4 if cids is None else 8
    out = torch.zeros((r * s2, nw), dtype=torch.int32,
                      device=records1.device)
    bmin, bmax = [], []
    for c0 in list(range(0, r - ch, ch)) + [r - ch]:
        words, bn, bx = _compose_chunk_plain(records1, c0, ch, r, slots,
                                             p_dollar, cids)
        out[c0 * s2:(c0 + ch) * s2] = words
        bmin.append(bn)
        bmax.append(bx)
    return out, (min(bmin), max(bmax))


def compose_records(records1: torch.Tensor, r: int, slots: int, p_dollar,
                    cids=None, chunk_runs: int = 0):
    """The paired table from the one-step records (the 8-word color
    table with cids): the CUDA kernels on a CUDA tensor (which need no
    chunks), the plain compose on a CPU tensor.  Returns (table, (b_min,
    b_max))."""
    if records1.device.type == "cuda":
        if cids is None:
            return kernels.compose_paired_records(records1, r, slots,
                                                  p_dollar)
        return kernels.compose_paired_color_records(records1, cids, r,
                                                    slots, p_dollar)
    if records1.device.type != "cpu":
        raise ValueError(f"no compose for device {records1.device}")
    return compose_records_plain(records1, r, slots, p_dollar, cids,
                                 chunk_runs)


def build_fused2_index(fi: FusedIndex) -> Fused2Index:
    """Compose the one-step records into paired two-step records, on the
    device the one-step records are on."""
    r, sigma = fi.r, fi.sigma
    assert r < MAX_RUNS, (
        f"paired records hold 25-bit run ids; r={r} exceeds {MAX_RUNS} "
        f"(use the one-step fused engine)")
    slots = sigma + 1
    records, (bmin, bmax) = compose_records(fi.records, r=r, slots=slots,
                                            p_dollar=fi.p_dollar)
    assert bmin >= -_BIAS and bmax < _BIAS, (
        "composed B field out of its 13-bit range -- corrupt index?")
    return Fused2Index(
        r=r, sigma=sigma, records=records,
        start_idx=fi.start_idx, start_offset=fi.start_offset,
        p_dollar=fi.p_dollar, alphamap_query=fi.alphamap_query)


def _fused2_decode(rec: torch.Tensor, offset: torch.Tensor, p_dollar):
    """Paired-record decode on a gathered [lanes, >=4] record.  Returns
    (new_idx, new_off, match1, match2, hi, ff, down, kind): the last four
    are the selectors the color records read."""
    where = torch.where
    w0 = rec[:, 0]
    w3 = rec[:, 3]
    T1 = (w0 & 0x1FFF) - _BIAS
    match1 = (w0 >> 13) & 1
    hi = offset >= T1
    wb = where(hi, rec[:, 2], rec[:, 1])
    # arithmetic shifts: mask after every shift (bit 31 may be set)
    A = where(hi,
              ((w3 >> 16) & 0xFFFF) | (((w0 >> 23) & 0x1FF) << 16),
              (w3 & 0xFFFF) | (((w0 >> 14) & 0x1FF) << 16))
    B = (wb & 0x1FFF) - _BIAS
    C = (wb >> 13) & 0xFFF
    kind = (wb >> 25) & 3
    flags = (wb >> 27) & 7

    # LF2: bounded-ff decode with precomposed fields
    off0 = B + offset
    ff = (off0 >= C).to(torch.int32)
    lf_idx = A + ff
    lf_off = off0 - ff * C

    # MIS2: the one-step mismatch anchor decode
    pd_run, pd_off = p_dollar
    bump = flags & 1
    d_up = (flags >> 1) & 1
    d_dn = (flags >> 2) & 1
    down = offset >= B
    up_run = where(d_up == 1, pd_run, A)
    up_off = where(d_up == 1, pd_off, C)
    dn_run = where(d_dn == 1, pd_run, A + bump)
    dn_off = where(d_dn == 1, pd_off, where(bump == 1, 0, C + 1))
    mis_idx = where(down, dn_run, up_run)
    mis_off = where(down, dn_off, up_off)

    new_idx = where(kind == KIND_LF2, lf_idx,
                    where(kind == KIND_MIS2, mis_idx, A))
    new_off = where(kind == KIND_LF2, lf_off,
                    where(kind == KIND_MIS2, mis_off, C))
    match2 = where(kind == KIND_MIS2, 0, flags & 1)
    return new_idx, new_off, match1, match2, hi, ff, down, kind


_FUSED2_FMT = 2  # on-disk cache format, shared with movi_tpu


def save_fused2_index(f2: Fused2Index, path: str):
    """Write paired_records.npz in the JAX package's format 2."""
    np.savez(path, records=f2.records.cpu().numpy(),
             meta=np.array([f2.r, f2.sigma, f2.start_idx, f2.start_offset,
                            f2.p_dollar[0], f2.p_dollar[1], _FUSED2_FMT],
                           dtype=np.int64),
             alphamap_query=f2.alphamap_query)


def load_fused2_index(path: str) -> Fused2Index:
    """Read paired_records.npz (format 2) into host tensors."""
    z = np.load(path)
    meta = [int(x) for x in z["meta"]]
    if len(meta) < 7 or meta[6] != _FUSED2_FMT:
        raise ValueError(f"{path}: stale paired-record cache; rebuild "
                         f"with `build --paired-cache`")
    r, sigma, start_idx, start_offset, pd_run, pd_off = meta[:6]
    return Fused2Index(r=r, sigma=sigma,
                       records=torch.from_numpy(z["records"]),
                       start_idx=start_idx, start_offset=start_offset,
                       p_dollar=(pd_run, pd_off),
                       alphamap_query=z["alphamap_query"])


def fused2_step(records: torch.Tensor, slots: int, p_dollar, state, a12):
    """Two PML base steps from one indexed 16 B record load.
    a12 = a1 * slots + a2.  Returns (state, (ml1, ml2))."""
    idx, offset, ml = state
    rec = records[idx.to(torch.int64) * (slots * slots) + a12]
    new_idx, new_off, match1, match2, *_ = _fused2_decode(rec, offset,
                                                          p_dollar)
    ml1 = torch.where(match1 == 1, ml + 1, 0)
    ml2 = torch.where(match2 == 1, ml1 + 1, 0)
    return (new_idx, new_off, ml2), (ml1, ml2)


def fused2_pml_scan_plain(records: torch.Tensor, slots: int, p_dollar,
                          a12_t: torch.Tensor, state):
    """Plain PyTorch paired scan over a12_t [W2, lanes].  Returns
    (state, ml [2*W2, lanes]): rows 2t and 2t+1 are the pair's bases."""
    W2, lanes = a12_t.shape
    ml = torch.empty((2 * W2, lanes), dtype=torch.int32,
                     device=a12_t.device)
    a12 = a12_t.to(torch.int64)
    for t in range(W2):
        state, (ml[2 * t], ml[2 * t + 1]) = fused2_step(
            records, slots, p_dollar, state, a12[t])
    return state, ml


def fused2_pml_scan(records: torch.Tensor, slots: int, p_dollar,
                    a12_t: torch.Tensor, state):
    """The paired scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if records.device.type == "cuda":
        return kernels.fused2_pml_scan(records, slots, p_dollar, a12_t,
                                       state)
    if records.device.type != "cpu":
        raise ValueError(f"no scan for device {records.device}")
    return fused2_pml_scan_plain(records, slots, p_dollar, a12_t, state)


def pack_pairs(alphas: np.ndarray, sigma: int):
    """[lanes, W] slots in scan order -> ([W2, lanes] pair codes
    a1*(sigma+1)+a2, W).  Odd widths pad the scan tail (past every read's
    end) with the illegal slot.  uint8 when the pair range fits, else
    int32."""
    slots = sigma + 1
    W = alphas.shape[1]
    if W % 2:
        alphas = np.concatenate(
            [alphas, np.full((alphas.shape[0], 1), sigma, alphas.dtype)],
            axis=1)
    a12 = (alphas[:, 0::2].astype(np.int32) * slots
           + alphas[:, 1::2]).T
    dtype = np.uint8 if slots * slots - 1 <= 0xFF else np.int32
    return np.ascontiguousarray(a12).astype(dtype), W


class Fused2PMLEngine:
    """Batched PML at one record load per two bases; a batch of any width
    is one scan."""

    def __init__(self, fi: Fused2Index, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.fi = fi.to(self.device)

    def prepare(self, batch: ReadBatch):
        """Pair codes in scan order as [W2, lanes] on the device, and W."""
        fi = self.fi
        a12, W = pack_pairs(fi.alphamap_query[batch.seqs[:, ::-1]],
                            fi.sigma)
        return torch.from_numpy(a12).to(self.device), W

    def query_batch_device(self, batch: ReadBatch) -> torch.Tensor:
        fi = self.fi
        slots = fi.sigma + 1
        a12_t, W = self.prepare(batch)
        state = initial_state(fi, a12_t.shape[1], self.device)
        _, ml = fused2_pml_scan(fi.records, slots, fi.p_dollar, a12_t, state)
        return ml[:W]

    def query_batch(self, batch: ReadBatch) -> List[List[int]]:
        return trim(self.query_batch_device(batch), batch)


# Paired Movi Color: PML and both bases' color ids per 32 B record


@dataclass
class Fused2ColorIndex:
    f2: Fused2Index             # records: the 8-word color records
    num_colors: int

    def to(self, device) -> "Fused2ColorIndex":
        return replace(self, f2=self.f2.to(device))


def build_fused2_color_index(fi: FusedIndex, ct) -> Fused2ColorIndex:
    """Compose the 8-word paired color records on the device fi's
    records are on.  Needs the kept-set count C to fit 16 bits."""
    r, sigma = fi.r, fi.sigma
    assert r < MAX_RUNS, (
        f"paired records hold 25-bit run ids; r={r} exceeds {MAX_RUNS}")
    C = len(ct.unique_doc_sets)
    assert C + 1 <= MAX_PACKED_COLORS, (
        "paired color records need at most 2^16-2 kept doc sets")
    cids = torch.from_numpy(np.minimum(np.asarray(ct.doc_set_inds), C)
                            .astype(np.int32)).to(fi.records.device)
    records, (bmin, bmax) = compose_records(fi.records, r, sigma + 1,
                                            fi.p_dollar, cids)
    assert bmin >= -_BIAS and bmax < _BIAS, (
        "composed B field out of its 13-bit range -- corrupt index?")
    f2 = Fused2Index(r=r, sigma=sigma, records=records,
                     start_idx=fi.start_idx, start_offset=fi.start_offset,
                     p_dollar=fi.p_dollar, alphamap_query=fi.alphamap_query)
    return Fused2ColorIndex(f2=f2, num_colors=C)


def fused2_color_step(records: torch.Tensor, slots: int, p_dollar, state,
                      a12):
    """Two PML base steps and both destinations' color ids from one 32 B
    record: the shared decode, then word 4's half by the branch bit and
    word 5 or 6's half by ff (LF2) or down (MIS2).  Returns (state, (ml1,
    ml2, cid1, cid2))."""
    idx, offset, ml = state
    rec = records[idx.to(torch.int64) * (slots * slots) + a12]
    (new_idx, new_off, match1, match2,
     hi, ff, down, kind) = _fused2_decode(rec, offset, p_dollar)
    ml1 = torch.where(match1 == 1, ml + 1, 0)
    ml2 = torch.where(match2 == 1, ml1 + 1, 0)
    w4 = rec[:, 4]
    cid1 = torch.where(hi, (w4 >> 16) & 0xFFFF, w4 & 0xFFFF)
    wc2 = torch.where(hi, rec[:, 6], rec[:, 5])
    sel2 = torch.where(kind == KIND_LF2, ff,
                       torch.where(kind == KIND_MIS2, down.to(torch.int32),
                                   0))
    cid2 = torch.where(sel2 == 1, (wc2 >> 16) & 0xFFFF, wc2 & 0xFFFF)
    return (new_idx, new_off, ml2), (ml1, ml2, cid1, cid2)


def fused2_color_scan_plain(records: torch.Tensor, slots: int, p_dollar,
                            a12_t: torch.Tensor, state, lens=None,
                            t0: int = 0):
    """Plain PyTorch paired color scan over a12_t [W2, lanes].  state:
    (idx, off, ml), plus (csum, stop) with lens (early stop, two checks
    per pair step; t0, the global step of row 0, is even).  Returns
    (state, ml, cid), both [2*W2, lanes]: rows 2t and 2t+1 are the
    pair's bases."""
    W2, lanes = a12_t.shape
    dev = a12_t.device
    es = lens is not None
    fill = torch.zeros if es else torch.empty
    ml = fill((2 * W2, lanes), dtype=torch.int32, device=dev)
    cid = fill((2 * W2, lanes), dtype=torch.int32, device=dev)
    a12 = a12_t.to(torch.int64)
    core = tuple(state[:3])
    if es:
        csum, stop = state[3], state[4]
    for t in range(W2):
        new_core, outs = fused2_color_step(records, slots, p_dollar, core,
                                           a12[t])
        ml1, ml2, c1, c2 = outs
        if not es:
            core = new_core
            ml[2 * t], ml[2 * t + 1], cid[2 * t], cid[2 * t + 1] = outs
            continue
        tg = t0 + 2 * t
        live = (stop == 0) & (tg < lens)
        core = tuple(torch.where(live, n, o) for n, o in zip(new_core, core))
        ml[2 * t] = torch.where(live, ml1, 0)
        ml[2 * t + 1] = torch.where(live, ml2, 0)
        cid[2 * t] = torch.where(live, c1, 0)
        cid[2 * t + 1] = torch.where(live, c2, 0)
        csum, hit1 = es_update(csum, live, ml1, tg, lens)
        csum, hit2 = es_update(csum, live, ml2, tg + 1, lens)
        stop = torch.where(hit1 | hit2, tg + 2, stop).to(torch.int32)
    state = core + ((csum, stop) if es else ())
    return state, ml, cid


def fused2_color_scan(records: torch.Tensor, slots: int, p_dollar,
                      a12_t: torch.Tensor, state, lens=None, t0: int = 0):
    """The paired color scan: the CUDA kernel on a CUDA tensor, the plain
    version on a CPU tensor."""
    if records.device.type == "cuda":
        return kernels.fused2_color_scan(records, slots, p_dollar, a12_t,
                                         state, lens, t0)
    if records.device.type != "cpu":
        raise ValueError(f"no scan for device {records.device}")
    return fused2_color_scan_plain(records, slots, p_dollar, a12_t, state,
                                   lens, t0)


class Fused2ColorEngine:
    """Multi-class classification at one 32 B record load per two bases,
    with the one-step engine's host tally; a batch of any width is one
    scan."""

    def __init__(self, ci: Fused2ColorIndex, ct, device: DeviceLike = None,
                 **color_kw):
        self.device = resolve_device(device)
        self.ci = ci.to(self.device)
        self.host = ColorTally(ct, **color_kw)
        self.last_scanned_rows = 0

    def prepare(self, batch: ReadBatch):
        """Pair codes in scan order as [W2, lanes] on the device, and W."""
        f2 = self.ci.f2
        a12, W = pack_pairs(f2.alphamap_query[batch.seqs[:, ::-1]],
                            f2.sigma)
        return torch.from_numpy(a12).to(self.device), W

    def scan_args(self, batch: ReadBatch):
        """(records, slots, p_dollar, a12_t, state, lens) of the batch's
        scan from the start of every read, and W."""
        f2 = self.ci.f2
        a12_t, W = self.prepare(batch)
        es = self.host.early_stop
        lens = (torch.from_numpy(batch.lengths.astype(np.int32))
                .to(self.device) if es else None)
        state = color_state(f2, a12_t.shape[1], self.device, es)
        return (f2.records, f2.sigma + 1, f2.p_dollar, a12_t, state,
                lens), W

    def query_batch_device(self, batch: ReadBatch):
        """(ml, color) int32 [W, lanes] on the device."""
        args, W = self.scan_args(batch)
        state, ml, color = fused2_color_scan(*args)
        self.last_scanned_rows = (scanned_rows(state, args[-1], W)
                                  if self.host.early_stop else W)
        return ml[:W], color[:W]

    def query_batch(self, batch: ReadBatch):
        """Per lane: (pmls, csv_cell, per-base color ids)."""
        return self.host.results(*self.query_batch_device(batch), batch)
