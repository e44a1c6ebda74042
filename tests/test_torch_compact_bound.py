"""The bytes behind the compact kernels' bound in chip_smoke.py
(compact_work over compact_tally) against a lane-by-lane emulation of
csrc/compact_pml.cu and csrc/compact_search.cu that counts every byte the
kernels need to load or store, every LF through the row -> run directory,
on the CPU.  The counts must be equal: a bound that counted rows the
kernels never load, or rows they load early and then drop, would flatter
them."""

import pytest

import chip_smoke as cs
from movi_tpu_torch.api import Index
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import length_reads, mixed_reads, random_text


def _lf(t, la, idx, off, cnt):
    """compact.cuh lf_dir from the loaded lf_abs row la: that row, the
    directory pair, all_p[dir[k]] and the halvings of the bucket's span.
    The row counts here, once a LF: a row the kernel issued early and then
    dropped for another (a mismatch's or a moved end's) is not needed."""
    x = la + off
    k = max(0, min(x >> t["dir_shift"], len(t["run_dir"]) - 2))
    base = int(t["run_dir"][k])
    ln = int(t["run_dir"][k + 1]) - base + 1
    start = int(t["all_p"][base])
    cnt[0] += 4 + 8 + 4
    while ln > 1:
        half = ln >> 1
        cnt[0] += 4
        if t["all_p"][base + half] <= x:
            base += half
            start = int(t["all_p"][base])
        ln -= half
    return base, x - start


def _tables(di):
    t = {k: getattr(di, k) for k in ("n", "lf_abs", "all_p", "c", "thr_full",
                                     "rep_up", "rep_down", "c_search",
                                     "ch_up_s", "ch_down_s", "first_runs",
                                     "first_offsets", "last_runs",
                                     "last_offsets", "run_dir")}
    t = {k: None if v is None else v.numpy().reshape(-1)
         for k, v in t.items()}
    t.update(r=di.r, sigma=di.sigma, dir_shift=di.dir_shift)
    return t


def emulate_pml(t, codes, state, rpml):
    r, cnt = t["r"], [0]
    W, lanes = codes.shape
    for lane in range(lanes):
        idx, off, m = (int(s[lane]) for s in state)
        cnt[0] += 12  # state in
        for step in range(W):
            a = int(codes[step, lane])
            cnt[0] += 1 + 4  # the char; ml
            la = int(t["lf_abs"][idx])  # issued with the row's char
            if a >= 0:
                cnt[0] += 1  # the row's char
                if int(t["c"][idx]) == a:
                    m += 1
                else:
                    rep = a * r + idx
                    cnt[0] += 4 + 4  # threshold or length; reposition row
                    if rpml:
                        up = 2 * off < t["n"][idx]
                        up = True if idx == r - 1 else up
                        up = False if idx == 0 else up
                    else:
                        up = off < t["thr_full"][idx * t["sigma"] + a]
                    dest = int(t["rep_up" if up else "rep_down"][rep])
                    if rpml and dest >= r:
                        up = not up
                        dest = int(t["rep_up" if up else "rep_down"][rep])
                        cnt[0] += 4
                    idx, off, m = dest, 0, 0
                    la = int(t["lf_abs"][dest])  # in the early row's place
                    if up:
                        off = int(t["n"][dest]) - 1
                        cnt[0] += 4
            else:
                m = 0
            idx, off = _lf(t, la, idx, off, cnt)
        cnt[0] += 12  # state out
    return cnt[0]


def emulate_search(t, codes, zml):
    r, sigma = t["r"], t["sigma"]
    last = sigma * r - 1
    cnt = [(sigma + 1) * 16]  # the first/last run tables

    def init(a):
        i = max(a, 0) + 1
        return [int(t[k][i]) for k in ("first_runs", "first_offsets",
                                       "last_runs", "last_offsets")]

    W, lanes = codes.shape
    for lane in range(lanes):
        a0 = int(codes[0, lane])
        cnt[0] += 1 + 4 * zml
        rs, os_, re, oe = init(a0)
        x = int(a0 >= 0)
        y = 0 if zml else 1 - x
        for step in range(1, W):
            if not zml and y:
                break
            a = int(codes[step, lane])
            cnt[0] += 1
            if not zml and a == -2:
                continue
            a_s, re_safe = max(a, 0), min(re, r - 1)
            cnt[0] += 8  # both ends' chars (their lf_abs rows issued too)
            las, lae = int(t["lf_abs"][rs]), int(t["lf_abs"][re_safe])
            rs1, os1, re1, oe1 = rs, os_, re_safe, oe
            if int(t["c_search"][rs]) != a_s:
                rs1, os1 = int(t["ch_down_s"][min(a_s * r + rs, last)]), 0
                las = int(t["lf_abs"][min(rs1, r - 1)])
                cnt[0] += 4
            if int(t["c_search"][re_safe]) != a_s:
                re1 = min(int(t["ch_up_s"][min(a_s * r + re_safe, last)]),
                          r - 1)
                oe1 = int(t["n"][re1]) - 1
                lae = int(t["lf_abs"][re1])
                cnt[0] += 8
            empty = a < 0 or rs1 >= r or rs1 > re
            rs1, os1 = _lf(t, las, min(rs1, r - 1), os1, cnt)
            re1, oe1 = _lf(t, lae, re1, oe1, cnt)
            if zml:
                ok = x and not empty
                if ok:
                    rs, os_, re, oe, y = rs1, os1, re1, oe1, y + 1
                else:
                    (rs, os_, re, oe), y = init(a), 0
                x = ok or a >= 0
                cnt[0] += 4  # ml
            elif empty:
                y = 1
            else:
                rs, os_, re, oe, x = rs1, os1, re1, oe1, x + 1
        cnt[0] += 24 + (0 if zml else 4 + 8)  # state out; count, all_p rows
    return cnt[0]


@pytest.fixture(scope="module")
def indexes():
    text = random_text(5000, 47)
    runs = build_bwt_runs(text)
    reads = mixed_reads(text) + length_reads(text, lengths=(1, 2, 3, 300))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return {mode: Index(build_move_index(runs, mode)) for mode in
            ("regular-thresholds", "regular")}, batch


@pytest.mark.parametrize("mode,kind", [
    ("regular-thresholds", "pml"), ("regular-thresholds", "rpml"),
    ("regular-thresholds", "count"), ("regular-thresholds", "zml"),
    ("regular", "rpml"), ("regular", "count"), ("regular", "zml")])
def test_compact_work_counts_the_loaded_bytes(indexes, mode, kind):
    from movi_tpu_torch.engine import pml as tpml
    from movi_tpu_torch.engine import search as tsearch

    index, batch = indexes[0][mode], indexes[1]
    eng = index.compact_engine("pml" if kind == "rpml" else kind,
                               kind == "rpml", "cpu")
    codes, st = cs.compact_codes(kind, eng, batch)
    if kind in ("pml", "rpml"):
        got = tpml.compact_pml_scan_plain(eng.di, codes, st, kind == "rpml")
    else:
        got = (tsearch.compact_count_scan_plain if kind == "count"
               else tsearch.compact_zml_scan_plain)(eng.di, codes)
    tally = cs.compact_tally(kind, eng.di, codes, st)
    nbytes, _ = cs.compact_work(kind, eng.di, codes, got, tally)
    t = _tables(eng.di)
    if kind in ("pml", "rpml"):
        want = emulate_pml(t, codes.numpy(), [s.numpy() for s in st],
                           kind == "rpml")
    else:
        want = emulate_search(t, codes.numpy(), kind == "zml")
    assert nbytes == want
    # the data-dependent rows and the halvings are there to count
    assert int(tally[0].sum()) > 0 and int(tally[2].sum()) > 0
