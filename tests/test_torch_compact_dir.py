"""The row -> run directory of the compact engines
(movi_tpu_torch/engine/device_index.py, csrc/compact.cuh find_run_dir and
lf_dir, kernels 12a-12c) on the CPU: the tables' directory equals
run_dir_plain and its search equals searchsorted on every row; the
directory-form LF (pml.lf_step) and backward-search step (search._bs_step)
equal the JAX package's searchsorted forms on every (run, offset) of small
indexes built with and without NT splitting, at the rule's shift and at
forced shifts b = 0 and b = 4; compact PML (both rules), count and ZML
through the directory equal movi_tpu's compact engines and ScalarEngine,
a reposition that finds no run raises as the oracle does, and a scan split
in pieces equals one pass; and a lane-by-lane transliteration of kernels
12a-12c gives the plain scans' states, outputs, halvings and chains of
dependent loads.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import device_index as jdi
from movi_tpu.engine import pml as jpml
from movi_tpu.engine import search as jsearch
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
from movi_tpu_torch.engine import device_index as tdi
from movi_tpu_torch.engine import pml as tpml
from movi_tpu_torch.engine import search as tsearch
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import length_reads, mixed_reads, random_text

# (mode, bound_ff): NT-split (bounded) and unsplit (unbounded) indexes
INDEXES = {"thr-bounded": ("regular-thresholds", 1),
           "thr-unbounded": ("regular-thresholds", None),
           "regular": ("regular", None)}
SHIFTS = [None, 0, 4]  # None: the rule's (run_dir_shift)


@pytest.fixture(scope="module")
def text():
    return random_text(1500, 61)


@pytest.fixture(scope="module", params=list(INDEXES))
def case(request, text):
    mode, bff = INDEXES[request.param]
    ix = build_move_index(build_bwt_runs(text), mode, bound_ff=bff)
    return dict(name=request.param, ix=ix, jdi=jdi.build_device_index(ix),
                tdi=tdi.build_device_index(ix), sc=ScalarEngine(ix))


def _at(di, b):
    return di if b is None else di.with_run_dir(b)


def _find_run(all_p, x):
    """csrc/compact.cuh find_run: the last run i with all_p[i] <= x, 0
    below row 0."""
    return np.maximum(np.searchsorted(all_p, x, side="right") - 1, 0)


@pytest.mark.parametrize("b", SHIFTS)
def test_directory_resolves_every_row(case, b):
    """The tables' directory is run_dir_plain of all_p (the rule's shift
    by default, no larger than all_p), and its search gives searchsorted's
    run and start on every row of [-3, n+3] and the int32 extremes, in at
    most b + 1 halvings."""
    di = _at(case["tdi"], b)
    all_p = di.all_p.numpy()
    n, r = di.length, di.r
    assert int(all_p[r]) == n
    if b is None:
        assert di.dir_shift == tdi.run_dir_shift(n, r)
        assert di.run_dir.numel() <= r + 1
    assert torch.equal(di.run_dir, tdi.run_dir_plain(di.all_p, n,
                                                     di.dir_shift))
    x = np.concatenate([np.arange(-3, n + 4), [-2**31, 2**31 - 1]])
    run, start, halvings = tdi.resolve_dir(
        di.all_p, di.run_dir, di.dir_shift,
        torch.from_numpy(x.astype(np.int32)))
    want = _find_run(all_p, x)
    assert np.array_equal(run.numpy(), want)
    assert np.array_equal(start.numpy(), all_p[want])
    assert int(halvings.max()) <= di.dir_shift + 1


def _every_row(ix):
    """Every (run, offset) of the index, int32 [n] each."""
    n_arr = ix.n_arr.astype(np.int64)
    runs = np.repeat(np.arange(ix.r), n_arr)
    offs = np.arange(len(runs)) - np.repeat(ix.all_p[:-1], n_arr)
    return runs.astype(np.int32), offs.astype(np.int32)


@pytest.mark.parametrize("b", SHIFTS)
def test_lf_step_equals_searchsorted(case, b):
    """pml.lf_step through the directory equals the JAX lf_step
    (searchsorted over all_p) on every (run, offset)."""
    di = _at(case["tdi"], b)
    runs, offs = _every_row(case["ix"])
    got_idx, got_off, halvings = tpml.lf_step(di, torch.from_numpy(runs),
                                              torch.from_numpy(offs))
    want_idx, want_off = jpml.lf_step(case["jdi"], jnp.asarray(runs),
                                      jnp.asarray(offs))
    assert got_idx.dtype == torch.int32
    assert np.array_equal(got_idx.numpy(), np.asarray(want_idx))
    assert np.array_equal(got_off.numpy(), np.asarray(want_off))
    assert int(halvings.min()) >= 0
    assert int(halvings.max()) <= di.dir_shift + 1


def _intervals(ix, seed=3, count=3000):
    """Single-row intervals on every row, then random ones (start <= end)
    as (rs, os, re, oe) int32 arrays."""
    runs, offs = _every_row(ix)
    rng = np.random.default_rng(seed)
    i = rng.integers(0, len(runs), size=(2, count))
    lo, hi = i.min(0), i.max(0)
    rs = np.concatenate([runs, runs[lo]])
    os_ = np.concatenate([offs, offs[lo]])
    re = np.concatenate([runs, runs[hi]])
    oe = np.concatenate([offs, offs[hi]])
    return rs, os_, re, oe


@pytest.mark.parametrize("b", SHIFTS)
def test_bs_step_equals_searchsorted(case, b):
    """search._bs_step through the directory equals the JAX _bs_step on
    every single-row interval and 3,000 random ones, for every char and
    an illegal one, where the result is not empty (an empty one's interval
    is unspecified in both)."""
    di = _at(case["tdi"], b)
    iv = _intervals(case["ix"])
    t_iv = [torch.from_numpy(v) for v in iv]
    j_iv = [jnp.asarray(v) for v in iv]
    for a in range(-1, di.sigma):
        ta = torch.full_like(t_iv[0], a)
        got = tsearch._bs_step(di, *t_iv, ta)
        want = jsearch._bs_step(case["jdi"], *j_iv, jnp.asarray(ta.numpy()))
        empty = np.asarray(want[4])
        assert np.array_equal(got[4].numpy(), empty), a
        for g, w in zip(got[:4], want[:4]):
            assert np.array_equal(g.numpy()[~empty], np.asarray(w)[~empty])
        moves, halvings, chain = got[5][:2], got[5][2], got[5][3]
        assert moves.dtype == torch.int64
        assert int(halvings.max()) <= 2 * (di.dir_shift + 1)
        assert bool((chain >= 1).all())


def _rules(ix):
    return [False, True] if ix.thr is not None else [True]


@pytest.fixture(scope="module")
def answers(case, text):
    """Reads with N's and of lengths 1-700 as one batch, and movi_tpu's
    compact engines' answers, which equal ScalarEngine's: {kind: answers}
    with kind False/True (PML by threshold, --rpml), "count", "zml"."""
    reads = mixed_reads(text, seed=12, count=30) + length_reads(
        text, lengths=(1, 2, 3, 200, 700))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    sc, jd = case["sc"], case["jdi"]
    want = {rr: jpml.PMLEngine(jd, rr).query_batch(batch)
            for rr in _rules(case["ix"])}
    want["count"] = jsearch.CountEngine(jd).query_batch(batch)
    want["zml"] = jsearch.ZMLEngine(jd).query_batch(batch)
    for i, (name, seq) in enumerate(reads):
        for rr in _rules(case["ix"]):
            assert want[rr][i] == sc.query_pml(
                seq, random_repositioning=rr), name
        assert want["count"][i] == sc.query_count(seq), name
        assert want["zml"][i] == sc.query_zml(seq), name
    return batch, want


@pytest.mark.parametrize("b", SHIFTS)
def test_engines_equal_jax_and_oracle(case, answers, b):
    """Compact PML (both rules), count and ZML through the directory equal
    movi_tpu's compact engines and ScalarEngine (the fixture holds the two
    to each other) on reads with N's and of lengths 1-700."""
    di = _at(case["tdi"], b)
    batch, want = answers
    for rr in _rules(case["ix"]):
        assert tpml.PMLEngine(di, rr, "cpu").query_batch(batch) == want[rr]
    assert tsearch.CountEngine(di, "cpu").query_batch(batch) == want["count"]
    assert tsearch.ZMLEngine(di, "cpu").query_batch(batch) == want["zml"]


@pytest.mark.parametrize("b", SHIFTS)
def test_reposition_without_a_run_raises(text, b):
    """With no run of any char above or below (the reposition tables
    emptied), the scan through the directory raises ScalarEngine's message
    on the first mismatch, as the oracle does, under both rules."""
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds")
    di = _at(tdi.build_device_index(ix), b)
    none = torch.full_like(di.rep_up, di.r)
    broken = tdi.DeviceIndex(**{**di.__dict__, "rep_up": none,
                                "rep_down": none})
    sc = ScalarEngine(ix)
    sc.nu = np.full_like(sc.nu, ix.r)
    sc.nd = np.full_like(sc.nd, ix.r)
    reads = [("ok", text[100:103].tobytes()),
             ("miss", random_text(40, 5).tobytes())]
    batch = next(make_batches(reads, lanes=2))
    for rr in (False, True):
        with pytest.raises(AssertionError, match=tpml.NOT_FOUND):
            sc.query_pml(reads[1][1], random_repositioning=rr)
        with pytest.raises(AssertionError, match=tpml.NOT_FOUND):
            tpml.PMLEngine(broken, rr, "cpu").query_batch(batch)


def _codes(di, reads, mark_beyond):
    batch = next(make_batches(reads, lanes=len(reads)))
    alphas = tsearch.search_chars(di.alphamap_query, batch, mark_beyond)
    return torch.from_numpy(np.ascontiguousarray(alphas.T).astype(np.int8))


@pytest.mark.parametrize("b", [0, 4])
def test_split_scans_equal_one_pass(case, text, b):
    """At a forced shift, PML (both rules), count and ZML scans split in
    pieces (carried state) equal one pass."""
    di = _at(case["tdi"], b)
    reads = mixed_reads(text, seed=13, count=20)
    bounds = lambda W: [0, 2, 9, 30, W]  # noqa: E731
    for rr in _rules(case["ix"]):
        codes = _codes(di, reads, False)
        st0 = tpml.initial_state(di, codes.shape[1], "cpu")
        st_one, ml_one = tpml.compact_pml_scan(di, codes, st0, rr)
        st, mls = st0, []
        cut = bounds(codes.shape[0])
        for lo, hi in zip(cut, cut[1:]):
            st, ml = tpml.compact_pml_scan(di, codes[lo:hi], st, rr)
            mls.append(ml)
        assert all(torch.equal(x, y) for x, y in zip(st, st_one))
        assert torch.equal(torch.cat(mls), ml_one)
    for scan, count in ((tsearch.compact_count_scan, True),
                        (tsearch.compact_zml_scan, False)):
        codes = _codes(di, reads, count)
        st_one, out_one = scan(di, codes)
        st, outs = None, []
        cut = bounds(codes.shape[0])
        for lo, hi in zip(cut, cut[1:]):
            st, out = scan(di, codes[lo:hi], st)
            outs.append(out)
        assert torch.equal(st, st_one)
        assert torch.equal(outs[-1] if count else torch.cat(outs), out_one)


# ---- kernels 12a-12c, lane by lane, as their CUDA source reads

MASK = 0xFFFFFFFF


def _i32(v):
    v &= MASK
    return v - (1 << 32) if v >= 1 << 31 else v


class _Lane:
    """One thread of kernel 12a, 12b or 12c on numpy copies of the tables:
    compact.cuh find_run_dir, lf_dir and bs_step with their halvings and
    the chain of dependent loads each step adds past its first load and
    directory pairs."""

    def __init__(self, di):
        self.t = {k: getattr(di, k).numpy().astype(np.int64).reshape(-1)
                  for k in ("n", "lf_abs", "all_p", "c", "rep_up",
                            "rep_down", "c_search", "ch_up_s", "ch_down_s",
                            "run_dir", "first_runs", "first_offsets",
                            "last_runs", "last_offsets")}
        self.thr = (None if di.thr_full is None
                    else di.thr_full.numpy().astype(np.int64).reshape(-1))
        self.r, self.sigma, self.b = di.r, di.sigma, di.dir_shift
        self.halvings = self.chain = 0

    def find_run_dir(self, x):
        d, all_p = self.t["run_dir"], self.t["all_p"]
        k = max(0, min(x >> self.b, len(d) - 2))
        run = int(d[k])
        length = int(d[k + 1]) - run + 1
        start = int(all_p[run])
        h = 0
        while length > 1:
            half = length >> 1
            v = int(all_p[run + half])
            h += 1
            if v <= x:
                run += half
                start = v
            length -= half
        self.halvings += h
        return run, start, h

    def lf_dir(self, la, idx, off):
        x = _i32(la + off)
        run, start, h = self.find_run_dir(x)
        return run, _i32(x - start), h

    def pml(self, codes, idx, off, m, rpml):
        """compact_pml_kernel's loop; returns (state, ml) or None where a
        reposition finds no run."""
        t, r, sigma = self.t, self.r, self.sigma
        ml = []
        for a in codes:
            la = int(t["lf_abs"][idx])
            if a >= 0:
                if int(t["c"][idx]) == a:
                    m += 1
                else:
                    rep = a * r + idx
                    if rpml:
                        up = 2 * off < int(t["n"][idx])
                        up = True if idx == r - 1 else up
                        up = False if idx == 0 else up
                    else:
                        up = off < int(self.thr[idx * sigma + a])
                    dest = int(t["rep_up" if up else "rep_down"][rep])
                    self.chain += 3
                    if rpml and dest >= r:
                        up = not up
                        dest = int(t["rep_up" if up else "rep_down"][rep])
                        self.chain += 1
                    if dest >= r:
                        return None
                    idx, off, m = dest, 0, 0
                    if up:
                        off = int(t["n"][dest]) - 1
                    la = int(t["lf_abs"][dest])
            else:
                m = 0
            ml.append(m)
            idx, off, h = self.lf_dir(la, idx, off)
            self.chain += 2 + max(1, h)
        return (idx, off, m), ml

    def bs_step(self, a, rs, os_, re, oe):
        t, r = self.t, self.r
        last = self.sigma * r - 1
        a_s = max(a, 0)
        re_safe = min(re, r - 1)
        las, lae = int(t["lf_abs"][rs]), int(t["lf_abs"][re_safe])
        rs1, os1, re1, oe1 = rs, os_, re_safe, oe
        moved = False
        if int(t["c_search"][rs]) != a_s:
            rs1, os1 = int(t["ch_down_s"][min(a_s * r + rs, last)]), 0
            las = int(t["lf_abs"][min(rs1, r - 1)])
            moved = True
        if int(t["c_search"][re_safe]) != a_s:
            re1 = min(int(t["ch_up_s"][min(a_s * r + re_safe, last)]), r - 1)
            oe1 = int(t["n"][re1]) - 1
            lae = int(t["lf_abs"][re1])
            moved = True
        empty = a < 0 or rs1 >= r or rs1 > re
        rs1 = min(rs1, r - 1)
        rs1, os1, hs = self.lf_dir(las, rs1, os1)
        re1, oe1, he = self.lf_dir(lae, re1, oe1)
        self.chain += 2 + max(1, hs, he) + 2 * moved
        return empty, rs1, os1, re1, oe1

    def init_of(self, a):
        i = max(a, 0) + 1
        return [int(self.t[k][i]) for k in ("first_runs", "first_offsets",
                                             "last_runs", "last_offsets")]

    def search(self, codes, zml):
        """compact_search_kernel from the first char: (state, out)."""
        a0 = int(codes[0])
        rs, os_, re, oe = self.init_of(a0)
        x = 1 if a0 >= 0 else 0
        y = 0 if zml else 1 - x
        out = [0]
        for a in codes[1:]:
            a = int(a)
            if not zml and y:
                break
            if not zml and a == -2:
                continue
            empty, nrs, nos, nre, noe = self.bs_step(a, rs, os_, re, oe)
            if zml:
                ok = x and not empty
                if ok:
                    rs, os_, re, oe, y = nrs, nos, nre, noe, y + 1
                else:
                    (rs, os_, re, oe), y = self.init_of(a), 0
                x = 1 if ok or a >= 0 else 0
                out.append(y if x else 0)
            elif empty:
                y = 1
            else:
                rs, os_, re, oe, x = nrs, nos, nre, noe, x + 1
        if not zml:
            all_p = self.t["all_p"]
            s = int(all_p[rs]) + os_
            e = int(all_p[re]) + oe
            out = _i32(e - s + 1) if x > 0 else 0
        return [rs, os_, re, oe, x, y], out


@pytest.mark.parametrize("b", SHIFTS)
def test_kernels_lane_by_lane(case, text, b):
    """Each lane of kernels 12a-12c, transliterated from their CUDA
    source, ends in the plain scans' state with their ml or count, and
    takes the halvings and the chain of dependent loads the plain tally
    gives it (chip_smoke.py's bytes and latency floors read them)."""
    di = _at(case["tdi"], b)
    reads = mixed_reads(text, seed=14, count=24) + length_reads(
        text, lengths=(1, 400))
    for rr in _rules(case["ix"]):
        codes = _codes(di, reads, False)
        st = tpml.initial_state(di, codes.shape[1], "cpu")
        tally = torch.zeros((tpml.TALLY_ROWS, codes.shape[1]),
                            dtype=torch.int64)
        (idx, off, m), ml = tpml.compact_pml_scan_plain(di, codes, st, rr,
                                                        tally)
        mism = ((ml == 0) & (codes >= 0)).sum(0)
        for lane in range(codes.shape[1]):
            k = _Lane(di)
            got = k.pml([int(a) for a in codes[:, lane]], int(st[0][lane]),
                        int(st[1][lane]), int(st[2][lane]), rr)
            assert got is not None
            (gi, go, gm), gml = got
            assert (gi, go, gm) == (int(idx[lane]), int(off[lane]),
                                    int(m[lane]))
            assert gml == ml[:, lane].tolist()
            assert k.halvings == int(tally[2, lane])
            W = codes.shape[0]
            assert k.chain == (2 * W + int(tally[3, lane])
                               + 3 * int(mism[lane]) + int(tally[1, lane]))
    for zml in (False, True):
        codes = _codes(di, reads, not zml)
        tally = torch.zeros((tpml.TALLY_ROWS, codes.shape[1]),
                            dtype=torch.int64)
        plain = (tsearch.compact_zml_scan_plain if zml
                 else tsearch.compact_count_scan_plain)
        state, out = plain(di, codes, None, tally)
        steps = (torch.full_like(state[4], codes.shape[0] - 1) if zml
                 else torch.where(state[4] > 0, state[4] - 1 + state[5], 0))
        for lane in range(codes.shape[1]):
            k = _Lane(di)
            g_state, g_out = k.search(codes[:, lane].tolist(), zml)
            assert g_state == state[:, lane].tolist(), (zml, lane)
            assert g_out == (out[:, lane].tolist() if zml
                             else int(out[lane]))
            assert k.halvings == int(tally[2, lane])
            assert k.chain == 2 * int(steps[lane]) + int(tally[3, lane])
