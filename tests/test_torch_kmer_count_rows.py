"""The one-row step of the exact k-mer count kernels 9b
(csrc/fused_kmer.cu) and 7b (csrc/fused2_kmer_count.cu) on the CPU.

Once a k-mer's interval lies in one run (rs == re) the kernels load one
table row a step where the parents loaded two.  This file holds the table
invariants that make that exact, on the port's tables of several
indexes, and the plain row tallies (kmer_count_rows_plain,
fused2_kmer_count_rows_plain), which decode each step as the kernels do,
against the two-row plain versions and the JAX functions.  Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_kmer as jk
from movi_tpu.engine import fused_search as js
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.engine import fused_kmer as tk
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (index_from_text, kmer_reads, odd_index,
                                    pangenome, rc_index, separator_text,
                                    small_index, with_revcomp)

NAMES = ("small", "odd", "rc", "separator", "pangenome")


def _index(name):
    """(text, ix) of one of NAMES."""
    if name == "small":
        return small_index()
    if name == "odd":
        return odd_index()
    if name == "rc":
        fw, ix = rc_index(1500, 5)
        return with_revcomp(fw), ix
    if name == "separator":
        text = separator_text()[0]
        return text, build_move_index(build_bwt_runs(text),
                                      "regular-thresholds", separators=True,
                                      bound_ff=1)
    text = np.concatenate(pangenome(8, 1500))
    return text, index_from_text(text)


@pytest.fixture(scope="module")
def tables():
    """Per index: (text, ix, the one-step search table, the paired one),
    all on the CPU."""
    out = {}
    for name in NAMES:
        text, ix = _index(name)
        out[name] = (text, ix, ts.build_fused_search_index(ix),
                     ts2.build_fused_search2_index(ix, "cpu"))
    return out


@pytest.mark.parametrize("name", NAMES)
def test_one_step_rows_agree_where_the_run_holds_the_char(tables, name):
    """9b: wherever nds[a][i] == i the down row of (a, i) equals the up
    row bit for bit; wherever it does not, rd.x > i (or r): a one-run step
    from run i is empty."""
    _, ix, si, _ = tables[name]
    r, sigma = si.r, si.sigma
    nus, nds = ix.next_tables_search()
    runs = torch.arange(r)
    kept = 0
    for a in range(sigma):
        down = si.rec_all[a * r:(a + 1) * r]
        up = si.rec_all[(sigma + a) * r:(sigma + a + 1) * r]
        holds = torch.from_numpy(np.asarray(nds[a]).astype(np.int64)) == runs
        assert torch.equal(holds, down[:, 0] == runs)
        assert torch.equal(down[holds], up[holds])
        assert bool((down[~holds, 0] > runs[~holds]).all())
        kept += int(holds.sum())
    assert 0 < kept < sigma * r


def _micro(A, B, C):
    """The first micro-step with u = 0: (run, offset), any offset in."""
    ff = (B >= C).to(torch.int32)
    return A + ff, B - ff * C


@pytest.mark.parametrize("name", NAMES)
def test_paired_rows_agree_where_runs_are_kept(tables, name):
    """7b: u1 (word 0's bit 25) is the same in both directions; where it
    is 1, words 0 and 3 agree, and where a branch's u2 is 1 that branch's
    words agree (lo: 1 and 4, hi: 2 and 5).  Where u1 = 0 the mid
    interval of a one-run step is crossed whatever the offsets, the
    sentinels included: such a step is empty from the down row alone."""
    _, ix, _, s2 = tables[name]
    half = s2.r * s2.sigma ** 2
    down, up = s2.rec_all[:half], s2.rec_all[half:]
    u1 = ((down[:, 0] >> 25) & 1) == 1
    assert torch.equal(u1, ((up[:, 0] >> 25) & 1) == 1)
    assert torch.equal(down[u1][:, [0, 3]], up[u1][:, [0, 3]])
    for bit, words in ((26, [1, 4]), (27, [2, 5])):
        u2 = u1 & (((down[:, 0] >> bit) & 1) == 1)
        assert torch.equal(down[u2][:, words], up[u2][:, words])
        assert 0 < int(u2.sum()) < int(u1.sum())
    d, u = down[~u1], up[~u1]
    G = ts2.GUARD
    sr, so = _micro(d[:, 0] & 0x1FFFFFF, d[:, 3] & G, (d[:, 3] >> 12) & G)
    er, eo = _micro(u[:, 0] & 0x1FFFFFF, u[:, 3] & G, (u[:, 3] >> 12) & G)
    assert bool(((sr > er) | ((sr == er) & (so > eo))).all())
    # the sentinels occur: no a1-run above (SENT_HI) and none below (0)
    assert bool((d[:, 0] & 0x1FFFFFF == ts2.SENT_HI).any())
    assert 0 < int(u1.sum()) < len(u1)


def _windows(text, ix, k):
    """[k, nk] int32 windows of the k-mer reads (N's, reads shorter than
    k) on ix."""
    batch = next(make_batches(kmer_reads(text, seed=3), lanes=64,
                              bucket_widths=False))
    al, _ = tk.batch_kmer_windows(batch, ts.search_alphamap(ix), k)
    assert al is not None and bool((al < 0).any())
    assert int(batch.lengths.min()) < k
    return al


def _pair_categories(s2, win, k):
    """Walk the two-row plain pair steps and count, over the steps each
    k-mer takes, the one-run steps (rs == re), those whose down row says
    empty (u1 = 0), those whose end decodes from it, and all steps."""
    a = win.to(torch.int32)
    dead = ~(a >= 0).all(dim=0)
    rs, os_, re, oe = ts.init_interval(s2.init_rec, a[k - 1])
    S2 = s2.sigma ** 2
    n = dict(steps=0, one=0, empty=0, stand_in=0)
    a1s, a2s = ts2._pair_rows(a[:-1].flip(0))
    for a1, a2 in zip(a1s, a2s):
        alive = ~dead
        a12 = a1.clamp(min=0) * s2.sigma + a2.clamp(min=0)
        one = alive & (rs == re)
        rd = s2.rec_all[rs.clamp(0, s2.r - 1).to(torch.int64) * S2
                        + a12.to(torch.int64)]
        w0, w3 = rd[:, 0], rd[:, 3]
        u1 = ((w0 >> 25) & 1) == 1
        hi = (w3 & ts2.GUARD) + oe >= ((w3 >> 12) & ts2.GUARD)
        u2 = (torch.where(hi, w0 >> 27, w0 >> 26) & 1) == 1
        n["steps"] += int(alive.sum())
        n["one"] += int(one.sum())
        n["empty"] += int((one & ~u1).sum())
        n["stand_in"] += int((one & u1 & u2).sum())
        l2 = a2 >= 0
        mid, fin, e1, e2 = ts2.fused2_bs_step(s2.rec_all, s2.r, s2.sigma, rs,
                                              os_, re, oe, a12, a1 >= 0, l2)
        ok1 = alive & ~e1
        ok2 = ok1 & ~e2
        dead = dead | (alive & (e1 | (l2 & ~e1 & e2)))
        rs, os_, re, oe = (torch.where(ok2, f, torch.where(ok1, m, c))
                           for c, m, f in zip((rs, os_, re, oe), mid, fin))
    return n


def _one_step_counts(si, win, k):
    """(steps, one-run steps) the one-step kernel takes over win."""
    a = win.to(torch.int32)
    dead = ~(a >= 0).all(dim=0)
    rs, os_, re, oe = ts.init_interval(si.init_rec, a[k - 1])
    steps = one = 0
    for j in range(k - 2, -1, -1):
        steps += int((~dead).sum())
        one += int((~dead & (rs == re)).sum())
        nrs, nos, nre, noe, empty = ts.fused_bs_step(si.rec_all, si.r,
                                                     si.sigma, rs, os_, re,
                                                     oe, a[j])
        ok = ~dead & ~empty
        rs, os_, re, oe = (torch.where(ok, n, c) for n, c in
                           zip((nrs, nos, nre, noe), (rs, os_, re, oe)))
        dead = dead | empty
    return steps, one


@pytest.mark.parametrize("name", ("rc", "pangenome", "separator", "odd"))
@pytest.mark.parametrize("k", (8, 15, 31))
def test_one_step_row_tally_equals_plain_and_jax(tables, name, k):
    """kmer_count_rows_plain's (found, count) equal kmer_count_scan_plain's
    and _kmer_count_scan's; its rows are one a one-run step and two
    elsewhere, over the steps each k-mer takes."""
    text, ix, si, _ = tables[name]
    al = _windows(text, ix, k)
    win = torch.from_numpy(al)
    tabs = (si.rec_all, si.init_rec, si.all_p, si.r, si.sigma)
    found, cnt, rows = tk.kmer_count_rows_plain(*tabs, win, k)
    assert rows.dtype == torch.int32 and rows.shape == found.shape
    for g, w in zip((found, cnt), tk.kmer_count_scan_plain(*tabs, win, k)):
        assert torch.equal(g, w)
    want = jk._kmer_count_scan(js.build_fused_search_index(ix),
                               jnp.asarray(al), k)
    for g, w in zip((found, cnt), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert 0 < int(found.sum()) < len(found)
    steps, one = _one_step_counts(si, win, k)
    assert int(rows.sum()) == 2 * steps - one
    assert 0 < one < steps


@pytest.mark.parametrize("name", ("rc", "pangenome", "separator", "odd"))
@pytest.mark.parametrize("k", (8, 15, 31))
def test_paired_row_tally_equals_plain_and_jax(tables, name, k):
    """fused2_kmer_count_rows_plain's (found, count) equal
    fused2_kmer_count_scan_plain's and the JAX fused2_kmer_count_scan's;
    its rows are one a one-run pair step that the down row decides or
    stands in for, two elsewhere."""
    text, ix, _, s2 = tables[name]
    al = _windows(text, ix, k)
    win = torch.from_numpy(al)
    tabs = (s2.rec_all, s2.init_rec, s2.all_p, s2.r, s2.sigma)
    found, cnt, rows = ts2.fused2_kmer_count_rows_plain(*tabs, win, k)
    assert rows.dtype == torch.int32 and rows.shape == found.shape
    for g, w in zip((found, cnt),
                    ts2.fused2_kmer_count_scan_plain(*tabs, win, k)):
        assert torch.equal(g, w)
    want = js2.fused2_kmer_count_scan(js2.build_fused_search2_index(ix),
                                      jnp.asarray(al), k)
    for g, w in zip((found, cnt), want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    n = _pair_categories(s2, win, k)
    assert int(rows.sum()) == 2 * n["steps"] - n["empty"] - n["stand_in"]
    # every path of the rule runs: the down row alone (empty or standing
    # in) and the dependent up row of a one-run step
    assert n["empty"] > 0 and n["stand_in"] > 0
    if k > 8:
        assert n["one"] > n["empty"] + n["stand_in"]
