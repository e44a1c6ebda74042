"""The rows that the left pair steps of kernel 11b (csrc/fused_kmer2.cu)
need under kernel 7b's one-row rule, on the CPU: the bytes of 11b's bound.

kmer2_left_rows_plain decides each left pair step of the bidirectional
k-mer counts as the kernel does, and counts its rows by the rule: the
first char -2 a no-op, -1 in either char a kill before any row, and,
once the interval lies in one run, the down row alone where it decides
the step (u1 = 0), stands in for the up row (the end's branch keeps its
run) or the second char is the pad and the first micro-step keeps its
run.  Its (found, count) equal
kmer2_left_scan_plain's and the JAX _kmer2_left_flat's over the JAX
engine's flat partials, and per read the JAX engine's; its rows equal
2 * steps - empty - stand_in by a recount over the two-row steps, which
also checks that wherever the down row stands in, the answer is the
two-row one.  Two reverse-complement closed indexes (testing.rc_index and
an 8-genome pangenome with its reverse complement), k = 8, 15, 31 and
p = 1, k//2, k-1, reads with N's and reads shorter than k.  Every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_kmer2 as jk2
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.engine import fused_kmer2 as tk2
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
from movi_tpu_torch.testing import (index_from_text, kmer_reads, pangenome,
                                    rc_index, with_revcomp)

NAMES = ("rc", "pangenome")
KS = (8, 15, 31)
CATEGORIES = ("steps", "one", "empty", "stand_in", "pad_stand_in",
              "one_two_rows", "kill", "noop")


def _index(name):
    """(text, ix) of a reverse-complement closed index."""
    if name == "rc":
        fw, ix = rc_index(1500, 5)
        return with_revcomp(fw), ix
    text = with_revcomp(np.concatenate(pangenome(8, 1500)))
    return text, index_from_text(text)


@pytest.fixture(scope="module")
def tables():
    """Per index: the reads' batch and both packages' MEM v2 and paired
    search tables."""
    out = {}
    for name in NAMES:
        text, ix = _index(name)
        reads = kmer_reads(text, seed=11)
        batch = next(make_batches(reads, lanes=len(reads),
                                  bucket_widths=False))
        out[name] = dict(batch=batch, m2=tm2.build_fused_mem2_index(ix),
                         s2=ts2.build_fused_search2_index(ix, "cpu"),
                         jm2=jm2.build_fused_mem2_index(ix),
                         js2=js2.build_fused_search2_index(ix))
    return out


def _phase_r(t, k, p):
    """(slots, own, anchor) and phase R's (alive, fs, fe) of the batch."""
    batch, m2 = t["batch"], t["m2"]
    own, anchor = tk2.kmer2_groups(batch.lengths, k, p)
    al = left_aligned_slots(batch, m2.alphamap_query, fill=-1)
    slots, own, anchor = (torch.from_numpy(x.astype(d)) for x, d in
                          ((al, np.int8), (own, np.int32),
                           (anchor, np.int32)))
    right = tk2.kmer2_right_scan_plain(
        m2, tk2.kmer_windows(slots, own, anchor, k), k)
    return (slots, own, anchor), right


def _jax_left(t, groups, right, k, p):
    """_kmer2_left_flat over the JAX engine's flat lanes (every alive
    partial of depth d < p_eff), scattered to [p, G]."""
    slots, own, anchor = groups
    alive, fs, fe = right
    G = own.shape[0]
    d = np.arange(p)[:, None]
    mask = alive.numpy()[k - 2 - d[:, 0]] & (d <= anchor.numpy()[None, :])
    dd, gg = np.nonzero(mask)
    found = np.zeros((p, G), bool)
    cnt = np.zeros((p, G), np.int32)
    if len(dd):
        flat = ((k - 2 - dd) * G + gg).astype(np.int32)
        f, c = jk2._kmer2_left_flat(
            t["jm2"], t["js2"], jnp.asarray(fs.numpy()),
            jnp.asarray(fe.numpy()), jnp.asarray(slots.numpy(), jnp.int32),
            jnp.asarray(own.numpy()[gg]), jnp.asarray(anchor.numpy()[gg]),
            jnp.asarray(dd.astype(np.int32)), jnp.asarray(flat),
            tk2.left_steps(p))
        found[dd, gg] = np.asarray(f)
        cnt[dd, gg] = np.asarray(c)
    return found, cnt


def _recount(t, groups, right, k, p):
    """The two-row pair steps of kmer2_left_flat_plain, walked again: per
    step taken, its category under the one-row rule; and that the rule's
    rows give the two-row answer wherever the down row stands in."""
    m2, s2 = t["m2"], t["s2"]
    slots, own, anchor = groups
    alive, fs, fe = right
    G = own.shape[0]
    d = torch.arange(p)[:, None].expand(p, G)
    live = alive.flip(0)[:p] & (d <= anchor[None, :].to(torch.int64))
    row = ((k - 2 - d) * G + torch.arange(G)[None, :]).reshape(-1)
    rs, os_ = tm2.mem2_resolve(m2, fs.reshape(-1)[row])
    re, oe = tm2.mem2_resolve(m2, fe.reshape(-1)[row])
    W = slots.shape[1]
    base = own.to(torch.int64).repeat(p) * W
    anc = anchor.to(torch.int64).repeat(p)
    depth = d.reshape(-1)
    dead = ~live.reshape(-1)
    S2 = s2.sigma ** 2
    n = dict.fromkeys(CATEGORIES, 0)
    for j in range(0, p - 1, 2):
        def char(jj):
            c = slots.reshape(-1)[base + (anc - 1 - jj).clamp(min=0)]
            return torch.where(jj < depth, c.to(torch.int32), -2)

        a1, a2 = char(j), char(j + 1)
        alive_now = ~dead
        n["noop"] += int((alive_now & (a1 == -2) & (j < depth)).sum())
        kill = alive_now & (a1 != -2) & ((a1 < 0) | (a2 == -1))
        n["kill"] += int(kill.sum())
        step = alive_now & (a1 != -2) & ~kill
        l2 = a2 >= 0
        a12 = (a1.clamp(min=0) * s2.sigma + a2.clamp(min=0)).to(torch.int64)
        mid, fin, e1, e2 = ts2.fused2_bs_step(s2.rec_all, s2.r, s2.sigma, rs,
                                              os_, re, oe, a12, a1 >= 0, l2)
        rd = s2.rec_all[rs.clamp(0, s2.r - 1).to(torch.int64) * S2 + a12]
        w0, w3 = rd[:, 0], rd[:, 3]
        u1 = ((w0 >> 25) & 1) == 1
        hi = (w3 & ts2.GUARD) + oe >= ((w3 >> 12) & ts2.GUARD)
        u2 = (torch.where(hi, w0 >> 27, w0 >> 26) & 1) == 1
        one = step & (rs == re)
        n["steps"] += int(step.sum())
        n["one"] += int(one.sum())
        n["empty"] += int((one & ~u1).sum())
        n["stand_in"] += int((one & u1 & u2).sum())
        n["pad_stand_in"] += int((one & u1 & ~u2 & ~l2).sum())
        n["one_two_rows"] += int((one & u1 & ~u2 & l2).sum())
        # u1 = 0 on one run: the two-row step is empty too
        assert bool(e1[one & ~u1].all())
        # the down row standing in: the same mid interval, and the same
        # final one where the step keeps it
        sub = one & u1 & (u2 | ~l2)
        mid1, fin1, e11, e21 = ts2.bs2_decode(rd, rd, os_, oe, a1 >= 0, l2)
        assert torch.equal(e11[sub], e1[sub])
        for x, y in zip(mid1, mid):
            assert torch.equal(x[sub & ~e1], y[sub & ~e1])
        keep2 = sub & ~e1 & l2
        assert torch.equal(e21[keep2], e2[keep2])
        for x, y in zip(fin1, fin):
            assert torch.equal(x[keep2 & ~e2], y[keep2 & ~e2])
        die = step & (e1 | (l2 & e2))
        keep = step & ~die
        rs, os_, re, oe = (torch.where(keep & l2, f,
                                       torch.where(keep, mv, cv))
                           for cv, mv, f in zip((rs, os_, re, oe), mid, fin))
        dead = dead | kill | die
    return n


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("pk", ("1", "k//2", "k-1"))
def test_left_row_tally_equals_plain_and_jax(tables, name, k, pk):
    t = tables[name]
    p = {"1": 1, "k//2": k // 2, "k-1": k - 1}[pk]
    groups, right = _phase_r(t, k, p)
    slots, own, anchor = groups
    G = own.shape[0]
    found, cnt, rows, steps = tk2.kmer2_left_rows_plain(
        t["m2"], t["s2"], *right, *groups, k, p)
    for x, dt in zip((found, cnt, rows, steps),
                     (torch.bool, torch.int32, torch.int32, torch.int32)):
        assert x.shape == (p, G) and x.dtype == dt
    want = tk2.kmer2_left_scan_plain(t["m2"], t["s2"], *right, *groups, k,
                                     p)
    for g, w in zip((found, cnt), want):
        assert torch.equal(g, w)
    jf, jc = _jax_left(t, groups, right, k, p)
    assert np.array_equal(found.numpy(), jf)
    assert np.array_equal(cnt.numpy(), jc)
    # per read, the JAX engine's (found, total)
    lane = own.to(torch.int64).repeat(p)
    sums = torch.zeros((2, t["batch"].lanes), dtype=torch.int64)
    sums[0].index_add_(0, lane, found.reshape(-1).to(torch.int64))
    sums[1].index_add_(0, lane, cnt.reshape(-1).to(torch.int64))
    eng = jk2.FusedKmer2CountEngine(t["jm2"], t["js2"], k, p=p)
    assert list(zip(*sums.tolist())) == eng.query_batch(t["batch"])
    assert 0 < int(found.sum()) < p * G
    n = _recount(t, groups, right, k, p)
    assert int(steps.sum()) == n["steps"]
    assert int(rows.sum()) == 2 * n["steps"] - n["empty"] - n["stand_in"] \
        - n["pad_stand_in"]
    if p == 1:
        assert n["steps"] == 0 and int(rows.sum()) == 0


def test_every_branch_ran(tables):
    """At p = k//2 and k-1 on both indexes every branch of the rule and of
    the sentinels runs: one-run steps decided by the down row (empty,
    standing in, the pad) and by both rows, steps over two runs, kills by
    an N.  A first char -2 never comes inside a read (the slots hold -1
    for N and past a read), so its no-op never runs."""
    seen = dict.fromkeys(CATEGORIES, 0)
    for name in NAMES:
        for k, p in ((15, 14), (31, 15)):
            n = _recount(tables[name], *_phase_r(tables[name], k, p), k, p)
            for key in CATEGORIES:
                seen[key] += n[key]
    for key in ("empty", "stand_in", "pad_stand_in", "one_two_rows",
                "kill"):
        assert seen[key] > 0, key
    assert seen["steps"] > seen["one"]
    assert seen["noop"] == 0
