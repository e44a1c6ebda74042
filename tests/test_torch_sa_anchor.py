"""Kernel 8b's SA pass (engine/fused_sa.py sa_entries: mark, the walk of
the anchors only, fill) against the flat walk of every element
(sa_walk_steps_plain) and movi_tpu's engine/fused_sa.py _sa_walk, on the
CPU; and the rule it rests on: a step on the LF path is exactly a match
(ml > 0) or the illegal code sigma, and from there the pre-LF state is one
sigma-slot LF step from the one before.  Tolerance 0: int32 and int64
streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused_sa as jsa
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused_sa as tsa
from movi_tpu_torch.engine.fused import (BIT_MATCH, BIT_USE_LF, FA_MASK,
                                         FB_MASK, FB_SHIFT)
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (length_reads, mixed_reads,
                                    separator_text, small_sa_index)

RATES = [1, 37, 100, 1000]
FILL_CHUNK = 32  # csrc/fused_sa.cu: bases of t per sa_fill thread


def _separator_sa_index(rate):
    """The separators index of tests/test_separators.py's text with its
    sampled SA at rate, and reads of its first document (with N's) and of
    lengths 1-4097 across the '%'s."""
    text, doc = separator_text()
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds", separators=True,
                          bound_ff=1)
    ix.sampled_SA = runs.sampled_sa(rate)
    ix.sa_sample_rate = rate
    return ix, mixed_reads(doc, seed=4, count=30) + length_reads(text)


def _setup(rate, separators=False):
    """(ix, sx, codes [W, lanes] of every read in one batch, kernel 8a's
    plain (state, ml, pre_idx, pre_off))."""
    if separators:
        ix, reads = _separator_sa_index(rate)
    else:
        text, ix, reads = small_sa_index(rate)
        reads = reads + length_reads(text)
    sx = tsa.build_fused_sa_index(ix, tf.build_fused_index(ix))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    codes = tf.FusedPMLEngine(sx.fi, "cpu").prepare(batch)
    return ix, sx, codes, _scan(sx, codes)


def _scan(sx, codes, state=None):
    fi = sx.fi
    if state is None:
        state = tf.initial_state(fi, codes.shape[1], "cpu")
    return tsa.pml_pre_state_scan_plain(fi.records, sx.pre_tab, fi.sigma + 1,
                                        fi.p_dollar, codes, state)


def _entries(sx, scan, codes, max_steps=None, sampled=None):
    fi = sx.fi
    _, ml, pre_idx, pre_off = scan
    return tsa.sa_entries_plain(
        fi.records, fi.sigma + 1, sx.all_p,
        sx.sampled if sampled is None else sampled, sx.rate,
        sx.n if max_steps is None else max_steps, pre_idx, pre_off, ml,
        codes)


def _flat(sx, scan, max_steps=None, sampled=None):
    fi = sx.fi
    return tsa.sa_walk_steps_plain(
        fi.records, fi.sigma + 1, sx.all_p,
        sx.sampled if sampled is None else sampled, sx.rate,
        sx.n if max_steps is None else max_steps, scan[2].reshape(-1),
        scan[3].reshape(-1))


@pytest.mark.parametrize("rate", RATES)
def test_sa_pass_equals_flat_walk_and_jax(rate):
    """On every element of the [W, lanes] batch, padding included."""
    ix, sx, codes, scan = _setup(rate)
    got, tally = _entries(sx, scan, codes)
    flat, steps = _flat(sx, scan)
    assert got.dtype == torch.int64 and got.shape == codes.shape
    assert torch.equal(got.reshape(-1), flat)
    jsx = jsa.build_fused_sa_index(ix, jf.build_fused_index(ix))
    want = jsa._sa_walk(jsx, jnp.asarray(scan[2].reshape(-1).numpy()),
                        jnp.asarray(scan[3].reshape(-1).numpy()))
    assert np.array_equal(got.reshape(-1).numpy(),
                          np.asarray(want).astype(np.int64))
    assert tally["elements"] == codes.numel() == (
        tally["sampled"] + tally["links"] + tally["anchors"])
    if rate == 1:
        assert tally["sampled"] == codes.numel()
    else:  # the anchors walk a small share of the flat walk's steps
        assert 0 < tally["anchor_steps"] * 20 < int(steps.sum())
        assert tally["longest"] <= int(steps.max())


@pytest.mark.parametrize("rate", [100, 1000])
def test_links_past_max_steps_give_minus_one(rate):
    """With a cap of 40 steps, exactly the elements whose flat walk passes
    it give -1, links and anchors alike."""
    _, sx, codes, scan = _setup(rate)
    got, _ = _entries(sx, scan, codes, max_steps=40)
    flat, steps = _flat(sx, scan, max_steps=40)
    full, full_steps = _flat(sx, scan)
    assert torch.equal(got.reshape(-1), flat)
    assert torch.equal(flat, torch.where(full_steps > 40, -1, full))
    assert int((flat < 0).sum()) > 0


def test_sa_values_past_2_40_stay_whole():
    _, sx, codes, scan = _setup(37)
    base, _ = _entries(sx, scan, codes)
    far, _ = _entries(sx, scan, codes, sampled=sx.sampled + (1 << 40))
    assert torch.equal(far - base, torch.full_like(base, 1 << 40))
    flat, _ = _flat(sx, scan, sampled=sx.sampled + (1 << 40))
    assert torch.equal(far.reshape(-1), flat)


def test_one_step_batch_is_all_anchors():
    """W = 1: no element has a step t+1, so every unsampled one walks."""
    _, sx, codes, _ = _setup(100)
    for t in (0, 5, codes.shape[0] - 1):
        one = codes[t:t + 1].contiguous()
        scan = _scan(sx, one)
        got, tally = _entries(sx, scan, one)
        assert tally["links"] == 0
        assert tally["sampled"] + tally["anchors"] == one.numel()
        assert torch.equal(got.reshape(-1), _flat(sx, scan)[0])


def test_split_scan_equals_one_pass():
    """Kernel 8a split into pieces, joined, then one SA pass: equal to one
    scan and one pass."""
    _, sx, codes, scan = _setup(100)
    want, _ = _entries(sx, scan, codes)
    cut = codes.shape[0] // 3 | 1
    first = _scan(sx, codes[:cut])
    second = _scan(sx, codes[cut:], first[0])
    joined = (second[0], *[torch.cat([a, b])
                           for a, b in zip(first[1:], second[1:])])
    got, _ = _entries(sx, joined, codes)
    assert torch.equal(got, want)


@pytest.mark.parametrize("rate", [37, 100])
def test_separator_index(rate):
    """An index with '%' separators: its '%' record slot takes the LF path
    without a match, and reads map '%' to sigma."""
    ix, sx, codes, scan = _setup(rate, separators=True)
    got, tally = _entries(sx, scan, codes)
    flat, _ = _flat(sx, scan)
    assert torch.equal(got.reshape(-1), flat)
    jsx = jsa.build_fused_sa_index(ix, jf.build_fused_index(ix))
    want = jsa._sa_walk(jsx, jnp.asarray(scan[2].reshape(-1).numpy()),
                        jnp.asarray(scan[3].reshape(-1).numpy()))
    assert np.array_equal(flat.numpy(), np.asarray(want).astype(np.int64))
    assert tally["links"] > tally["anchors"] > 0


@pytest.mark.parametrize("separators", [False, True])
def test_match_and_sigma_slots_carry_the_lf_fields(separators):
    """Over the whole records table: every match slot and the sigma slot
    set BIT_USE_LF with the sigma slot's LF fields (run id, fa, fb); every
    other slot but the separator's repositions."""
    ix, sx, _, _ = _setup(37, separators)
    fi = sx.fi
    slots = fi.sigma + 1
    rec = fi.records.to(torch.int64).reshape(-1, slots, 2)
    w1 = rec[..., 1]
    use_lf = (w1 >> BIT_USE_LF) & 1
    match = (w1 >> BIT_MATCH) & 1
    lf_fields = (w1 & FA_MASK) | (((w1 >> FB_SHIFT) & FB_MASK) << 12)
    sig = rec[:, fi.sigma]
    assert bool((use_lf[:, fi.sigma] == 1).all())
    assert bool((match[:, fi.sigma] == 0).all())
    m = match == 1
    assert bool((use_lf[m] == 1).all())
    run = rec[..., 0]
    assert torch.equal(run[m], sig[:, 0].unsqueeze(1).expand_as(run)[m])
    assert torch.equal(lf_fields[m],
                       lf_fields[:, fi.sigma].unsqueeze(1)
                       .expand_as(lf_fields)[m])
    lf_only = (use_lf == 1) & ~m
    lf_only[:, fi.sigma] = False
    if separators:  # the '%' slot: plain LF without a match
        sep = int(ix.alphamap[ord("%")])
        assert bool(lf_only[:, sep].all())
        lf_only[:, sep] = False
    assert not bool(lf_only.any())


def _lf_sigma(records, slots, idx, off):
    """One plain LF step with the bounded fast-forward, through the
    sigma slot."""
    rec = records[idx.to(torch.int64) * slots + slots - 1].to(torch.int64)
    fa = rec[:, 1] & FA_MASK
    fb = (rec[:, 1] >> FB_SHIFT) & FB_MASK
    off0 = fa + off
    ff = (off0 >= fb).to(torch.int64)
    return rec[:, 0] + ff, off0 - ff * fb


@pytest.mark.parametrize("separators", [False, True])
def test_link_rule_on_scan_outputs(separators):
    """Replaying kernel 8a: step t+1 takes the LF path exactly where
    ml[t+1] > 0 or its code is sigma, and there pre_{t+1} is one sigma-slot
    LF step from pre_t."""
    _, sx, codes, (_, ml, pre_idx, pre_off) = _setup(100, separators)
    fi = sx.fi
    slots = fi.sigma + 1
    state = tf.initial_state(fi, codes.shape[1], "cpu")
    use_lf = torch.empty_like(ml)
    for t in range(codes.shape[0]):
        key = state[0].to(torch.int64) * slots + codes[t].to(torch.int64)
        rec = fi.records[key]
        use_lf[t] = (rec[:, 1] >> BIT_USE_LF) & 1
        state, _ = tf.fused_step_math(rec, state, fi.p_dollar)
    rule = (ml > 0) | (codes.to(torch.int64) == fi.sigma)
    assert torch.equal(use_lf == 1, rule)
    link = rule[1:]
    nidx, noff = _lf_sigma(fi.records, slots, pre_idx[:-1].reshape(-1),
                           pre_off[:-1].reshape(-1).to(torch.int64))
    assert int(link.sum()) > 0
    assert torch.equal(nidx.reshape(link.shape)[link],
                       pre_idx[1:][link].to(torch.int64))
    assert torch.equal(noff.reshape(link.shape)[link],
                       pre_off[1:][link].to(torch.int64))


def _fill_by_chunks(out, dist, max_steps):
    """Kernel sa_fill as csrc/fused_sa.cu runs it, all lanes at once: each
    chunk of FILL_CHUNK bases starts from the first element at or after
    its end that is no link, then goes backward over the chunk."""
    out = out.clone()
    W, lanes = dist.shape
    link = dist == tsa.SA_LINK
    for s in range(0, W, FILL_CHUNK):
        e = min(s + FILL_CHUNK, W)
        v = torch.full((lanes,), -1, dtype=torch.int64)
        d = torch.full((lanes,), -1, dtype=torch.int64)
        if e < W:
            k = torch.full((lanes,), e, dtype=torch.int64)
            while True:
                more = link.gather(0, k.unsqueeze(0))[0]
                if not bool(more.any()):
                    break
                k += more.to(torch.int64)
            gap = k - e
            d = dist.gather(0, k.unsqueeze(0))[0]
            v = out.gather(0, k.unsqueeze(0))[0]
            d = torch.where((d < 0) | (d + gap > max_steps), -1, d + gap)
            v = torch.where(d < 0, -1, v + gap)
        for t in range(e - 1, s - 1, -1):
            d = torch.where(link[t], torch.where(
                (d < 0) | (d + 1 > max_steps), -1, d + 1), dist[t])
            v = torch.where(link[t], torch.where(d < 0, -1, v + 1), out[t])
            out[t] = v
    return out


@pytest.mark.parametrize("rate,max_steps", [(37, None), (1000, None),
                                            (1000, 40)])
def test_fill_by_chunks_equals_plain_fill(rate, max_steps):
    """sa_fill's chunked order (chains of rate 1,000 span many chunks)
    gives sa_fill_plain's values, from the mark and the anchors' walk."""
    _, sx, codes, (_, ml, pre_idx, pre_off) = _setup(rate)
    fi = sx.fi
    cap = sx.n if max_steps is None else max_steps
    out, dist, anchors = tsa.sa_mark_plain(sx.all_p, sx.sampled, sx.rate,
                                           pre_idx, pre_off, ml, codes,
                                           fi.sigma)
    vals, steps = tsa.sa_walk_steps_plain(
        fi.records, fi.sigma + 1, sx.all_p, sx.sampled, sx.rate, cap,
        pre_idx.reshape(-1)[anchors], pre_off.reshape(-1)[anchors])
    out.view(-1)[anchors] = vals
    dist.view(-1)[anchors] = torch.where(vals == -1, -1, steps)
    want = tsa.sa_fill_plain(out, dist, cap)
    assert torch.equal(_fill_by_chunks(out, dist, cap), want)
    assert torch.equal(want.reshape(-1),
                       _flat(sx, (None, ml, pre_idx, pre_off), cap)[0])


def test_engine_runs_the_sa_pass(monkeypatch):
    """FusedSAEngine.query_batch_device returns sa_entries' values."""
    _, ix, reads = small_sa_index(100)
    eng = tsa.FusedSAEngine(tf.build_fused_index(ix), ix, "cpu")
    calls = []
    real = tsa.sa_entries

    def counted(*args):
        calls.append(args[6].shape)
        return real(*args)

    monkeypatch.setattr(tsa, "sa_entries", counted)
    batch = next(make_batches(reads, lanes=8, bucket_widths=False))
    ml, sa = eng.query_batch_device(batch)
    assert calls == [tuple(ml.shape)]
    assert sa.dtype == torch.int64 and sa.shape == ml.shape
