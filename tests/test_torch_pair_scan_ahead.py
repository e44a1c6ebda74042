"""Kernel 3 (the paired PML scan) and kernel 4 (the paired color scan)
take their pair codes off the chain: lane by lane transliterations of
movi_tpu_torch/csrc/fused2_pml.cu fused2_pml_scan_kernel and of
csrc/fused2_color.cu fused2_color_scan_kernel (with and without early
stop), for uint8 and int32 pair codes.

Every pair code is loaded two steps before the step whose record it
addresses, from a clamped address (the launch's prologue loads the first
two; in the last two steps a step loads its own code, never used).
Every record is issued at the end of the step before (the prologue
issues the first; after a lane's last step kernel 3 issues the lane's
own record once more, kernel 4 the row its state addresses, inside the
table; neither is used), and the stores follow that issue.  Kernel 4
takes both color ids out of its row before it issues the next one, reads
each row's word 7 into `sink`, and and-s the last row and code into it
after its loop.  The registers and outputs after every pair step equal
the plain versions' (fused2_pml_scan_plain, fused2_color_scan_plain) run
one pair step a call, in one pass and split at pair steps 1, 2 and the
middle, and the JAX functions (_fused2_scan_carry,
_fused2_color_scan_carry and _fused2_color_scan_carry_es) agree in one
pass and from the same split points.  Scans of 0, 1 and 2 pair steps,
odd read lengths, reads with '#' and early stops at the first and at
the second check of a pair step are among the cases.  Every comparison
is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused2 as jf2
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (early_stop_reads, length_reads,
                                    mixed_reads, small_color_index,
                                    small_index)

RING = 2  # each pair code is loaded this many steps ahead
BIAS = 4096
KIND_LF2, KIND_MIS2 = 0, 1
CODE_TYPES = [torch.uint8, torch.int32]
SHORT = (1, 2, 3, 4, 5, 160, 161)  # 1 and 2 pair steps, odd lengths


def with_hash(reads, every=5):
    """The reads, every `every`-th with two bases replaced by '#'."""
    out = []
    for i, (name, seq) in enumerate(reads):
        if i % every == 1 and len(seq) > 4:
            s = bytearray(seq)
            s[1] = s[len(s) // 2] = ord("#")
            seq = bytes(s)
        out.append((name, seq))
    return out


def splits_of(W2, mid):
    return [s for s in (None, 1, 2, max(mid, 3)) if s is None or s < W2]


def decode_pair(row, off, pd):
    """records.cuh decode_pair on a record's first four words."""
    w0, wy, wz, w3 = (int(x) & 0xFFFFFFFF for x in row[:4])
    T1 = (w0 & 0x1FFF) - BIAS
    hi = off >= T1
    wb = wz if hi else wy
    if hi:
        A = ((w3 >> 16) & 0xFFFF) | (((w0 >> 23) & 0x1FF) << 16)
    else:
        A = (w3 & 0xFFFF) | (((w0 >> 14) & 0x1FF) << 16)
    B = (wb & 0x1FFF) - BIAS
    C = (wb >> 13) & 0xFFF
    kind = (wb >> 25) & 3
    flags = (wb >> 27) & 7
    off0 = B + off
    ff = off0 >= C
    down = off >= B
    if kind == KIND_LF2:
        nidx, noff = A + int(ff), off0 - C if ff else off0
    elif kind == KIND_MIS2:
        bump, d_up, d_dn = flags & 1, (flags >> 1) & 1, (flags >> 2) & 1
        if down:
            nidx = pd[0] if d_dn else A + bump
            noff = pd[1] if d_dn else (0 if bump else C + 1)
        else:
            nidx = pd[0] if d_up else A
            noff = pd[1] if d_up else C
    else:
        nidx, noff = A, C
    return dict(nidx=nidx, noff=noff, match1=(w0 >> 13) & 1,
                match2=0 if kind == KIND_MIS2 else flags & 1, hi=hi, ff=ff,
                down=down, kind=kind)


def es_hit(csum, t, L):
    """color.cuh es_hit."""
    p1 = L - 2 - t
    return p1 >= 0 and 2 * p1 < L and p1 % 100 == 0 and \
        5 * csum < 2 * (L - p1)


def pair_lane(rec, s2, pd, codes, st, L, t0, events, color):
    """One thread of kernel 3 (color False) or kernel 4 (color True) over
    a lane's pair codes from the state st (idx, off, m, csum, stop);
    early stop when L is not None (kernel 4 only).  Yields (t, idx, off,
    m, csum, stop, ml1, ml2, cid1, cid2, check) after each pair step it
    runs, check the early-stop check that fired (1 or 2) or 0.  It
    asserts that each code was loaded RING steps before the step whose
    record it addresses (the prologue loads the first two) from inside
    the lane's codes, that each step's record is the one its state and
    code address, issued at the end of the step before (the prologue
    issues the first), and that every record issued lies inside the
    table (after the lane's last step kernel 3's own record again).
    events gets ("issue",
    t), ("cids", t) and ("store", t) in program order."""
    W2 = len(codes)
    idx, off, m, csum, stop = st
    steps = W2 if L is None else (
        0 if stop else max(0, min(W2, (L - t0 + 1) // 2)))
    keep = W2 >> 31  # 0, the kernel's `keep`
    sink = 0
    if steps == 0:
        return
    loaded = {0: "prologue", 1: "prologue"}
    row, issued_at = idx * s2 + int(codes[0]), -1
    events.append(("issue", 0))
    a_next = int(codes[1 if steps > 1 else 0])
    for t in range(steps):
        assert loaded[t] == "prologue" or loaded[t] <= t - RING, (t, loaded)
        assert issued_at == t - 1 and row == idx * s2 + int(codes[t])
        # the code two steps on, from a clamped address
        at = t + 2 if t + 2 < steps else t
        loaded.setdefault(at, t)
        a_after = int(codes[at])
        words = rec[row]
        d = decode_pair(words, off, pd)
        c1 = c2 = 0
        if color:
            w4 = int(words[4]) & 0xFFFFFFFF
            wc2 = int(words[6] if d["hi"] else words[5]) & 0xFFFFFFFF
            sel2 = (d["ff"] if d["kind"] == KIND_LF2 else
                    d["down"] if d["kind"] == KIND_MIS2 else False)
            c1 = (w4 >> 16) if d["hi"] else w4 & 0xFFFF
            c2 = (wc2 >> 16) if sel2 else wc2 & 0xFFFF
            sink |= int(words[7])  # word 7 read: its register stays live
            events.append(("cids", t))
        ml1 = m + 1 if d["match1"] else 0
        ml2 = ml1 + 1 if d["match2"] else 0
        idx, off, m = d["nidx"], d["noff"], ml2
        # the next record; after the last step kernel 3 issues this step's
        # own again, kernel 4 the one its state and code address
        if t + 1 < steps:
            assert a_next == int(codes[t + 1])
        if t + 1 < steps or color:
            row = idx * s2 + a_next
        issued_at = t
        assert 0 <= row < len(rec), (t, row)
        events.append(("issue", t + 1))
        events.append(("store", t))
        a_next = a_after
        check = 0
        if L is not None:
            t1 = t0 + 2 * t
            csum += ml1
            hit1 = es_hit(csum, t1, L)
            csum += ml2
            hit2 = es_hit(csum, t1 + 1, L)
            if hit1 or hit2:
                stop = t1 + 2
                check = 1 if hit1 else 2
        yield t, idx, off, m, csum, stop, ml1, ml2, c1, c2, check
        if check:
            break
    if color:  # the sink: the last row and code stay live, then and-ed
        sink |= int(np.bitwise_or.reduce(rec[row].astype(np.int64))) | a_next
        assert sink & keep == 0


def lane_trail(rec, s2, pd, codes, plain, st0, i, split, L, color):
    """Lane i's trail through pair_lane in one pass or split at `split`
    (resumed from the plain state after pair step split-1), and the
    first piece's events."""
    events = []
    st = [int(s[i]) for s in st0] + [0, 0] * (L is None)
    trail = list(pair_lane(rec, s2, pd, codes, st, L, 0, events, color))
    if split is not None:
        mid = [int(v) for v in plain[split - 1, :, i]] + [0, 0] * (L is None)
        trail = [s for s in trail if s[0] < split] + [
            (t + split, *rest) for t, *rest in
            pair_lane(rec, s2, pd, codes[split:], mid, L, 2 * split, [],
                      color)]
    return trail, events


def check_order(events, steps, color):
    """The next record is issued before this step's stores, and kernel 4
    takes its color ids before that issue."""
    for t in range(steps):
        issue = events.index(("issue", t + 1))
        assert issue < events.index(("store", t))
        if color:
            assert events.index(("cids", t)) < issue


def short_scans(rec, s2, pd, codes, plain, st0, i, L, color):
    """Scans of 0, 1 and 2 pair steps of lane i from the start: a scan of
    0 loads nothing and leaves the state as it came in."""
    for n in (0, 1, 2):
        events = []
        st = [int(s[i]) for s in st0] + [0, 0] * (L is None)
        trail = list(pair_lane(rec, s2, pd, codes[:n], st, L, 0, events,
                               color))
        assert (n == 0) == (events == [])
        assert [s[0] for s in trail] == list(range(len(trail)))
        for t, *regs in trail:
            assert regs[:plain.shape[1]] == plain[t, :, i].tolist(), (i, n)


# ---- kernel 3: the paired PML scan


@pytest.fixture(scope="module")
def pml_setup():
    text, ix = small_index()
    reads = with_hash(mixed_reads(text, count=24)
                      + length_reads(text, lengths=SHORT))
    batch = next(make_batches(reads, lanes=len(reads)))
    jf2i = jf2.build_fused2_index(jf.build_fused_index(ix))
    tf2i = tf2.build_fused2_index(tf.build_fused_index(ix))
    return batch, jf2i, tf2i


@pytest.mark.parametrize("code_type", CODE_TYPES)
def test_pml_pair_codes_ahead_and_equals_plain(pml_setup, code_type):
    """Kernel 3's loop, lane by lane: each pair code loaded two steps
    ahead, each record issued at the end of the step before, both ml
    stores after that issue; the state and ml after every pair step
    equal the plain scan's run one pair step a call, in one pass and
    split at pair steps 1, 2 and the middle, and JAX's carried scan from
    the same points; scans of 0, 1 and 2 pair steps too."""
    batch, jf2i, tf2i = pml_setup
    a12_t, _ = tf2.Fused2PMLEngine(tf2i, "cpu").prepare(batch)
    codes = a12_t.to(code_type)
    W2, lanes = codes.shape
    slots = tf2i.sigma + 1
    s2 = slots * slots
    args = (tf2i.records, slots, tf2i.p_dollar)
    st0 = tf.initial_state(tf2i, lanes, "cpu")
    states, mls, st = [], [], st0
    for t in range(W2):
        st, ml = tf2.fused2_pml_scan_plain(*args, codes[t:t + 1], st)
        states.append(st)
        mls.append(ml)
    st_one, ml_one = tf2.fused2_pml_scan_plain(*args, codes, st0)
    assert torch.equal(torch.cat(mls), ml_one)
    for a, b in zip(states[-1], st_one):
        assert torch.equal(a, b)
    st_zero, ml_zero = tf2.fused2_pml_scan_plain(*args, codes[:0], st0)
    assert ml_zero.shape == (0, lanes)
    for a, b in zip(st_zero, st0):
        assert torch.equal(a, b)
    plain = np.stack([np.stack([s.numpy().astype(np.int64) for s in sts])
                      for sts in states])  # [W2, 3, lanes]
    ml_np = ml_one.numpy()
    jc = jnp.asarray(codes.numpy())
    for split in splits_of(W2, W2 // 2):
        lo = 0 if split is None else split
        jst = tuple(jnp.asarray(s.numpy()) if split is None else
                    jnp.asarray(plain[split - 1, k].astype(np.int32))
                    for k, s in enumerate(st0))
        jout, jml = jf2._fused2_scan_carry(jf2i, jc[lo:], jst)
        assert np.array_equal(np.asarray(jml), ml_np[2 * lo:])
        assert np.array_equal(np.stack([np.asarray(s) for s in jout]),
                              plain[-1])
    rec = tf2i.records.numpy()
    pd = tf2i.p_dollar
    for i in range(lanes):
        c = codes[:, i].numpy()
        short_scans(rec, s2, pd, c, plain, st0, i, None, False)
        for split in splits_of(W2, W2 // 2):
            trail, events = lane_trail(rec, s2, pd, c, plain, st0, i, split,
                                       None, False)
            assert [s[0] for s in trail] == list(range(W2)), (i, split)
            for t, idx, off, m, _, _, ml1, ml2, _, _, _ in trail:
                assert [idx, off, m] == plain[t, :, i].tolist(), \
                    (i, split, t)
                assert [ml1, ml2] == ml_np[2 * t:2 * t + 2, i].tolist()
            check_order(events, W2, False)


# ---- kernel 4: the paired color scan


@pytest.fixture(scope="module")
def color_setup():
    docs, ix, ct, reads = small_color_index()
    reads = with_hash(reads + early_stop_reads(reads)
                      + length_reads(docs[0], lengths=SHORT))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    jci = jf2.build_fused2_color_index(jf.build_fused_index(ix), ct)
    tci = tf2.build_fused2_color_index(tf.build_fused_index(ix), ct)
    return batch, ct, jci, tci


def jax_color(jci, codes, st, t0, lens):
    """JAX's carried paired color scan from the port's state (early stop
    with lens): (core state, ml, cid, stopped or None) as numpy."""
    core = tuple(jnp.asarray(s.numpy()) for s in st[:3])
    jc = jnp.asarray(codes.numpy())
    if lens is None:
        jst, ml, cid = jf2._fused2_color_scan_carry(jci, jc, core)
        stopped = None
    else:
        es = (core, jnp.asarray(st[3].numpy().astype(np.int32)),
              jnp.asarray(st[4].numpy() > 0))
        (jst, _, stopped), ml, cid, _ = jf2._fused2_color_scan_carry_es(
            jci, jc, t0, jnp.asarray(lens.numpy()), es)
        stopped = np.asarray(stopped)
    return (np.stack([np.asarray(s) for s in jst]), np.asarray(ml),
            np.asarray(cid), stopped)


@pytest.mark.parametrize("code_type", CODE_TYPES)
@pytest.mark.parametrize("early_stop", [False, True])
def test_color_pair_codes_ahead_and_equals_plain(color_setup, early_stop,
                                                 code_type):
    """Kernel 4's loop, lane by lane: each pair code loaded two steps
    ahead, both color ids taken out of the row before the next row is
    issued, that issue at the end of the step, the four stores after it,
    each row's word 7 and the last row and code kept live in `sink`; the
    state, ml and color ids after every pair step equal the plain scan's
    run one pair step a call, in one pass and split at pair steps 1, 2
    and the middle, and JAX's carried scan from the same points (with
    early stop: on every row a lane scanned, and its retirement, which
    fires at the first check of a pair step on some lanes and at the
    second on others); scans of 0, 1 and 2 pair steps too."""
    batch, ct, jci, tci = color_setup
    eng = tf2.Fused2ColorEngine(tci, ct, "cpu", early_stop=early_stop)
    (records, slots, pd, a12_t, st0, lens), _ = eng.scan_args(batch)
    codes = a12_t.to(code_type)
    W2, lanes = codes.shape
    s2 = slots * slots
    states, mls, cs, st = [], [], [], st0
    for t in range(W2):
        st, ml, c = tf2.fused2_color_scan_plain(records, slots, pd,
                                                codes[t:t + 1], st, lens,
                                                t0=2 * t)
        states.append([s.clone() for s in st])
        mls.append(ml)
        cs.append(c)
    st_one, ml_one, cid_one = tf2.fused2_color_scan_plain(
        records, slots, pd, codes, st0, lens)
    assert torch.equal(torch.cat(mls), ml_one)
    assert torch.equal(torch.cat(cs), cid_one)
    for a, b in zip(states[-1], st_one):
        assert torch.equal(a, b)
    plain = np.stack([np.stack([s.numpy().astype(np.int64) for s in sts])
                      for sts in states])  # [W2, 3 or 5, lanes]
    ml_np, cid_np = ml_one.numpy(), cid_one.numpy()
    L = batch.lengths.astype(np.int64)
    stop = plain[-1, 4] if early_stop else np.zeros(lanes, np.int64)
    # the pair steps each lane ran: to its stop or past its read's end
    ran = (np.where(stop > 0, stop // 2, np.minimum((L + 1) // 2, W2))
           if early_stop else np.full(lanes, W2))
    if early_stop:  # lanes of one and two pair steps
        assert {1, 2} <= set(ran.tolist())
    for split in splits_of(W2, W2 // 2):
        lo = 0 if split is None else split
        jst = (st0 if split is None else
               [torch.from_numpy(plain[split - 1, k]).to(s.dtype)
                for k, s in enumerate(st0)])
        jcore, jml, jcid, jstop = jax_color(jci, codes[lo:], jst, 2 * lo,
                                            lens)
        live = (np.arange(2 * lo, 2 * W2)[:, None] // 2) < ran[None, :]
        assert np.array_equal(np.where(live, jml, 0), ml_np[2 * lo:])
        assert np.array_equal(np.where(live, jcid, 0), cid_np[2 * lo:])
        if early_stop:
            assert np.array_equal(jstop, stop > 0)
            full = ran >= W2  # lanes live to the last pair step
            assert np.array_equal(jcore[:, full], plain[-1][:3][:, full])
        else:
            assert np.array_equal(jcore, plain[-1, :3])
    rec = records.numpy()
    Ls = L.tolist() if early_stop else [None] * lanes
    checks = {1: 0, 2: 0}
    for i in range(lanes):
        c = codes[:, i].numpy()
        short_scans(rec, s2, pd, c, plain, st0, i, Ls[i], True)
        for split in splits_of(W2, int(ran[i]) // 2):
            trail, events = lane_trail(rec, s2, pd, c, plain, st0, i, split,
                                       Ls[i], True)
            assert [s[0] for s in trail] == list(range(int(ran[i]))), \
                (i, split)
            for t, idx, off, m, csum, stp, ml1, ml2, c1, c2, chk in trail:
                got = [idx, off, m] + ([csum, stp] if early_stop else [])
                assert got == plain[t, :, i].tolist(), (i, split, t)
                assert [ml1, ml2] == ml_np[2 * t:2 * t + 2, i].tolist()
                assert [c1, c2] == cid_np[2 * t:2 * t + 2, i].tolist()
                if chk and split is None:
                    checks[chk] += 1
            check_order(events, int(ran[i]), True)
    if early_stop:
        assert checks[1] > 0 and checks[2] > 0, checks
