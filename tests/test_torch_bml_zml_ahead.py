"""Kernel 10b (BML) loads ahead, kernel 6 (the one-step count and ZML
scans) takes its chars off the chain, and both spread a batch with few
lanes over the card: lane by lane transliterations of their
software-pipelined loops (movi_tpu_torch/csrc/fused_mem2.cu mem2_kernel,
csrc/fused_search.cu fused_search_scan_kernel) that record what each tick
or step loads ahead, and of the lane-to-warp rule (csrc/spread.cuh).

Every char and fk-mer code a tick uses must have been loaded by the tick
before (or by the launch's prologue), while that tick's rows were in
flight, and every row it uses (a step's two, a RESOLVE's pos2rba rows, an
ftab row) issued at the end of the tick before; a scan step's char is
loaded two steps ahead and its rows issued at the end of the step before.
The transliterations' registers, emissions, outputs and work must equal
the plain versions (mem2_scan_plain, fused_zml_scan_plain,
fused_count_scan_plain) after every tick or step, in one pass and split,
and the JAX machines run one tick or step at a time.  Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu.engine import fused_search as js
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
from movi_tpu_torch.testing import (length_reads, mem_reads, mixed_reads,
                                    rc_index, small_index)

INIT, BACK, RESOLVE, FWD, NEXT, DONE, BSCAN = (
    tm2.INIT, tm2.BACK, tm2.RESOLVE, tm2.FWD, tm2.NEXT, tm2.DONE, tm2.BSCAN)
SPLIT = 41  # the tick a split BML run stops at


def i32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


# ---- kernel 10b: bml_pos, bml_plan, bml_next and the loop


def bml_pos(q, W, L, use_ftab):
    """The two alc indices a tick reads: its char, and an INIT tick's
    fk-mer code (with ftab) or the char its anchored window steps on."""
    phase, pos, jc, end = q
    if phase in (INIT, DONE):
        p = pos + L - 1
    elif phase in (BACK, BSCAN):
        p = pos + L - 2 - jc
    elif phase == NEXT:
        p = end - 1 - jc
    else:
        p = jc
    a = clamp(p, 0, W - 1)
    return a, (W + a if use_ftab else clamp(pos + L - 2, 0, W - 1))


def bml_plan(q, c, cb, m, L, use_ftab, sigma):
    phase, pos, jc, end = q
    P = dict(q=list(q), c=c, code=-1, ftab=False, anchor=False)
    if phase == INIT:
        if pos + L > m:
            P["q"][0] = DONE
        elif c < 0:
            P["q"][1] = pos + L - 1
        elif use_ftab:
            P["ftab"], P["code"] = True, cb
        else:
            P["anchor"] = True
            P["q"][0], P["q"][2] = BACK, 0
    ph = P["q"][0]
    for key, v in (("back", BACK), ("bscan", BSCAN), ("fwd", FWD),
                   ("next", NEXT), ("resolve", RESOLVE)):
        P[key] = ph == v
    craw = cb if P["anchor"] else c
    if P["fwd"]:
        a = sigma - 1 - craw if craw >= 0 else (0 if craw == -1 else -1)
        if jc >= m:
            a = -1
    else:
        a = craw
    active = P["back"] or P["bscan"] or P["fwd"] or P["next"]
    P["a"] = a if active else -1
    P["exhausted"] = P["next"] and jc > end - pos - 2
    return P


def bml_next(P, ok, m, L, fk):
    phase, pos, jc, end = P["q"]
    n = list(P["q"])
    if P["ftab"]:
        if ok:
            n[0] = RESOLVE if fk >= L else BACK
            n[2] = pos + L if fk >= L else fk - 1
        else:
            n[0], n[2] = BSCAN, 0
    elif P["back"] or P["bscan"]:
        if not ok:
            n[0], n[1] = INIT, pos + L - 1 - jc
        elif jc + 1 >= L - 1:
            n[2] = pos + L if P["back"] else jc + 1
            n[0] = RESOLVE if P["back"] else INIT
            n[1] = pos if P["back"] else pos + 1
        else:
            n[2] = jc + 1
    elif P["resolve"]:
        n[0] = FWD
    elif P["fwd"]:
        if ok:
            n[2] = jc + 1
        else:
            n[3] = jc
            if jc >= m:
                n[0] = DONE
            else:
                n[2] = 0
                n[0] = INIT if P["c"] < 0 else NEXT
                if P["c"] < 0:
                    n[1] = jc
    elif P["next"]:
        if ok and not P["exhausted"]:
            n[2] = jc + 1
        else:
            n[0], n[1] = INIT, end - jc
    return tuple(n)


def decode_lf(rec, off_in):
    w2 = int(rec[2]) & 0xFFFFFFFF
    off0 = (w2 >> 16) + off_in
    cum1 = w2 & 0xFFFF
    ff = 1 if off0 >= cum1 else 0
    return (i32(int(rec[1]) + ff), i32(off0 - ff * cum1),
            i32(int(rec[4]) + off0))


def decode_step(lo, hi, r, a, iv):
    rs, os_, re, oe = iv[:4]
    empty = a < 0 or lo[0] >= r or lo[0] > re
    os1 = 0 if lo[0] != rs else os_
    oe1 = int(hi[3]) - 1 if hi[0] != re else oe
    (nrs, nos, nas), (nre, noe, nae) = decode_lf(lo, os1), decode_lf(hi, oe1)
    skip = i32(int(hi[5]) + int(hi[6]) * (oe + 1) - int(lo[5])
               - int(lo[6]) * os_)
    return [nrs, nos, nre, noe, nas, nae], skip, bool(empty)


def bml_lane(rec, init6, r, sigma, n, fk, L, row, use_ftab, regs, ticks):
    """One thread of kernel 10b from the registers regs (16 ints; ENTRY
    builds the start state): yields (registers, emissions {position:
    (ends, counts)}, (ticks, rows, steps)) after each tick, asserting that
    the tick's chars and code and its rows were loaded by the tick before
    (its rows as soon as it was planned, at the end of the tick before)."""
    W = len(row) // 2 if use_ftab else len(row)
    m = int((row[:W] != -2).sum())
    p2r, ftb = 2 * sigma * r, 2 * sigma * r + n
    q, f, rc = tuple(regs[:4]), list(regs[4:10]), list(regs[10:])
    if q[0] == tm2.ENTRY:
        q = (INIT if m >= L else DONE, 0, 0, 0)
        f, rc = [0] * 6, [0] * 6
    emitted = {}

    def init(c):
        return [int(x) for x in init6[max(c, 0) + 1]]

    def chars(q):
        ia, ib = bml_pos(q, W, L, use_ftab)
        return (int(row[ia]), int(row[ib]) if q[0] == INIT else 0), \
            ({ia, ib} if q[0] == INIT else {ia})

    def issue(P):
        """The rows a planned tick loads at once: ("step", a, rs, re, the
        interval it reads), ("res", two pos2rba rows) or ("ftab", code)."""
        if P["a"] >= 0:
            iv = init(P["c"]) if P["anchor"] else (rc if P["fwd"] else f)
            return ("step", P["a"], clamp(iv[0], 0, r - 1),
                    clamp(iv[2], 0, r - 1), tuple(iv[:4]))
        if P["resolve"]:
            return ("res", clamp(rc[4], 0, n - 1),
                    clamp(rc[4] + f[5] - f[4], 0, n - 1))
        if P["code"] >= 0:
            return ("ftab", P["code"])
        return None

    # prologue: the first tick's chars (and code) and rows
    (c, cb), ahead = chars(q)
    P = bml_plan(q, c, cb, m, L, use_ftab, sigma)
    issued = issue(P)
    t = rows = steps = 0
    while t < ticks and q[0] != DONE:
        # what this tick uses was loaded by the tick before
        now, idx = chars(q)
        assert idx <= ahead and (P["c"], P["code"] if P["ftab"] else None) \
            == (now[0], now[1] if P["ftab"] else None)
        assert issued == issue(P)
        # while its rows are in flight: both outcomes' registers and chars
        q0, q1 = bml_next(P, True, m, L, fk), bml_next(P, False, m, L, fk)
        (c0, cb0), a0 = chars(q0)
        (c1, cb1), a1 = chars(q1)
        ahead = a0 | a1
        ini = init(P["c"])
        at, e_end = clamp(P["q"][1], 0, W - 1), P["q"][2]
        e_cnt = i32(rc[5] - rc[4] + 1)
        ok = False
        if P["anchor"]:
            f = init(P["c"])
            rc[4] = init(sigma - 1 - P["c"])[4]
        if issued and issued[0] == "step":
            a = P["a"]
            lo = rec[a * r + issued[2]]
            hi = rec[(sigma + a) * r + issued[3]]
            nxt, skip, empty = decode_step(lo, hi, r, a, issued[4])
            ok = not empty
            rows += 2
            steps += 1
            if ok and (P["back"] or P["bscan"]):
                if P["back"]:
                    rc[4] = i32(rc[4] + skip)
                f = nxt
            elif ok and P["fwd"]:
                rc = nxt
            elif ok and P["next"] and not P["exhausted"]:
                f[:4] = nxt[:4]
        elif issued and issued[0] == "res":
            s_row, e_row = rec[p2r + issued[1]], rec[p2r + issued[2]]
            rc[5] = i32(rc[4] + f[5] - f[4])
            rc[:4] = [int(s_row[0]), i32(rc[4] - int(s_row[1])),
                      int(e_row[0]), i32(rc[5] - int(e_row[1]))]
            rows += 2
        elif P["ftab"]:
            if issued:
                frow = [int(x) for x in rec[ftb + issued[1]]]
                ok = frow[7] == 1
                rows += 1
                if ok:
                    f = frow[:5] + [i32(frow[4] + frow[5] - 1)]
                    rc[4] = frow[6]
        if (P["fwd"] and not ok and P["q"][2] < m) or (P["ftab"] and not ok):
            f[:4] = ini[:4]
        if P["fwd"] and not ok:
            ends, cnts = emitted.get(at, (0, 0))
            emitted[at] = (ends + e_end, i32(cnts + e_cnt))
        q = q0 if ok else q1
        P = bml_plan(q, *((c0, cb0) if ok else (c1, cb1)), m, L, use_ftab,
                     sigma)
        issued = issue(P)
        t += 1
        yield (*q, *f, *rc), dict(emitted), (t, rows, steps)


def run_lanes(lane_gen, state_rows, lanes, ticks):
    """Per lane, the snapshots lane_gen yields after each tick from the
    lane's column of state_rows."""
    return [list(lane_gen(i, [int(state_rows[j][i])
                              for j in range(len(state_rows))], ticks))
            for i in range(lanes)]


def held(trails, t, i):
    """Lane i's snapshot after t ticks (a done lane keeps its last)."""
    return trails[i][min(t, len(trails[i])) - 1]


def check_trail(trails, plain, keys, t0=0):
    """Every lane's registers, ends, counts and work after each tick t >
    t0 equal the plain machine's (plain[t]: (state, work) after t ticks);
    the trails start from plain[t0]'s state."""
    st0, w0 = plain[t0]
    for t in range(t0 + 1, len(plain)):
        st, work = plain[t]
        for i, trail in enumerate(trails):
            if trail:
                regs, emitted, w = held(trails, t - t0, i)
            else:  # done before the launch's first tick
                regs = tuple(int(st0[key][i]) for key in keys)
                emitted, w = {}, (0, 0, 0)
            assert tuple(int(st[key][i]) for key in keys) == regs, (t, i)
            assert [int(work[j][i]) for j in range(3)] == \
                [int(w0[j][i]) + w[j] for j in range(3)], (t, i)
            for j, out in enumerate(("ends", "counts")):
                want = st0[out][i].clone()
                for at, vals in emitted.items():
                    want[at] = i32(int(want[at]) + vals[j])
                assert torch.equal(st[out][i], want), (t, i, out)


def _plain_trail(scan, state, ticks):
    """[(state, work)] after 0, 1, ... ticks of a plain machine, one tick
    a call, until every lane is done."""
    out = [(state, torch.zeros((3, state["phase"].shape[0]),
                               dtype=torch.int32))]
    for _ in range(ticks):
        st, w = scan(out[-1][0], 1)
        out.append((st, out[-1][1] + w))
        if not bool((w[0] > 0).any()):
            break
    return out


@pytest.fixture(scope="module")
def mem_setup():
    """tests/test_torch_mem2.py's index (4,000 bases and their reverse
    complement, seed 7) and reads with N's, '#', and of 1, 3 and 6
    bases."""
    fw, ix = rc_index(4000, 7)
    reads = mem_reads(np.random.default_rng(11), fw, 14, with_n=True,
                      lengths=(20, 70))
    reads += [("short", b"ACG"), ("one", b"A"), ("six", b"ACGTAC"),
              ("allN", b"N" * 12),
              ("hash", fw[300:330].tobytes() + b"#" + fw[331:360].tobytes())]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return fw, ix, reads, batch


@pytest.mark.parametrize("fk,L", [(0, 12), (6, 12), (8, 8)])
def test_bml_loads_ahead_and_equals_plain(mem_setup, fk, L):
    """Kernel 10b's loop, lane by lane: every char, code and row a tick
    uses was loaded the tick before; registers, ends, counts and work
    equal mem2_scan_plain after every tick (the start state built from
    ENTRY too), in one pass and split at SPLIT ticks; each lane's ticks
    equal the JAX machine's run one tick at a time where the read has no
    '#' (ROADMAP §3.6), and the MEMs equal AdvancedEngine's on every read.
    ftab anchors off, inside the window (fk < L), and covering it (fk =
    L); reads shorter than L."""
    fw, ix, reads, batch = mem_setup
    t2 = tm2.build_fused_mem2_index(ix, fk)
    use_ftab = 1 < fk <= L
    assert use_ftab == (fk > 0)
    amap = t2.alphamap_query.copy()
    amap[ord("#")] = -3
    al8 = left_aligned_slots(batch, amap).astype(np.int8)
    alc = tm2.prep_alc(torch.from_numpy(al8), fk if use_ftab else 0)
    assert (al8 == -3).any() and (al8 == -1).any()
    assert (batch.lengths < L).any()
    keys = tm2.MEM2_STATE_KEYS
    lanes = alc.shape[0]
    state = tm2.entry_state(keys, lanes, batch.width, "cpu")
    cap = tm2.bml_tick_cap(batch.width)
    start, _ = tm2.mem2_scan_plain(t2, alc, state, L, 0, use_ftab)
    plain = _plain_trail(
        lambda st, k: tm2.mem2_scan_plain(t2, alc, st, L, k, use_ftab),
        start, cap)
    rec, init6 = t2.rec_all.numpy(), t2.init_rec6.numpy()
    al = alc.numpy()

    def lane(i, regs, ticks):
        return bml_lane(rec, init6, t2.r, t2.sigma, t2.n, t2.ftab_k, L,
                        al[i], use_ftab, regs, ticks)

    # one pass from ENTRY (the kernel builds the start state itself)
    trails = run_lanes(lane, [state[key] for key in keys], lanes, cap)
    assert any(len(tr) > SPLIT for tr in trails)
    check_trail(trails, plain, keys)
    # a split run: a new launch (its own prologue) from the plain state
    # after SPLIT ticks
    st_s = plain[SPLIT][0]
    rest = run_lanes(lane, [st_s[key] for key in keys], lanes, cap)
    check_trail(rest, plain, keys, t0=SPLIT)
    final, work = plain[-1]
    assert bool((final["phase"] == DONE).all())
    # a step loads two rows, RESOLVE two, an ftab anchor one
    assert int(work[2].sum()) > 0 and bool((work[1] > 2 * work[2]).any())
    assert use_ftab == bool(((work[1] - 2 * work[2]) % 2 == 1).any())
    # the MEMs against the oracle, '#' reads too
    oracle = AdvancedEngine(ix, ftab_k=0)
    got = tm2.mem_lists(final["ends"].numpy(), final["counts"].numpy())
    for (name, seq), mems in zip(reads, got):
        assert mems == [tuple(x) for x in oracle.query_mems(seq, L)], name
    # ticks against the JAX machine, run one tick at a time
    j = jm2.build_fused_mem2_index(ix)
    if fk:
        import dataclasses
        j = dataclasses.replace(j, rec_all=jnp.asarray(rec), ftab_k=fk)
    jst = {key: jnp.asarray(v.numpy()) for key, v in start.items()}
    jal = jnp.asarray(al)
    jticks = np.zeros(lanes, dtype=np.int64)
    while True:
        live = np.asarray(jst["phase"]) != DONE
        if not live.any():
            break
        jticks += live
        jst, _ = jm2._mem2_scan(j, jal, jst, L, 1, use_ftab)
    plain_hash = (al8 == -3).any(axis=1)
    assert np.array_equal(work[0].numpy()[~plain_hash], jticks[~plain_hash])


# ---- kernel 6: the scan with its chars two steps ahead


def bs_rows(rec, r, sigma, cur, a):
    a_s = max(a, 0)
    return (a_s * r + clamp(cur[0], 0, r - 1),
            (sigma + a_s) * r + clamp(cur[2], 0, r - 1))


def step_decode(rec, rows, r, cur, a):
    rd, ru = rec[rows[0]], rec[rows[1]]
    empty = a < 0 or rd[0] >= r or rd[0] > cur[2]
    os1 = 0 if rd[0] != cur[0] else cur[1]
    oe1 = int(ru[3]) - 1 if ru[0] != cur[2] else cur[3]

    def lf(v, off):
        z = int(v[2]) & 0xFFFFFFFF
        off0 = (z >> 16) + off
        cum1 = z & 0xFFFF
        ff = 1 if off0 >= cum1 else 0
        return [i32(int(v[1]) + ff), i32(off0 - ff * cum1)]

    return lf(rd, os1) + lf(ru, oe1), bool(empty)


def scan_lane(zml, rec, init_rec, r, sigma, chars, first, st):
    """One thread of kernel 6 over a lane's chars (one per step) from the
    state st (cur, x, y) or from chars[0] (first): yields (step t, cur, x,
    y, out) after each step, asserting that the step's char was loaded two
    steps before (the prologue loads the first two) and its rows issued at
    the end of the step before (the prologue issues the first)."""
    W = len(chars)
    init = lambda a: [int(v) for v in init_rec[max(a, 0) + 1]]  # noqa: E731
    if first:
        a0 = int(chars[0])
        cur, x = init(a0), int(a0 >= 0)
        y = 0 if zml else 1 - x
        t0 = 1
        yield 0, list(cur), x, y, 0
    else:
        cur, x, y = list(st[:4]), st[4], st[5]
        t0 = 0
    if t0 >= W:
        return
    loaded = {t0: "prologue", t0 + 1: "prologue"}
    a, a_next = int(chars[t0]), int(chars[t0 + 1]) if t0 + 1 < W else 0
    rows = bs_rows(rec, r, sigma, cur, a) if zml or not y else None
    issued_at = t0 - 1
    for t in range(t0, W):
        if not zml and y:
            break
        assert loaded[t] == "prologue" or loaded[t] <= t - 2, (t, loaded[t])
        assert a == int(chars[t]) and issued_at == t - 1
        assert rows == bs_rows(rec, r, sigma, cur, a)
        if t + 2 < W:
            loaded[t + 2] = t
            a_after = int(chars[t + 2])
        else:
            a_after = 0
        ini = init(a)
        nxt, empty = step_decode(rec, rows, r, cur, a)
        out = 0
        if zml:
            ext_ok = bool(x) and not empty
            cur = nxt if ext_ok else ini
            y = y + 1 if ext_ok else 0
            x = int(ext_ok or a >= 0)
            out = y if x else 0
        elif empty:
            y = 1
        else:
            cur, x = nxt, x + 1
        if t + 1 < W and (zml or not y):
            rows, issued_at = bs_rows(rec, r, sigma, cur, a_next), t
        a, a_next = a_next, a_after
        yield t, list(cur), x, y, out


@pytest.fixture(scope="module")
def search_setup():
    text, ix = small_index()
    reads = mixed_reads(text, count=24) + length_reads(
        text, lengths=(1, 2, 3, 160))
    batch = next(make_batches(reads, lanes=len(reads)))
    return ix, batch, ts.build_fused_search_index(ix)


@pytest.mark.parametrize("zml", [True, False])
def test_search_chars_ahead_and_equals_plain(search_setup, zml):
    """Kernel 6's loop, lane by lane: each step's char was loaded two
    steps before and its rows issued at the end of the step before; the
    state and ml (ZML) or count after every step equal the plain scan's,
    and JAX's (_zml_carry, _count_carry) run one step at a time, in one
    pass and split at steps inside the ring (1, 2, and each lane's
    middle)."""
    ix, batch, si = search_setup
    chars = ts.search_chars(si.alphamap_query, batch, mark_beyond=not zml)
    chars_t = torch.from_numpy(np.ascontiguousarray(chars.T).astype(np.int8))
    W, lanes = chars_t.shape
    rec, init_rec = si.rec_all.numpy(), si.init_rec.numpy()
    plain = (ts.fused_zml_scan_plain if zml else
             lambda *a: ts.fused_count_scan_plain(a[0], a[1], si.all_p,
                                                  *a[2:]))
    args = (si.rec_all, si.init_rec, si.r, si.sigma)
    # the plain state after every step, one step a call
    st, out0 = plain(*args, chars_t[:1])
    states = [st]
    for t in range(1, W):
        st, _ = plain(*args, chars_t[t:t + 1], st)
        states.append(st)
    st_one, out_one = plain(*args, chars_t)
    assert torch.equal(states[-1], st_one)
    plain_np = torch.stack(states).numpy()  # [W, 6, lanes]
    # JAX one step at a time
    jsi = js.build_fused_search_index(ix)
    jch = jnp.asarray(chars_t.numpy().astype(np.int32))
    jst = (js._zml_init if zml else js._count_init)(jsi, jch[0])
    jkeys = (("rs", "os", "re", "oe", "have", "ml") if zml else
             ("prs", "pos_", "pre", "poe", "matched", "done"))
    jstates = [jst]
    for t in range(1, W):
        jst = (js._zml_carry(jsi, jch[t:t + 1], jst)[0] if zml else
               js._count_carry(jsi, jch[t:t + 1], jst))
        jstates.append(jst)
    jax_np = np.stack([np.stack([np.asarray(j[k]).astype(np.int64)
                                 for k in jkeys]) for j in jstates])

    def lane_trail(i, first, st_in, lo):
        c = chars_t[lo:, i].numpy()
        return list(scan_lane(zml, rec, init_rec, si.r, si.sigma, c, first,
                              None if st_in is None else
                              [int(v) for v in st_in[:, i]]))

    for i in range(lanes):
        mid = max(int(batch.lengths[i]) // 2, 3)
        for split in (None, 1, 2, mid):
            if split is not None and split >= W:
                continue
            trail = lane_trail(i, True, None, 0)
            if split is not None:
                trail = [s for s in trail if s[0] < split] + [
                    (t + split, *rest) for t, *rest in
                    lane_trail(i, False, plain_np[split - 1], split)]
            last = None
            for t, cur, x, y, out in trail:
                assert cur + [x, y] == plain_np[t, :, i].tolist(), \
                    (i, split, t)
                if zml:
                    assert out == int(out_one[t, i]), (i, split, t)
                assert cur + [x, y] == jax_np[t, :, i].tolist(), \
                    (i, split, t)
                last = t
            # a count lane stops loading once its interval is empty
            done_at = next((t for t in range(W)
                            if not zml and plain_np[t, 5, i]), None)
            assert last == (W - 1 if zml or done_at is None else done_at)
    if not zml:
        assert torch.equal(out_one, ts.interval_count(si.all_p, st_one))


# ---- the lane-to-warp rule (csrc/spread.cuh)


def lanes_per_warp(lanes, sms):
    return 1 if lanes <= sms else 32


def spread(lanes, sms, full_block):
    """(lanes a warp, threads a block, blocks) of a launch."""
    lpw = lanes_per_warp(lanes, sms)
    block = full_block if lpw == 32 else 32
    per_block = block // 32 * lpw
    return lpw, block, (lanes + per_block - 1) // per_block


def carried(lanes, sms, full_block):
    """Each launched thread's lane (spread_lane; -1 past its warp's
    lanes or past the batch), the lanes each warp carries, and the
    launch."""
    lpw, block, grid = spread(lanes, sms, full_block)
    tid = np.arange(grid * block)
    warp, j = tid >> 5, (tid % block) & 31
    lane = np.where(j < lpw, warp * lpw + j, -1)
    lane = np.where(lane < lanes, lane, -1)
    per_warp = np.bincount(warp[lane >= 0], minlength=grid * block // 32)
    return lane, per_warp, (lpw, block, grid)


@pytest.mark.parametrize("sms", [1, 132])
@pytest.mark.parametrize("full_block", [128, 256])
def test_lane_to_warp_rule(sms, full_block):
    """For kernel 10b (128 threads a block at 32 lanes a warp) and kernel
    6 (256): every lane is carried exactly once and no warp carries more
    than 32; a batch with no more lanes than the card has SMs runs one
    lane a warp, a larger one 32."""
    for lanes in (1, 31, 63, 64, 65, 8192, 32768):
        lane, per_warp, (lpw, block, grid) = carried(lanes, sms, full_block)
        got = np.sort(lane[lane >= 0])
        assert np.array_equal(got, np.arange(lanes)), lanes
        assert per_warp.max() <= 32 and per_warp.max() == min(lpw, lanes)
        assert lpw == (1 if lanes <= sms else 32)
        assert lpw == 32 or grid == lanes
        assert block == (full_block if lpw == 32 else 32)
    assert spread(64, 132, full_block)[0] == 1
    assert spread(8192, 132, full_block)[0] == 32
    assert spread(32768, 132, full_block)[0] == 32
    # 32 lanes a warp is the unspread launch: lane = thread
    lane, _, (lpw, block, grid) = carried(32768, 132, full_block)
    assert (lpw, block) == (32, full_block)
    assert np.array_equal(lane, np.arange(grid * block))


# ---- the SASS check (tools/sass_inflight.py)

SASS = """
        Function : _ZN12_GLOBAL__N_111mem2_kernelEPKi
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
        /*0020*/                   LDG.E.128.CONSTANT R8, desc[UR6][R2.64+0x10] ;
        /*0030*/                   IADD3 R0, R8, R9, RZ ;
        /*0040*/                   ISETP.NE.AND P0, PT, R4, R0, PT ;
        /*0050*/                   IMAD.MOV.U32 R14, RZ, RZ, 0x1 ;
        /*0060*/                   LDG.E.128.CONSTANT R12, desc[UR6][R2.64] ;
        /*0070*/                   @P0 BRA 0x90 ;
        /*0080*/                   CS2R R6, SRZ ;
        /*0090*/                   @!P0 BRA 0x10 ;
        /*00a0*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_115all_mem2_kernelEPKi
        /*0000*/                   LDG.E.128.CONSTANT R4, desc[UR6][R2.64] ;
        /*0010*/                   MOV R5, RZ ;
"""


def test_inflight_writes_reads_sass():
    """inflight_writes picks the function by its mangled name, finds each
    wide global load's first later touch, falls through forward branches
    and takes a backward one (the loop's next iteration) once."""
    from tools.sass_inflight import inflight_writes

    got = inflight_writes(SASS, "11mem2_kernel")
    assert [(a, a2, kind) for a, _, a2, _, kind in got] == [
        ("0010", "0040", "read"),   # R4 read by the ISETP
        ("0020", "0030", "read"),   # R8, R9 read by the IADD3
        # R12-R15: past the forward branch and the CS2R of R6, back to
        # the loop's top: the IMAD.MOV of R14 writes a register of the
        # load in flight
        ("0060", "0050", "write"),
    ]
    assert inflight_writes(SASS, "15all_mem2_kernel")[0][4] == "write"
