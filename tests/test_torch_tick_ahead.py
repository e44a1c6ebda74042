"""Kernels 9a (k-mer membership) and 10c (all-MEMs) load ahead: a lane by
lane transliteration of their software-pipelined loops
(movi_tpu_torch/csrc/fused_kmer.cu kmer_member_kernel, fused_mem2.cu
all_mem2_kernel) that records what each tick loads ahead.

Every char and fk-mer code a tick uses must have been loaded by the tick
before (or by the launch's prologue), while that tick's rows were in
flight, and every row it uses (a step's, an ftab row, a RES tick's pos2rba
rows) issued at the end of the tick before, as soon as the tick was
planned; and the transliteration's registers,
emissions and work (ticks, rows, step ticks) must equal the plain
machines' (kmer_scan_plain, all_mem2_scan_plain) after every tick, in one
pass and split.  Each lane's ticks are held to the JAX machine's, run one
tick at a time.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.build.prepare_ref import revcomp
from movi_tpu.engine import fused_kmer as jk
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu.engine import fused_search as js
from movi_tpu_torch.engine import fused_kmer as tk
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
from movi_tpu_torch.testing import (ACGT, index_from_text, kmer_reads,
                                    mem_reads, rc_index)

ANCHOR, EXTEND, DONE, PROBE = tk.ANCHOR, tk.EXTEND, tk.DONE, tk.PROBE
RIGHT, LEFT, RES = tm2.AM2_RIGHT, tm2.AM2_LEFT, tm2.AM2_RES
SPLIT = 53  # the tick a split run stops at


def i32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def lf_from_rec(rec, off):
    """search.cuh lf_from_rec: LF and a bounded fast-forward."""
    z = int(rec[2]) & 0xFFFFFFFF
    off0 = (z >> 16) + off
    cum1 = z & 0xFFFF
    ff = 1 if off0 >= cum1 else 0
    return i32(int(rec[1]) + ff), i32(off0 - ff * cum1)


# ---- kernel 9a: kmer_pos, kmer_plan, kmer_finish and the loop


def kmer_pos(q, W):
    phase, pos, cur, pc, _, pinit = q
    if phase == ANCHOR:
        p = pos
    elif phase == PROBE:
        p = pc if pinit == 1 else pc - 1
    else:
        p = cur - 1
    return clamp(p, 0, W - 1)


def kmer_plan(q, c, code, k, step):
    phase, pos, cur, pc, pok, pinit = q
    in_anchor = phase == ANCHOR
    extending, probing = phase == EXTEND, phase == PROBE
    pi = probing and pinit == 1
    pos1 = pos - 1 if in_anchor and c < 0 else pos
    legal = in_anchor and c >= 0 and pos1 >= k - 1
    eligible = step >= 1 and legal and pos1 >= k - 1 + step and pok == 0
    anchored = legal and not eligible
    phase1 = PROBE if eligible else (EXTEND if anchored else phase)
    if phase1 == ANCHOR and pos1 < k - 1:
        phase1 = DONE
    q1 = (phase1, pos1, pos1 if anchored else cur,
          pos1 - step if eligible else pc, 0 if anchored else pok,
          1 if eligible else pinit)
    can_step = extending and q1[2] > 0
    can_pstep = probing and not pi and q1[3] > 0
    code_ok = code >= 0
    return dict(q=q1, c=c, code=code,
                a_gate=c if can_step or can_pstep else -1,
                ftl=(anchored or pi) and code_ok,
                init=(anchored or (pi and c >= 0)) and not code_ok,
                anchored=anchored, pi=pi, extending=extending,
                probing=probing, can_step=can_step, can_pstep=can_pstep)


def kmer_finish(P, e, k, step, fk, W):
    """The next registers and the emission (at, val) for the bit e."""
    phase, pos, cur, pc, pok, pinit = P["q"]
    hit, miss = P["ftl"] and not e, P["ftl"] and e
    if P["anchored"] and hit:
        cur = pos - fk + 1
    if P["anchored"] and miss:
        pos -= 1
        phase = ANCHOR if pos >= k - 1 else DONE
    if P["pi"] and hit:
        pc -= fk - 1
    if P["pi"] and (hit or P["init"]):
        pinit = 0
    pi_fail = (P["pi"] and P["c"] < 0) or (P["pi"] and miss)
    step_ok = P["can_step"] and not e
    pstep_ok = P["can_pstep"] and not e
    cur -= step_ok
    pc -= pstep_ok
    plen = (pos - step) - pc
    probe_end = (P["probing"] and not P["pi"]
                 and (not P["can_pstep"] or e
                      or (pstep_ok and plen > k - step))) or pi_fail
    passed = pos - pc >= k - 1
    if probe_end and passed:
        pok = 1
    if probe_end:
        if not passed:
            pos -= step + 1
        phase = DONE if not passed and pos < k - 1 else ANCHOR
    at = val = 0
    if P["extending"] and not step_ok:
        matched = pos - cur
        emit = matched >= k - 1
        if emit:
            at, val = clamp(cur, 0, W - 1), matched - k + 2
        pos = cur + k - 2 if emit else pos - 1
        phase = ANCHOR if pos >= k - 1 else DONE
    return (phase, pos, cur, pc, pok, pinit), at, val


def kmer_lane(rec, init_rec, r, sigma, fk, row, codes, regs, k, ticks):
    """One thread of kernel 9a from the registers regs (10 ints): yields
    (registers, emissions {position: (added,)}, (ticks, rows, steps)) after
    each tick, asserting that the tick's char, code and rows were loaded
    by the tick before (its step or ftab rows as soon as it was planned,
    at the end of the tick before)."""
    W = len(row)
    use_ftab = codes is not None
    step = k // 3
    ftb = 2 * sigma * r
    q, iv = tuple(regs[:6]), list(regs[6:])
    emitted = {}

    def char_code(p):
        return int(row[p]), int(codes[p]) if use_ftab else -1

    def issue(P):
        """The rows a planned tick loads at once: ("step", a, rs, re) or
        ("ftab", code), or None."""
        if P["a_gate"] >= 0:
            return ("step", P["a_gate"], clamp(iv[0], 0, r - 1),
                    clamp(iv[2], 0, r - 1))
        return ("ftab", P["code"]) if P["ftl"] else None

    # prologue: the first tick's char, code and rows
    p = kmer_pos(q, W)
    P = kmer_plan(q, *char_code(p), k, step)
    chars_ahead = {p}
    issued = issue(P)
    t = rows = steps = 0
    while t < ticks and q[0] != DONE:
        # what this tick uses was loaded by the tick before
        p = kmer_pos(q, W)
        assert p in chars_ahead and (P["c"], P["code"]) == char_code(p)
        assert issued == issue(P)
        # while its rows are in flight: both outcomes' registers, chars and
        # codes
        (q0, at0, v0), (q1, at1, v1) = (kmer_finish(P, e, k, step, fk, W)
                                        for e in (False, True))
        p0, p1 = kmer_pos(q0, W), kmer_pos(q1, W)
        chars_ahead = {p0, p1}
        # the rows' one bit
        e = True
        if P["ftl"]:
            f = rec[ftb + P["code"]]
            e = not (f[0] < f[2] or (f[0] == f[2] and f[1] <= f[3]))
            rows += 1
            if not e:
                iv = [int(x) for x in f]
        elif P["a_gate"] >= 0:
            a = P["a_gate"]
            rd = rec[a * r + clamp(iv[0], 0, r - 1)]
            ru = rec[(sigma + a) * r + clamp(iv[2], 0, r - 1)]
            e = bool(rd[0] >= r or rd[0] > iv[2])
            rows += 2
            steps += 1
            if not e:
                os1 = 0 if rd[0] != iv[0] else iv[1]
                oe1 = int(ru[3]) - 1 if ru[0] != iv[2] else iv[3]
                iv = [*lf_from_rec(rd, os1), *lf_from_rec(ru, oe1)]
        if P["init"]:
            iv = [int(x) for x in init_rec[max(P["c"], 0) + 1]]
        q = q1 if e else q0
        # the next tick, planned from the char and code in registers, and
        # its rows issued
        P = kmer_plan(q, *char_code(p1 if e else p0), k, step)
        issued = issue(P)
        at, val = (at1, v1) if e else (at0, v0)
        if val > 0:
            emitted[at] = (emitted.get(at, (0,))[0] + val,)
        t += 1
        yield (*q, *iv), dict(emitted), (t, rows, steps)


def run_lanes(lane_gen, state_rows, lanes, ticks):
    """Per lane, the snapshots lane_gen yields after each tick from the
    lane's column of state_rows."""
    return [list(lane_gen(i, [int(state_rows[j][i])
                              for j in range(len(state_rows))], ticks))
            for i in range(lanes)]


def held(trails, t, i):
    """Lane i's snapshot after t ticks (a done lane keeps its last)."""
    return trails[i][min(t, len(trails[i])) - 1]


def check_trail(trails, plain, keys, outs, t0=0):
    """Every lane's registers, emitted rows and work after each tick t >
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
            for j, out in enumerate(outs):
                want = st0[out][i].clone()
                for at, vals in emitted.items():
                    want[at] += vals[j]
                assert torch.equal(st[out][i], want), (t, i, out)


# ---- fixtures


@pytest.fixture(scope="module")
def kmer_setup():
    """2,500 random bases and their reverse complement (seed 9), reads
    with N's and '#', reads of 1 and 3 bases, one long read."""
    fw = np.random.default_rng(9).choice(ACGT, size=2500).astype(np.uint8)
    text = np.concatenate([fw, revcomp(fw)])
    reads = kmer_reads(text, seed=5, count=18, long_reads=1)
    reads.append(("hash", text[100:160].tobytes() + b"#"
                  + text[161:220].tobytes()))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return text, index_from_text(text), batch


@pytest.fixture(scope="module")
def mem_setup():
    """tests/test_torch_mem2.py's index (4,000 bases and their reverse
    complement, seed 7), reads with N's and '#', of 1 and 3 bases."""
    fw, ix = rc_index(4000, 7)
    t = tm2.build_fused_mem2_index(ix)
    reads = mem_reads(np.random.default_rng(12), fw, 20, with_n=True,
                      prefix="am", lengths=(25, 200))
    reads += [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12),
              ("hash", fw[300:340].tobytes() + b"#" + fw[341:400].tobytes())]
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    amap = t.alphamap_query.copy()
    amap[ord("#")] = -3
    alc = tm2.prep_alc(torch.from_numpy(
        left_aligned_slots(batch, amap).astype(np.int8)), 0)
    return ix, t, alc, batch


# ---- 9a


def _kmer_inputs(kmer_setup, fk, k):
    _, ix, batch = kmer_setup
    si = ts.build_fused_search_index(ix, ftab_k=fk)
    use_ftab = 1 < fk <= k - k // 3
    al8 = left_aligned_slots(batch, ts.search_alphamap(ix), fill=-1)
    alc = tm2.prep_alc(torch.from_numpy(al8.astype(np.int8)),
                       fk if use_ftab else 0)
    state = tk.make_kmer_state(batch.lanes, batch.width,
                               torch.from_numpy(batch.lengths), k)
    return ix, si, alc, state, use_ftab


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


@pytest.mark.parametrize("fk,k", [(0, 31), (10, 31), (0, 9), (6, 9)])
def test_kmer_loads_ahead_and_equals_plain(kmer_setup, fk, k):
    """Kernel 9a's loop, lane by lane: every char, code and ftab row a
    tick uses was loaded the tick before; registers, emissions and work
    equal kmer_scan_plain after every tick, in one pass and split at
    SPLIT ticks; each lane's ticks equal the JAX machine's."""
    ix, si, alc, state, use_ftab = _kmer_inputs(kmer_setup, fk, k)
    assert use_ftab == (fk > 0)
    W = alc.shape[1] // 2 if use_ftab else alc.shape[1]
    cap = tk.tick_cap(k, W)
    plain = _plain_trail(
        lambda st, n: tk.kmer_scan_plain(si, alc, st, k, n, use_ftab),
        state, cap)
    rec = si.rec_all.numpy()
    init_rec = si.init_rec.numpy()
    al = alc.numpy()
    keys = tk.KMER_STATE_KEYS

    def lane(i, regs, ticks):
        codes = al[i, W:] if use_ftab else None
        return kmer_lane(rec, init_rec, si.r, si.sigma, si.ftab_k,
                         al[i, :W], codes, regs, k, ticks)

    rows0 = [state[key] for key in keys]
    trails = run_lanes(lane, rows0, alc.shape[0], cap)
    assert any(len(tr) > SPLIT for tr in trails)
    check_trail(trails, plain, keys, ("out",))
    # a split run: a new launch (its own prologue) from the plain state
    # after SPLIT ticks
    st_s = plain[SPLIT][0]
    rest = run_lanes(lane, [st_s[key] for key in keys], alc.shape[0], cap)
    check_trail(rest, plain, keys, ("out",), t0=SPLIT)
    # the work rows at the end: a step loads two rows, an ftab anchor one;
    # the ticks are JAX's
    _, work = plain[-1]
    ftab_ticks = work[1] - 2 * work[2]
    assert int(work[2].sum()) > 0 and bool((ftab_ticks >= 0).all())
    assert use_ftab == bool((ftab_ticks > 0).any())
    assert bool((work[2] + ftab_ticks <= work[0]).all())
    jsi = js.build_fused_search_index(ix, ftab_k=fk)
    jst = {key: jnp.asarray(v.numpy()) for key, v in state.items()}
    jalc = jnp.asarray(alc.numpy())
    jticks = np.zeros(alc.shape[0], dtype=np.int64)
    while True:
        live = np.asarray(jst["phase"]) != DONE
        if not live.any():
            break
        jticks += live
        jst, _ = jk._kmer_scan(jsi, jalc, jst, k, 1, use_ftab)
    assert np.array_equal(work[0].numpy(), jticks)
    for key in jst:
        assert np.array_equal(plain[-1][0][key].numpy(),
                              np.asarray(jst[key])), key


# ---- 10c: am_pos, am_plan, am_next and the loop


def am_pos(q, W):
    phase, s, ml, e = q
    return clamp(e - ml if phase == LEFT else s + ml, 0, W - 1)


def am_plan(q, c, m, sigma):
    phase, s, ml, e = q
    a_right = sigma - 1 - c if c >= 0 else (0 if c == -1 else -1)
    if phase == RIGHT:
        a = a_right if s + ml < m else -1
    else:
        a = c if phase == LEFT and e - ml >= 0 else -1
    return dict(a=a, right=phase == RIGHT, left=phase == LEFT,
                res=phase == RES)


def am_next(q, P, ok, m):
    phase, s, ml, e = q
    if P["res"]:
        return (RIGHT, s, ml, e)
    if ok:
        return (phase, s, ml + 1, e)
    if P["left"]:
        return (RES, e - ml + 1, ml, e)
    e2 = s + ml
    return (tm2.AM2_DONE, s, ml, e2) if e2 >= m else (LEFT, s, 1, e2)


def decode_lf(rec, off_in):
    w2 = int(rec[2]) & 0xFFFFFFFF
    off0 = (w2 >> 16) + off_in
    cum1 = w2 & 0xFFFF
    ff = 1 if off0 >= cum1 else 0
    return i32(int(rec[1]) + ff), i32(off0 - ff * cum1), i32(int(rec[4])
                                                            + off0)


def decode_step(lo, hi, r, a, iv):
    rs, os_, re, oe = iv[:4]
    empty = a < 0 or lo[0] >= r or lo[0] > re
    os1 = 0 if lo[0] != rs else os_
    oe1 = int(hi[3]) - 1 if hi[0] != re else oe
    (nrs, nos, nas), (nre, noe, nae) = decode_lf(lo, os1), decode_lf(hi, oe1)
    skip = i32(int(hi[5]) + int(hi[6]) * (oe + 1) - int(lo[5])
               - int(lo[6]) * os_)
    return [nrs, nos, nre, noe, nas, nae], skip, bool(empty)


def init_pair6(init6, sigma, p1, c):
    def init(a):
        return [int(x) for x in init6[max(a, 0) + 1]]

    empty = [1, 0, 0, 0, p1, 0]
    cr = sigma - 1 - c if c >= 0 else (0 if c == -1 else -1)
    return (init(c) if c >= 0 else list(empty),
            init(cr) if cr >= 0 else list(empty))


def all_mem_lane(rec, init6, r, sigma, n, p1, row, regs, ticks):
    """One thread of kernel 10c from the registers regs (16 ints; ENTRY
    builds the start state): yields (registers, emissions {position:
    (ends, counts)}, (ticks, rows, steps)) after each tick, asserting that
    the tick's char and rows were loaded by the tick before (its step or
    pos2rba rows as soon as it was planned, at the end of the tick
    before)."""
    W = len(row)
    m = int((row != -2).sum())
    p2r = 2 * sigma * r
    q, f, rc = tuple(regs[:4]), list(regs[4:10]), list(regs[10:])
    if q[0] == tm2.ENTRY:
        q = (RIGHT if m > 0 else tm2.AM2_DONE, 0, 1, 0)
        f, rc = init_pair6(init6, sigma, p1, int(row[0]))
    emitted = {}

    def issue(P):
        """The rows a planned tick loads at once: a step's two rows of the
        stepped side's interval, or a RES tick's two pos2rba rows."""
        if (P["right"] or P["left"]) and P["a"] >= 0:
            iv = rc if P["right"] else f
            return ("step", P["a"], clamp(iv[0], 0, r - 1),
                    clamp(iv[2], 0, r - 1))
        if P["res"]:
            return ("res", clamp(rc[4], 0, n - 1), clamp(rc[5], 0, n - 1))
        return None

    # prologue: the first tick's char and rows
    c = int(row[am_pos(q, W)])
    chars_ahead = {am_pos(q, W)}
    P = am_plan(q, c, m, sigma)
    issued = issue(P)
    t = rows = steps = 0
    while t < ticks and q[0] != tm2.AM2_DONE:
        # what this tick uses was loaded by the tick before
        assert am_pos(q, W) in chars_ahead and c == int(row[am_pos(q, W)])
        assert issued == issue(P)
        stepping = (P["right"] or P["left"]) and P["a"] >= 0
        # while its rows are in flight: both outcomes' chars and plans (a
        # RES tick's next char is its own)
        q0, q1 = am_next(q, P, True, m), am_next(q, P, False, m)
        c0 = c if P["res"] else int(row[am_pos(q0, W)])
        c1 = c if P["res"] else int(row[am_pos(q1, W)])
        chars_ahead = {am_pos(q0, W), am_pos(q1, W)}
        P0, P1 = am_plan(q0, c0, m, sigma), am_plan(q1, c1, m, sigma)
        ok = False
        if stepping:
            a = P["a"]
            iv = rc if P["right"] else f
            lo = rec[a * r + clamp(iv[0], 0, r - 1)]
            hi = rec[(sigma + a) * r + clamp(iv[2], 0, r - 1)]
            nxt, skip, empty = decode_step(lo, hi, r, a, iv)
            ok = not empty
            rows += 2
            steps += 1
            if ok and P["right"]:
                f[4] = i32(f[4] + skip)
                f[5] = i32(f[4] + nxt[5] - nxt[4])
                rc = nxt
            elif ok:
                rc[4] = i32(rc[4] + skip)
                rc[5] = i32(rc[4] + nxt[5] - nxt[4])
                f = nxt
        elif P["res"]:
            s_row = rec[p2r + clamp(rc[4], 0, n - 1)]
            e_row = rec[p2r + clamp(rc[5], 0, n - 1)]
            rc = [int(s_row[0]), i32(rc[4] - int(s_row[1])), int(e_row[0]),
                  i32(rc[5] - int(e_row[1])), rc[4], rc[5]]
            rows += 2
        emit = P["right"] and not ok
        if emit:
            at = clamp(q[1], 0, W - 1)
            ends, cnts = emitted.get(at, (0, 0))
            emitted[at] = (ends + q[1] + q[2],
                           cnts + max(f[5] - f[4] + 1, 0))
            if q1[0] == LEFT:  # re-anchor at e = s+ml: this tick's char
                f, rc = init_pair6(init6, sigma, p1, c)
        q, P, c = (q0, P0, c0) if ok else (q1, P1, c1)
        issued = issue(P)
        t += 1
        yield (*q, *f, *rc), dict(emitted), (t, rows, steps)


def test_all_mem_loads_ahead_and_equals_plain(mem_setup):
    """Kernel 10c's loop, lane by lane: every char and RES row a tick
    uses was loaded the tick before; registers, ends, counts and work
    equal all_mem2_scan_plain after every tick (the start state built
    from ENTRY too), in one pass and split at SPLIT ticks; each lane's
    ticks equal the JAX machine's where the read has no '#' (ROADMAP
    §3.6)."""
    ix, t2, alc, batch = mem_setup
    lanes, W = alc.shape
    keys = tm2.AM2_STATE_KEYS
    state = tm2.entry_state(keys, lanes, W, "cpu")
    cap = tm2.all_mem2_tick_cap(W)
    start, _ = tm2.all_mem2_scan_plain(t2, alc, state, 0)
    plain = _plain_trail(
        lambda st, n: tm2.all_mem2_scan_plain(t2, alc, st, n), start, cap)
    rec, init6 = t2.rec_all.numpy(), t2.init_rec6.numpy()
    al = alc.numpy()

    def lane(i, regs, ticks):
        return all_mem_lane(rec, init6, t2.r, t2.sigma, t2.n, t2.p1, al[i],
                            regs, ticks)

    # one pass from ENTRY (the kernel builds the start state itself)
    trails = run_lanes(lane, [state[key] for key in keys], lanes, cap)
    assert any(len(tr) > SPLIT for tr in trails)
    check_trail(trails, plain, keys, ("ends", "counts"))
    # a split run: a new launch from the plain state after SPLIT ticks
    st_s = plain[SPLIT][0]
    rest = run_lanes(lane, [st_s[key] for key in keys], lanes, cap)
    check_trail(rest, plain, keys, ("ends", "counts"), t0=SPLIT)
    _, work = plain[-1]
    assert int(work[2].sum()) > 0 and bool((work[1] > 2 * work[2]).any())
    # ticks against the JAX machine, run one tick at a time
    j = jm2.build_fused_mem2_index(ix)
    jst = {key: jnp.asarray(v.numpy()) for key, v in start.items()}
    jal = jnp.asarray(al)
    jticks = np.zeros(lanes, dtype=np.int64)
    while True:
        live = np.asarray(jst["phase"]) != tm2.AM2_DONE
        if not live.any():
            break
        jticks += live
        jst, _ = jm2._all_mem2_scan(j, jal, 1, jst)
    plain_hash = (al == -3).any(axis=1)
    assert plain_hash.any()
    assert np.array_equal(work[0].numpy()[~plain_hash], jticks[~plain_hash])
