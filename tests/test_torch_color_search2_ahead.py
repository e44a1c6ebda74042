"""Kernel 5 (the one-step color scan) and kernel 7 (the paired count and
ZML scans) take their codes off the chain: lane by lane
transliterations of movi_tpu_torch/csrc/fused_color.cu
fused_color_scan_kernel (three-word and two-load forms, each with and
without early stop) and of csrc/fused_search2.cu
fused2_search_scan_kernel (count and ZML).

Every code is loaded two steps before the step whose row it addresses
(the launch's prologue loads the first two), every row is issued at the
end of the step before (the prologue issues the first), and the stores
(and the two-load form's cids gather) follow that issue; kernel 7's ZML
reads its failure outcomes (init_interval of a2, the restart row of a12)
while the rows fly.  The registers and outputs after every step equal
the plain versions' (fused_color_scan_plain, fused2_count_scan_plain,
fused2_zml_scan_plain) run one step a call, in one pass and split at
steps 1, 2 and the middle, and the JAX functions (_fused_color_scan_carry
and _fused_color_scan_carry_es; _count2_init/_count2_carry, _zml2_carry)
agree in one pass and from the same split points.  Every comparison is
exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused_color as jfc
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused_color as tfc
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import (early_stop_reads, length_reads,
                                    mixed_reads, small_color_index,
                                    small_index)

RING = 2  # each code is loaded this many steps ahead


def clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


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


def splits_of(W, mid):
    return [s for s in (None, 1, 2, max(mid, 3)) if s is None or s < W]


# ---- kernel 5: the one-step color scan


def decode1(row):
    """A one-step record's fields (records.cuh decode1)."""
    m, w1 = int(row[0]), int(row[1])
    return dict(m=m, fa=w1 & 0xFFF, fb=(w1 >> 12) & 0xFFF,
                bump=(w1 >> 24) & 1, match=(w1 >> 25) & 1,
                use_lf=(w1 >> 26) & 1, d_up=(w1 >> 27) & 1,
                d_dn=(w1 >> 28) & 1)


def step1(f, off, pd):
    """records.cuh step1: the next (idx, off)."""
    if f["use_lf"]:
        off0 = f["fa"] + off
        ff = int(off0 >= f["fb"])
        return f["m"] + ff, off0 - ff * f["fb"]
    if off >= f["fb"]:
        if f["d_dn"]:
            return pd[0], pd[1]
        return f["m"] + f["bump"], 0 if f["bump"] else f["fa"] + 1
    if f["d_up"]:
        return pd[0], pd[1]
    return f["m"], f["fa"]


def es_hit(csum, t, L):
    """color.cuh es_hit."""
    p1 = L - 2 - t
    return p1 >= 0 and 2 * p1 < L and p1 % 100 == 0 and \
        5 * csum < 2 * (L - p1)


def color_lane(rec, cids, slots, pd, codes, st, L, t0, events):
    """One thread of kernel 5 over a lane's codes (one per step) from the
    state st (idx, off, m, csum, stop): the three-word form when cids is
    None, early stop when L is not None.  Yields (t, idx, off, m, csum,
    stop, ml, cid) after each step it runs.  It asserts that each code was
    loaded RING steps before the step whose row it addresses (the
    prologue loads the first two), that each step's row is the one its
    state and code address, issued at the end of the step before (the
    prologue issues the first), and that the row issued after its last
    step, which never runs, lies inside the table.  events gets
    ("issue", t), ("cids", t) and ("store", t) in program order."""
    W = len(codes)
    idx, off, m, csum, stop = st
    steps = W if L is None else (0 if stop else max(0, min(W, L - t0)))
    if steps == 0:
        return
    loaded = {0: "prologue"}
    row = idx * slots + int(codes[0])
    issued_at = -1
    events.append(("issue", 0))
    if steps > 1:
        loaded[1] = "prologue"
    a_next = int(codes[1]) if steps > 1 else 0
    for t in range(steps):
        assert loaded[t] == "prologue" or loaded[t] <= t - RING, (t, loaded)
        assert issued_at == t - 1
        assert row == idx * slots + int(codes[t])
        if t + 2 < steps:
            loaded[t + 2] = t
            a_after = int(codes[t + 2])
        else:  # this step's own code, never used
            a_after = int(codes[t])
        f = decode1(rec[row])
        hi = f["fa"] + off >= f["fb"] if f["use_lf"] else off >= f["fb"]
        w = int(rec[row][2]) & 0xFFFFFFFF if cids is None else 0
        idx, off = step1(f, off, pd)
        m = m + 1 if f["match"] else 0
        # the next row, issued after the last step too: inside the table
        if t + 1 < steps:
            assert a_next == int(codes[t + 1])
        row, issued_at = idx * slots + a_next, t
        assert 0 <= row < len(rec)
        events.append(("issue", t + 1))
        if cids is None:
            c = (w >> 16) & 0xFFFF if hi else w & 0xFFFF
        else:
            c = int(cids[idx])
            events.append(("cids", t))
        events.append(("store", t))
        a_next = a_after
        if L is not None:
            csum += m
            if es_hit(csum, t0 + t, L):
                stop = t0 + t + 1
                yield t, idx, off, m, csum, stop, m, c
                break
        yield t, idx, off, m, csum, stop, m, c


@pytest.fixture(scope="module")
def color_setup():
    _, ix, ct, reads = small_color_index()
    reads = with_hash(reads + early_stop_reads(reads))
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    jfi = jf.build_fused_index(ix)
    tfi = tf.build_fused_index(ix)
    jci = jfc.build_fused_color_index(ix, ct, fi=jfi)
    tci = tfc.build_fused_color_index(ix, ct, fi=tfi)
    return batch, ct, jci, tci


def color_forms(jci, tci, two_load):
    if not two_load:
        return jci, tci
    return (jfc.FusedColorIndex(fi=jci.fi, doc_set_inds=jci.doc_set_inds,
                                num_colors=jci.num_colors, records3=None),
            tfc.FusedColorIndex(fi=tci.fi, doc_set_inds=tci.doc_set_inds,
                                num_colors=tci.num_colors, records3=None))


def jax_color(jci, codes, st, t0, lens):
    """JAX's carried color scan from the port's state (early stop with
    lens): (core state, ml, cid, stopped or None) as numpy."""
    core = tuple(jnp.asarray(s.numpy()) for s in st[:3])
    jc = jnp.asarray(codes.numpy())
    if lens is None:
        jst, ml, cid = jfc._fused_color_scan_carry(jci, jc, core)
        stopped = None
    else:
        es = (core, jnp.asarray(st[3].numpy().astype(np.int32)),
              jnp.asarray(st[4].numpy() > 0))
        (jst, _, stopped), ml, cid, _ = jfc._fused_color_scan_carry_es(
            jci, jc, t0, jnp.asarray(lens.numpy()), es)
        stopped = np.asarray(stopped)
    return (np.stack([np.asarray(s) for s in jst]), np.asarray(ml),
            np.asarray(cid), stopped)


@pytest.mark.parametrize("early_stop", [False, True])
@pytest.mark.parametrize("two_load", [False, True])
def test_color_codes_ahead_and_equals_plain(color_setup, two_load,
                                            early_stop):
    """Kernel 5's loop, lane by lane: each code loaded two steps ahead,
    each row issued at the end of the step before, the ml and color id
    stores (and the two-load form's cids gather) after that issue; the
    state, ml and color id after every step equal the plain scan's run
    one step a call, in one pass and split at steps 1, 2 and each lane's
    middle, and JAX's carried scan from the same points (with early stop:
    on every row a lane scanned, and its retirement)."""
    batch, ct, jci, tci = color_setup
    jci, tci = color_forms(jci, tci, two_load)
    eng = tfc.FusedColorEngine(tci, ct, "cpu", early_stop=early_stop)
    records, slots, pd, codes, st0, cids, lens = eng.scan_args(batch)
    W, lanes = codes.shape
    rec = records.numpy()
    cids_np = None if cids is None else cids.numpy()
    # the plain state, ml and cid after every step, one step a call
    states, mls, cs, st = [], [], [], st0
    for t in range(W):
        st, ml, c = tfc.fused_color_scan_plain(records, slots, pd,
                                               codes[t:t + 1], st, cids,
                                               lens, t0=t)
        states.append([s.clone() for s in st])
        mls.append(ml[0])
        cs.append(c[0])
    st_one, ml_one, cid_one = tfc.fused_color_scan_plain(
        records, slots, pd, codes, st0, cids, lens)
    assert torch.equal(torch.stack(mls), ml_one)
    assert torch.equal(torch.stack(cs), cid_one)
    for a, b in zip(states[-1], st_one):
        assert torch.equal(a, b)
    plain = np.stack([np.stack([s.numpy().astype(np.int64) for s in sts])
                      for sts in states])  # [W, 3 or 5, lanes]
    ml_np, cid_np = ml_one.numpy(), cid_one.numpy()
    L = batch.lengths.astype(np.int64)
    # the rows each lane scanned: to its stop or its read's end
    scanned = (np.where(plain[-1, 4] > 0, plain[-1, 4], np.minimum(L, W))
               if early_stop else np.full(lanes, W))
    if early_stop:
        assert ((plain[-1, 4] > 0) & (plain[-1, 4] < L)).sum() >= 3
    for split in splits_of(W, W // 2):
        lo = 0 if split is None else split
        jst = (st0 if split is None else
               [torch.from_numpy(plain[split - 1, k]).to(s.dtype)
                for k, s in enumerate(st0)])
        jcore, jml, jcid, jstop = jax_color(jci, codes[lo:], jst, lo, lens)
        live = np.arange(lo, W)[:, None] < scanned[None, :]
        assert np.array_equal(np.where(live, jml, 0), ml_np[lo:])
        assert np.array_equal(np.where(live, jcid, 0), cid_np[lo:])
        if early_stop:
            assert np.array_equal(jstop, plain[-1, 4] > 0)
            ran = scanned >= W  # lanes live to the last row
            assert np.array_equal(jcore[:, ran], plain[-1][:3][:, ran])
        else:
            assert np.array_equal(jcore, plain[-1, :3])
    gathers = 0
    for i in range(lanes):
        c = codes[:, i].numpy()
        Li = int(L[i]) if early_stop else None
        for split in splits_of(W, int(L[i]) // 2):
            events = []
            st_i = [int(s[i]) for s in st0] + ([] if early_stop else [0, 0])
            trail = list(color_lane(rec, cids_np, slots, pd, c, st_i, Li, 0,
                                    events))
            if split is not None:
                mid = [int(v) for v in plain[split - 1, :, i]]
                mid += [] if early_stop else [0, 0]
                trail = [s for s in trail if s[0] < split] + [
                    (t + split, *rest) for t, *rest in
                    color_lane(rec, cids_np, slots, pd, c[split:], mid, Li,
                               split, [])]
            assert [s[0] for s in trail] == list(range(int(scanned[i])))
            for t, idx, off, m, csum, stop, ml, cid in trail:
                got = [idx, off, m] + ([csum, stop] if early_stop else [])
                assert got == plain[t, :, i].tolist(), (i, split, t)
                assert (ml, cid) == (int(ml_np[t, i]), int(cid_np[t, i]))
            # the next row is issued before this step's stores and the
            # two-load form's cids gather
            for t in range(int(scanned[i]) - 1):
                issue = events.index(("issue", t + 1))
                assert issue < events.index(("store", t))
                if two_load:
                    assert issue < events.index(("cids", t)) < \
                        events.index(("store", t))
            gathers += sum(e[0] == "cids" for e in events)
    assert (gathers > 0) == two_load


# ---- kernel 7: the paired count and ZML scans


def micro(A, B, C, u, off_in):
    off0 = B + u * off_in
    ff = int(off0 >= C)
    return A + ff, off0 - ff * C, ff


def decode_dir(w, off_in):
    """search2.cuh decode_dir: (mid run, mid off, fin run, fin off)."""
    w = [int(x) for x in w]
    w0, w3 = w[0], w[3]
    m_run, m_off, ff1 = micro(w0 & 0x1FFFFFF, w3 & 0xFFF, (w3 >> 12) & 0xFFF,
                              (w0 >> 25) & 1, off_in)
    A2 = (w[2] if ff1 else w[1]) & 0x1FFFFFF
    wbc = w[5] if ff1 else w[4]
    u2 = (w0 >> 27) & 1 if ff1 else (w0 >> 26) & 1
    f_run, f_off, _ = micro(A2, wbc & 0xFFF, (wbc >> 12) & 0xFFF, u2, m_off)
    return m_run, m_off, f_run, f_off


def crossed(v):
    return v[0] > v[2] or (v[0] == v[2] and v[1] > v[3])


def pair_code(v, sigma):
    """search2.cuh pair_code: (a2, a12, l1, l2)."""
    a1, a2 = (int(v) >> 3) - 2, (int(v) & 7) - 2
    return a2, max(a1, 0) * sigma + max(a2, 0), a1 >= 0, a2 >= 0


def bs2_rows(r, S2, cur, a12):
    a = clamp(a12, 0, S2 - 1)
    return (clamp(cur[0], 0, r - 1) * S2 + a,
            (r + clamp(cur[2], 0, r - 1)) * S2 + a)


def pair_lane(zml, s2, pairs, st, a0, events):
    """One thread of kernel 7 over a lane's pair codes from the state st
    (cur, x, y), or from the start (st None: nothing matched for ZML, the
    first char a0 for the count).  Yields (t, cur, x, y, ml1, ml2, path)
    after each pair step it runs (path "A", "B" or "init" for ZML).  It
    asserts that each code was loaded RING steps before the step whose
    rows it addresses (the prologue loads the first two) and unpacked the
    step before, that each step's rows are the ones its state and code
    address, issued at the end of the step before (the prologue issues
    the first), that rows issued for a step that never runs lie inside
    the table, and that ZML's failure outcomes are read before the rows
    are decoded.  events gets ("issue", t), ("fail", t), ("decode", t)
    and ("store", t) in program order."""
    r, sigma = s2.r, s2.sigma
    S2 = sigma * sigma
    rec = s2.rec_all.numpy()
    init = s2.init_rec.numpy()
    restart = s2.restart_rec.numpy()
    if st is None:
        if zml:
            cur, x, y = [0, 0, 0, 0], 0, 0
        else:
            cur = [int(v) for v in init[max(a0, 0) + 1]]
            x = int(a0 >= 0)
            y = 1 - x
    else:
        cur, x, y = [int(v) for v in st[:4]], int(st[4]), int(st[5])
    W2 = len(pairs)
    if W2 == 0 or not (zml or not y):
        return
    loaded = {0: "prologue", 1: "prologue"}
    unpacked = {0: "prologue"}
    p = pair_code(pairs[0], sigma)
    v_next = int(pairs[1]) if W2 > 1 else 0
    rows, issued_at = bs2_rows(r, S2, cur, p[1]), -1
    events.append(("issue", 0))
    for t in range(W2):
        if not zml and y:
            break
        assert loaded[t] == "prologue" or loaded[t] <= t - RING, (t, loaded)
        assert unpacked[t] == "prologue" or unpacked[t] == t - 1
        assert p == pair_code(pairs[t], sigma) and issued_at == t - 1
        assert rows == bs2_rows(r, S2, cur, p[1])
        if t + 2 < W2:
            loaded[t + 2] = t
            v_after = int(pairs[t + 2])
        else:  # this step's own code, never used
            v_after = int(pairs[t])
        if t + 1 < W2:
            assert v_next == int(pairs[t + 1])
            unpacked[t + 1] = t
        pn = pair_code(v_next, sigma)
        a2, a12, l1, l2 = p
        if zml:
            rst = [int(v) for v in restart[clamp(a12, 0, S2 - 1)]]
            ini = [int(v) for v in init[max(a2, 0) + 1]]
            events.append(("fail", t))
        events.append(("decode", t))
        mr_s, mo_s, fr_s, fo_s = decode_dir(rec[rows[0]], cur[1])
        mr_e, mo_e, fr_e, fo_e = decode_dir(rec[rows[1]], cur[3])
        mid = [mr_s, mo_s, mr_e, mo_e]
        fin = [fr_s, fo_s, fr_e, fo_e]
        e1 = not l1 or crossed(mid)
        e2 = not l2 or crossed(fin)
        ml1 = ml2 = 0
        path = None
        if zml:
            ok1 = bool(x) and not e1
            ml1 = y + 1 if ok1 else 0
            okA = ok1 and not e2
            okB = not ok1 and l1 and l2 and rst[4] == 0
            cur = fin if okA else (rst[:4] if okB else ini)
            path = "A" if okA else ("B" if okB else "init")
            x = int(okA or okB or l2)
            y = ml2 = ml1 + 1 if okA or okB else 0
        else:
            if not e1:
                cur = mid if e2 else fin
                x += 1 if e2 else 2
            y = int(e1 or e2)
        # the next rows, issued after the last step and once a count lane
        # is done too: inside the table
        rows, issued_at = bs2_rows(r, S2, cur, pn[1]), t
        assert all(0 <= x < len(rec) for x in rows)
        events.append(("issue", t + 1))
        if zml:
            events.append(("store", t))
        p, v_next = pn, v_after
        yield t, list(cur), x, y, ml1, ml2, path


@pytest.fixture(scope="module")
def search2_setup():
    text, ix = small_index()
    reads = with_hash(mixed_reads(text, count=24) + length_reads(
        text, lengths=(1, 2, 3, 4, 5, 160, 161)))
    batch = next(make_batches(reads, lanes=len(reads)))
    s2 = ts2.build_fused_search2_index(ix, "cpu")
    return batch, s2, js2.build_fused_search2_index(ix)


def jax_state(j, keys):
    return np.stack([np.asarray(j[k]).astype(np.int64) for k in keys])


@pytest.mark.parametrize("zml", [True, False])
def test_pair_codes_ahead_and_equals_plain(search2_setup, zml):
    """Kernel 7's loop, lane by lane: each pair code loaded two steps
    ahead and unpacked the step before, each step's rows issued at the
    end of the step before, ZML's failure outcomes read while the rows
    fly and its ml stored after the next issue; the state and ml (ZML)
    after every pair step equal the plain scan's run one step a call, in
    one pass and split at pair steps 1, 2 and each lane's middle, and
    JAX's (_zml2_carry; _count2_init, _count2_carry) from the same
    points.  A count lane stops loading once it is done; the reads hold
    N and '#' (illegal chars), and ZML restarts mid-pair."""
    batch, s2, js = search2_setup
    kind = "zml" if zml else "count"
    if zml:
        pairs = ts2.Fused2ZMLEngine(s2, "cpu").prepare(batch)
        a0 = None
    else:
        a0, pairs = ts2.Fused2CountEngine(s2, "cpu").prepare(batch)
    W2, lanes = pairs.shape
    args = (s2.rec_all, s2.init_rec, s2.restart_rec if zml else s2.all_p,
            s2.r, s2.sigma)
    plain = ts2.fused2_zml_scan_plain if zml else ts2.fused2_count_scan_plain
    kw = {} if zml else {"a0": a0}
    # the plain state after every pair step, one step a call
    st, out = plain(*args, pairs[:1], **kw)
    states, outs = [st], [out]
    for t in range(1, W2):
        st, out = plain(*args, pairs[t:t + 1], st)
        states.append(st)
        outs.append(out)
    st_one, out_one = plain(*args, pairs, **kw)
    assert torch.equal(states[-1], st_one)
    if zml:
        assert torch.equal(torch.cat(outs), out_one)
    else:
        assert torch.equal(outs[-1], out_one)
    plain_np = torch.stack(states).numpy().astype(np.int64)  # [W2, 6, l]
    ml_np = out_one.numpy() if zml else None
    # JAX in one pass and from the split points
    jkeys = (("rs", "os", "re", "oe", "have", "ml") if zml else
             ("rs", "os", "re", "oe", "matched", "done"))
    jp = jnp.asarray(pairs.numpy().astype(np.int32))
    for split in splits_of(W2, W2 // 2):
        lo = 0 if split is None else split
        if split is None:
            jst = (dict(zip(jkeys, [jnp.zeros((lanes,), jnp.int32)] * 4
                            + [jnp.zeros((lanes,), bool),
                               jnp.zeros((lanes,), jnp.int32)]))
                   if zml else js2._count2_init(js, jnp.asarray(a0.numpy())))
        else:
            v = plain_np[split - 1]
            jst = {k: jnp.asarray(v[n].astype(np.int32)) for n, k in
                   enumerate(jkeys)}
            jst[jkeys[4 if zml else 5]] = jnp.asarray(
                v[4 if zml else 5] == 1)
        if zml:
            jst, (ml1, ml2) = js2._zml2_carry(js, jp[lo:], jst)
            jml = np.stack([np.asarray(ml1), np.asarray(ml2)], axis=1)
            assert np.array_equal(jml.reshape(-1, lanes), ml_np[2 * lo:])
        else:
            jst = js2._count2_carry(js, jp[lo:], jst)
        assert np.array_equal(jax_state(jst, jkeys), plain_np[-1])
    paths = {}
    for i in range(lanes):
        c = pairs[:, i].numpy()
        ai = None if zml else int(a0[i])
        for split in splits_of(W2, int(batch.lengths[i]) // 4):
            events = []
            trail = list(pair_lane(zml, s2, c, None, ai, events))
            if split is not None:
                trail = [s for s in trail if s[0] < split] + [
                    (t + split, *rest) for t, *rest in
                    pair_lane(zml, s2, c[split:], plain_np[split - 1, :, i],
                              None, [])]
            for t, cur, x, y, ml1, ml2, path in trail:
                assert cur + [x, y] == plain_np[t, :, i].tolist(), \
                    (kind, i, split, t)
                if zml:
                    assert [ml1, ml2] == ml_np[2 * t:2 * t + 2, i].tolist()
                    paths[path] = paths.get(path, 0) + 1
            # a count lane stops loading once it is done
            done_at = next((t for t in range(W2)
                            if not zml and plain_np[t, 5, i]), None)
            if zml or done_at is None:
                want = W2
            else:
                want = 0 if ai < 0 else done_at + 1
            ran = [s[0] for s in trail]
            assert ran == list(range(want)), (kind, i, split)
            for t in range(len(ran) - 1):
                issue = events.index(("issue", t + 1))
                if zml:
                    assert events.index(("fail", t)) < \
                        events.index(("decode", t)) < issue < \
                        events.index(("store", t))
    if zml:
        assert paths.get("B", 0) > 0 and paths.get("init", 0) > 0
    else:
        assert torch.equal(out_one, ts2.interval_count(s2.all_p, st_one))
