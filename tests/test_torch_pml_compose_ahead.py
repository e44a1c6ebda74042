"""Kernel 1 (the one-step PML scan) takes its codes off the chain, and
kernel 2 (the paired compose, both forms) composes tiles of runs: lane by
lane transliterations of movi_tpu_torch/csrc/fused_pml.cu
fused_pml_scan_kernel and of csrc/compose2.cu compose_paired_kernel.

Kernel 1: every code is loaded two steps before the step whose record it
addresses (the launch's prologue loads the first two), each step's record
is issued at the end of the step before, and ml is stored after that
issue.  Its ml and state equal fused_pml_scan_plain's and JAX
_fused_pml_scan_carry's after every step, in one pass and split inside
the ring.  Kernel 2: each block takes a tile of T consecutive runs,
thread a1 * T + j its run j at a1 (so a warp takes 32 consecutive runs at
one a1); every (run, a1, a2) is composed exactly once at its run-major
row, both destination rows are loaded before any is used, and the table
and the B range (one atomic pair a block) equal compose_records_plain's
and JAX compose_records', in the 4-word and the 8-word color forms.
Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused as jf
from movi_tpu.engine import fused2 as jf2
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused2 as tf2
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import ACGT, mixed_reads, small_index

RING = 2  # kernel 1 loads each code this many steps ahead
INT_MAX, INT_MIN = 2 ** 31 - 1, -2 ** 31
BIAS = 4096


def decode1(row):
    """A one-step record's fields (records.cuh decode1)."""
    m, w1 = int(row[0]), int(row[1])
    return dict(m=m, fa=w1 & 0xFFF, fb=(w1 >> 12) & 0xFFF,
                bump=(w1 >> 24) & 1, match=(w1 >> 25) & 1,
                use_lf=(w1 >> 26) & 1, d_up=(w1 >> 27) & 1,
                d_dn=(w1 >> 28) & 1)


def step1(f, off, pd):
    """records.cuh step1: the next (idx, off), and whether it went to P$."""
    if f["use_lf"]:
        off0 = f["fa"] + off
        ff = int(off0 >= f["fb"])
        return f["m"] + ff, off0 - ff * f["fb"], False
    if off >= f["fb"]:
        if f["d_dn"]:
            return pd[0], pd[1], True
        return f["m"] + f["bump"], 0 if f["bump"] else f["fa"] + 1, False
    if f["d_up"]:
        return pd[0], pd[1], True
    return f["m"], f["fa"], False


def clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


# ---- kernel 1: the scan with its codes two steps ahead


def pml_lane(rec, slots, pd, codes, st, events):
    """One thread of kernel 1 over a lane's codes (one per step) from the
    state st (idx, off, m): yields (t, idx, off, m, to P$) after each
    step.  It asserts that each code was loaded RING steps before the
    step whose record it addresses (the prologue loads the first two) and
    that each step's record is the one its state and code address, issued
    at the end of the step before (the prologue issues the first).
    events gets ("issue", t) and ("store", t) in program order."""
    W = len(codes)
    idx, off, m = st
    if W == 0:
        return
    loaded = {0: "prologue"}
    row = idx * slots + int(codes[0])
    issued_at = -1
    events.append(("issue", 0))
    if W > 1:
        loaded[1] = "prologue"
    a_next = int(codes[1]) if W > 1 else 0
    for t in range(W):
        assert loaded[t] == "prologue" or loaded[t] <= t - RING, (t, loaded)
        assert issued_at == t - 1
        assert row == idx * slots + int(codes[t])
        if t + 2 < W:
            loaded[t + 2] = t
            a_after = int(codes[t + 2])
        else:
            a_after = 0
        f = decode1(rec[row])
        idx, off, dollar = step1(f, off, pd)
        m = m + 1 if f["match"] else 0
        if t + 1 < W:
            assert a_next == int(codes[t + 1])
            row, issued_at = idx * slots + a_next, t
            events.append(("issue", t + 1))
        events.append(("store", t))
        a_next = a_after
        yield t, idx, off, m, dollar


def dollar_reads(text, fi, count=3, L=40, tries=20000, seed=0):
    """Reads of L bases from the text with 15% substitutions that pass
    through a reposition to P$ (found with a numpy scan of `tries`)."""
    rng = np.random.default_rng(seed)
    rec = fi.records.numpy().astype(np.int64)
    slots = fi.sigma + 1
    starts = rng.integers(0, len(text) - L, tries)
    seqs = np.stack([text[s:s + L] for s in starts])
    seqs = np.where(rng.random(seqs.shape) < 0.15,
                    rng.choice(ACGT, size=seqs.shape), seqs)
    codes = fi.alphamap_query[seqs[:, ::-1]].T.astype(np.int64)
    idx = np.full(tries, fi.start_idx, np.int64)
    off = np.full(tries, fi.start_offset, np.int64)
    hit = np.zeros(tries, bool)
    pd_run, pd_off = fi.p_dollar
    for t in range(L):
        row = rec[idx * slots + codes[t]]
        m, w1 = row[:, 0], row[:, 1]
        fa, fb = w1 & 0xFFF, (w1 >> 12) & 0xFFF
        lf, bump = (w1 >> 26) & 1, (w1 >> 24) & 1
        d_up, d_dn = (w1 >> 27) & 1, (w1 >> 28) & 1
        down = off >= fb
        hit |= (lf == 0) & np.where(down, d_dn == 1, d_up == 1)
        off0 = fa + off
        ff = (off0 >= fb).astype(np.int64)
        idx, off = (np.where(lf == 1, m + ff, np.where(
                        down, np.where(d_dn == 1, pd_run, m + bump),
                        np.where(d_up == 1, pd_run, m))),
                    np.where(lf == 1, off0 - ff * fb, np.where(
                        down, np.where(d_dn == 1, pd_off,
                                       np.where(bump == 1, 0, fa + 1)),
                        np.where(d_up == 1, pd_off, fa))))
    pick = np.nonzero(hit)[0][:count]
    assert len(pick) == count
    return [(f"d{i}", seqs[i].tobytes()) for i in pick]


@pytest.fixture(scope="module")
def pml_setup():
    text, ix = small_index()
    tfi = tf.build_fused_index(ix)
    reads = (mixed_reads(text, count=20) + dollar_reads(text, tfi)
             + [("w1", b"A"), ("w2", b"CN"), ("w3", b"GNT"),
                ("n", b"NNNNACGT")])
    return ix, tfi, jf.build_fused_index(ix), reads


def codes_of(fi, reads):
    batch = next(make_batches(reads, lanes=len(reads)))
    return tf.FusedPMLEngine(fi, "cpu").prepare(batch)  # uint8 [W, lanes]


@pytest.mark.parametrize("width", [1, 2, RING + 1, None])
def test_pml_codes_ahead_and_equals_plain(pml_setup, width):
    """Kernel 1's loop, lane by lane, over the batch's first `width`
    steps (None: all): each code loaded RING steps ahead, each record
    issued at the end of the step before and ml stored after it; the
    state and ml after every step equal the plain scan's run one step a
    call, and JAX's _fused_pml_scan_carry's, in one pass and split at
    steps 1 and 2 (inside the ring) and at the middle."""
    ix, tfi, jfi, reads = pml_setup
    codes_t = codes_of(tfi, reads)
    if width is not None:
        codes_t = codes_t[:width].contiguous()
    W, lanes = codes_t.shape
    rec = tfi.records.numpy()
    slots, pd = tfi.sigma + 1, tfi.p_dollar
    st0 = tf.initial_state(tfi, lanes, "cpu")
    # the plain state after every step, one step a call
    states, st = [], st0
    for t in range(W):
        st, _ = tf.fused_pml_scan_plain(tfi.records, slots, pd,
                                        codes_t[t:t + 1], st)
        states.append(torch.stack(st))
    plain = torch.stack(states).numpy()  # [W, 3, lanes]
    st_one, ml_one = tf.fused_pml_scan_plain(tfi.records, slots, pd,
                                             codes_t, st0)
    assert np.array_equal(torch.stack(st_one).numpy(), plain[-1])
    assert np.array_equal(ml_one.numpy(), plain[:, 2])
    # JAX: one pass, and the same split points
    jst0 = tuple(jnp.asarray(s.numpy()) for s in st0)
    jcodes = jnp.asarray(codes_t.numpy())
    jst, jml = jf._fused_pml_scan_carry(jfi, jcodes, jst0)
    assert np.array_equal(np.asarray(jml), ml_one.numpy())
    assert np.array_equal(np.stack([np.asarray(s) for s in jst]),
                          plain[-1])
    dollars = 0
    for i in range(lanes):
        mid = max(int(W) // 2, 3)
        for split in (None, 1, 2, mid):
            if split is not None and split >= W:
                continue
            c = codes_t[:, i].numpy()
            events = []
            trail = list(pml_lane(rec, slots, pd, c,
                                  [int(s[i]) for s in st0], events))
            if split is not None:
                st_mid = [int(v) for v in plain[split - 1, :, i]]
                trail = [s for s in trail if s[0] < split] + [
                    (t + split, *rest) for t, *rest in
                    pml_lane(rec, slots, pd, c[split:], st_mid, [])]
                # JAX from the plain state at the split
                jmid = tuple(jnp.asarray(plain[split - 1, k])
                             for k in range(3))
                jst2, jml2 = jf._fused_pml_scan_carry(jfi, jcodes[split:],
                                                      jmid)
                assert np.array_equal(np.asarray(jml2)[:, i],
                                      ml_one.numpy()[split:, i])
                assert [int(np.asarray(s)[i]) for s in jst2] == \
                    plain[-1, :, i].tolist()
            assert [s[0] for s in trail] == list(range(W))
            for t, idx, off, m, dollar in trail:
                assert [idx, off, m] == plain[t, :, i].tolist(), \
                    (i, split, t)
                dollars += dollar and split is None
            # the next record is issued before this step's ml is stored
            for t in range(W - 1):
                assert events.index(("issue", t + 1)) < \
                    events.index(("store", t))
    if width is None:
        assert dollars >= 3  # the dollar reads reposition to P$


# ---- kernel 2: tiles of runs


TILE = 32                     # compose2.cu kTileRuns
SMEM_BYTES = 44 * 1024        # compose2.cu kSmemBytes
AHEAD = 8                     # compose2.cu kAhead


def tile_runs(slots, color):
    """compose2.cu tile_runs: the runs of a tile, halved until its output
    records and one-step rows fit SMEM_BYTES and its threads a block."""
    per_run = slots * slots * 16 * (2 if color else 1) + slots * 8
    t = TILE
    while t > 1 and (t * per_run > SMEM_BYTES or t * slots > 1024):
        t >>= 1
    return t


def descriptor(g, r, pd, slope, c_b, y_b):
    """compose2.cu descriptor: (A, B, C, kind, flags, ca, cb)."""
    lf2 = slope and g["use_lf"]
    mis2 = slope and not g["use_lf"]
    if lf2:
        A, B, C, kind, flags = g["m"], c_b + g["fa"], g["fb"], 0, g["match"]
        ca = clamp(g["m"], 0, r - 1)
        cb = ca + 1
    elif mis2:
        A, C, kind = g["m"], g["fa"], 1
        B = clamp(g["fb"] - c_b, -BIAS, BIAS - 1)
        flags = g["bump"] | (g["d_up"] << 1) | (g["d_dn"] << 2)
        ca = pd[0] if g["d_up"] else g["m"]
        cb = pd[0] if g["d_dn"] else g["m"] + g["bump"]
    else:
        j, off, _ = step1(g, y_b, pd)
        A, B, C, kind = j, 0, off, 2
        flags = g["match"] if g["use_lf"] else 0
        ca = cb = j
    return clamp(A, 0, r - 1), B, C, kind, flags, ca, cb


def i32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def pack(T1, match1, lo, hi):
    """compose2.cu pack4: the first four words."""
    w0 = ((T1 + BIAS) | (match1 << 13) | ((lo[0] >> 16) << 14)
          | ((hi[0] >> 16) << 23))
    w1 = (lo[1] + BIAS) | (lo[2] << 13) | (lo[3] << 25) | (lo[4] << 27)
    w2 = (hi[1] + BIAS) | (hi[2] << 13) | (hi[3] << 25) | (hi[4] << 27)
    w3 = (lo[0] & 0xFFFF) | ((hi[0] & 0xFFFF) << 16)
    return [i32(w) for w in (w0, w1, w2, w3)]


def compose_tiles(rec, cids, r, slots, pd):
    """compose_paired_kernel over its grid, block by block and thread by
    thread (thread a1 * tile + j: run j at a1): the table (4 or 8 words a
    record), the B range from one atomic pair a block, and how often each
    (run, a1, a2) was composed."""
    color = cids is not None
    nw = 8 if color else 4
    s2 = slots * slots
    tile = tile_runs(slots, color)
    block = (tile * slots + 31) // 32 * 32
    assert block <= 1024
    out = np.zeros((r * s2, nw), np.int64)
    composed = np.zeros((r, slots, slots), np.int64)
    bmin, bmax = INT_MAX, INT_MIN

    def cid(run):
        return int(cids[clamp(run, 0, r - 1)])

    for b in range((r + tile - 1) // tile):
        run0 = b * tile
        nrun = min(tile, r - run0)
        rows = rec[run0 * slots:(run0 + nrun) * slots]  # coalesced
        smem = np.zeros((tile * s2, nw), np.int64)
        lo_b, hi_b = [INT_MAX] * block, [INT_MIN] * block
        warp_a1 = {}
        for k in range(block):
            a1, j = k // tile, k % tile
            if a1 < slots and j < nrun:
                # a warp's threads take consecutive runs at one a1
                warp_a1.setdefault(k // 32, set()).add(a1)
                f = decode1(rows[j * slots + a1])
                use_lf = bool(f["use_lf"])
                T1 = clamp(f["fb"] - f["fa"] if use_lf else f["fb"],
                           -BIAS, BIAS - 1)
                i_up = pd[0] if f["d_up"] else f["m"]
                y_up = pd[1] if f["d_up"] else f["fa"]
                i_dn = pd[0] if f["d_dn"] else f["m"] + f["bump"]
                y_dn = pd[1] if f["d_dn"] else (0 if f["bump"]
                                                 else f["fa"] + 1)
                i_lo = f["m"] if use_lf else i_up
                i_hi = f["m"] + 1 if use_lf else i_dn
                c_lo, y_lo = (f["fa"], 0) if use_lf else (0, y_up)
                c_hi, y_hi = (f["fa"] - f["fb"], 0) if use_lf else (0, y_dn)
                lo_row = clamp(i_lo, 0, r - 1) * slots
                hi_row = clamp(i_hi, 0, r - 1) * slots
                for c0 in range(0, slots, AHEAD):
                    ks = range(c0, min(c0 + AHEAD, slots))
                    # every load of the chunk before any use
                    glo = {a2: rec[lo_row + a2] for a2 in ks}
                    ghi = {a2: rec[hi_row + a2] for a2 in ks}
                    for a2 in ks:
                        lo = descriptor(decode1(glo[a2]), r, pd, use_lf,
                                        c_lo, y_lo)
                        hi = descriptor(decode1(ghi[a2]), r, pd, use_lf,
                                        c_hi, y_hi)
                        lo_b[k] = min(lo_b[k], lo[1], hi[1])
                        hi_b[k] = max(hi_b[k], lo[1], hi[1])
                        words = pack(T1, f["match"], lo, hi)
                        if color:
                            words += [
                                i32(cid(i_lo) | (cid(i_hi) << 16)),
                                i32(cid(lo[5]) | (cid(lo[6]) << 16)),
                                i32(cid(hi[5]) | (cid(hi[6]) << 16)), 0]
                        row = (j * slots + a1) * slots + a2
                        assert run0 * s2 + row == \
                            (run0 + j) * s2 + a1 * slots + a2
                        smem[row] = words
                        composed[run0 + j, a1, a2] += 1
        if tile % 32 == 0:
            assert all(len(v) == 1 for v in warp_a1.values())
        # the tile is contiguous in the table
        out[run0 * s2:(run0 + nrun) * s2] = smem[:nrun * s2]
        # one atomicMin and one atomicMax a block
        bmin, bmax = min(bmin, min(lo_b)), max(bmax, max(hi_b))
    return out.astype(np.int32), (bmin, bmax), composed


def test_tile_shapes():
    """DNA's five slots take the full tile in both forms within the
    shared-memory budget; larger alphabets halve the tile."""
    for slots in (5, 6):
        assert tile_runs(slots, False) == tile_runs(slots, True) == TILE
    assert tile_runs(7, True) == TILE // 2
    for slots in range(1, 30):
        for color in (False, True):
            t = tile_runs(slots, color)
            per_run = slots * slots * 16 * (2 if color else 1) + slots * 8
            assert t * per_run <= SMEM_BYTES and t * slots <= 1024
            assert t == TILE or 2 * t * per_run > SMEM_BYTES


@pytest.fixture(scope="module")
def compose_setup():
    text, ix = small_index()
    tfi = tf.build_fused_index(ix)
    cids = np.random.default_rng(8).integers(0, 0xFFFF, size=tfi.r)
    return tfi, jf.build_fused_index(ix), cids.astype(np.int32)


@pytest.mark.parametrize("color", [False, True])
@pytest.mark.parametrize("which", ["1", "2", "T-1", "T", "T+1", "all"])
def test_compose_tiles_equal_plain(compose_setup, color, which):
    """The tile mapping on the first r runs (r = 1, 2, T-1, T, T+1, and
    the whole index, whose last tile is ragged): each record composed
    once at its run-major row; the table equals compose_records_plain's
    and JAX compose_records' byte for byte, and the block-wise B range
    the plain version's."""
    tfi, jfi, cids_all = compose_setup
    slots, pd = tfi.sigma + 1, tfi.p_dollar
    T = tile_runs(slots, color)
    r = {"1": 1, "2": 2, "T-1": T - 1, "T": T, "T+1": T + 1,
         "all": tfi.r}[which]
    if which == "all":
        assert r % T != 0  # a ragged last tile
    rec_t = tfi.records[:r * slots].contiguous()
    cids = cids_all[:r] if color else None
    got, got_b, composed = compose_tiles(rec_t.numpy(), cids, r, slots, pd)
    assert (composed == 1).all()
    want, want_b = tf2.compose_records_plain(
        rec_t, r, slots, pd, None if cids is None else torch.from_numpy(cids))
    assert got_b == want_b
    assert np.array_equal(got, want.numpy())
    # op by op: one compile per r would take seconds each
    with jax.disable_jit():
        jwant, jb = jf2.compose_records(
            jnp.asarray(np.asarray(jfi.records)[:r * slots]), r=r,
            slots=slots, p_dollar=pd,
            cids=None if cids is None else jnp.asarray(cids), chunk_runs=r)
    assert jb == want_b
    assert np.array_equal(np.asarray(jwant), got)
    if color:
        assert int((got[:, 5] < 0).sum()) > 0 or r < T  # bit 31 in use
