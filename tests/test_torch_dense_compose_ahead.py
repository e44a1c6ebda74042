"""Kernel 14 (the dense PML scan) takes its codes off the chain, and kernel
7's compose (the paired search records) composes tiles of runs: lane by
lane transliterations of movi_tpu_torch/csrc/dense_pml.cu
dense_pml_scan_kernel and of csrc/compose_search2.cu
compose_search2_kernel.

Kernel 14: every code is loaded two steps before the step whose row it
addresses, from a clamped address (the launch's prologue loads the first
two; in the last two steps a step loads its own code, never used); each
step's row is issued at the end of the step before (the prologue issues
the first; after a lane's last step the lane's own row once more, never
used), and ml is stored after that issue.  Its ml and state equal
dense_pml_scan_plain's after every step, in one pass and split at steps
1, 2 and the middle, and JAX _dense_pml_scan's ml, on widths 0, 1, 2 and
odd, reads with N, '#' and other bytes (slot sigma), batches of fewer
and more lanes than a warp.  Kernel 7's compose: each block takes a tile
of consecutive runs in one direction, thread (a1, j) run j of the tile
at a1; step 1 is evaluated once a (run, a1), each level of a group's
step-2 loads is issued before any is used (a group's destinations at the
end of the group before, the first group's before step 1's C is
used), every record is staged once
at its run-major row of a swizzled shared tile, and the tile goes out
with 16 B stores at 16 B boundaries and 8 B stores only for a half-filled
first or last piece.  The table equals compose_search2_plain's and JAX
compose_search2's (chunked) on r = 1, 2, T-1, T, T+1 and whole indexes
with a ragged last tile, on DNA and on a three-letter index whose
r * sigma^2 is odd (an up slab that starts 8 B past a 16 B boundary),
with the table 16 B or only 8 B aligned.  Every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import dense as jd
from movi_tpu.engine import fused_search2 as js2
from movi_tpu_torch.engine import dense as td
from movi_tpu_torch.engine import fused_search2 as ts2
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.testing import mixed_reads, odd_index, small_index

RING = 2  # kernel 14 loads each code this many steps ahead
SMS = 132  # the H100's SMs: spread.cuh's rule


def lanes_per_warp(lanes, sms=SMS):
    """spread.cuh lanes_per_warp."""
    return 1 if lanes <= sms else 32


# ---- kernel 14: the scan with its codes two steps ahead


def dense_lane(table, slots, codes, st, events):
    """One thread of kernel 14 over a lane's codes from the state st (p,
    m): yields (t, p, m) after each step.  It asserts that each code was
    loaded RING steps before the step whose row it addresses (the
    prologue loads the first two) from inside the lane's codes, that
    each step's row is the one its state and code address, issued at the
    end of the step before (the prologue issues the first), and that
    after the lane's last step it issues its own row again.  events gets
    ("issue", t) and ("store", t) in program order."""
    W = len(codes)
    p, m = st
    if W == 0:
        return
    n_rows = len(table)
    loaded = {0: "prologue"}
    row = p * slots + int(codes[0])
    assert 0 <= row < n_rows
    w = int(table[row])
    events.append(("issue", 0))
    issued_at = -1
    at_next = 1 if W > 1 else 0   # a clamped address
    loaded[at_next] = "prologue"
    a_next = int(codes[at_next])
    for t in range(W):
        assert loaded[t] == "prologue" or loaded[t] <= t - RING, (t, loaded)
        assert issued_at == t - 1
        assert row == p * slots + int(codes[t])
        at_after = t + 2 if t + 2 < W else t   # clamped, no select
        assert 0 <= at_after < W
        if t + 2 < W:
            loaded[t + 2] = t
        a_after = int(codes[at_after])
        m = m + 1 if w < 0 else 0
        p = w & 0x7FFFFFFF
        if t + 1 < W:
            assert a_next == int(codes[t + 1])
            row = p * slots + a_next
        else:
            # the lane's own row again, inside the table, never used
            assert row == (row // slots) * slots + int(codes[t])
        assert 0 <= row < n_rows
        w = int(table[row])
        issued_at = t
        events.append(("issue", t + 1))
        events.append(("store", t))
        a_next = a_after
        yield t, p, m


def odd_bytes(reads, every=4):
    """The reads, every `every`-th with a '#' and an 'x' (both slot sigma
    on a regular index), the rest as they are (N's included)."""
    out = []
    for i, (name, seq) in enumerate(reads):
        if i % every == 1 and len(seq) > 3:
            s = bytearray(seq)
            s[0], s[len(s) // 2] = ord("#"), ord("x")
            seq = bytes(s)
        out.append((name, seq))
    return out


@pytest.fixture(scope="module")
def dense_setup():
    text, ix = small_index()
    tdi = td.build_dense_index(ix)
    reads = odd_bytes(mixed_reads(text, seed=6, count=40)) + [
        ("w1", b"A"), ("w2", b"CN"), ("w3", b"G#T"), ("n", b"NNNNACGT")]
    return tdi, jd.build_dense_index(ix), reads


@pytest.mark.parametrize("lanes", [5, 44])
@pytest.mark.parametrize("width", [0, 1, 2, 3, 7, None])
def test_dense_codes_ahead_and_equals_plain(dense_setup, lanes, width):
    """Kernel 14's loop, lane by lane, over the batch's first `width`
    steps (None: all, cut to an odd width): each code loaded RING steps
    ahead from a clamped address, each row issued at the end of the step
    before (after the last step the lane's own row again) and ml stored
    after it; the state and ml after every step equal the plain scan's
    run one step a call, in one pass and split at steps 1, 2 and the
    middle; the port's scan split there equals one pass; JAX
    _dense_pml_scan's ml equals the plain's.  5 lanes run one a warp on
    the card, 44 too (spread.cuh: up to the SM count)."""
    tdi, jdi, reads = dense_setup
    batch = next(make_batches(reads[:lanes], lanes=lanes))
    codes_t = td.DensePMLEngine(tdi, "cpu").prepare(batch)
    if width is None:
        # an odd width, with slot sigma ('#', 'x', N) in it
        width = codes_t.shape[0] - 1 + codes_t.shape[0] % 2
        assert bool((codes_t[:width] == tdi.sigma).any())
    codes_t = codes_t[:width].contiguous()
    W = codes_t.shape[0]
    slots = tdi.sigma + 1
    table = tdi.table.numpy()
    st0 = td.initial_state(tdi, lanes, "cpu")
    # the plain state after every step, one step a call
    states, st = [], st0
    for t in range(W):
        st, _ = td.dense_pml_scan_plain(tdi.table, slots, codes_t[t:t + 1],
                                        st)
        states.append(torch.stack(st))
    plain = (torch.stack(states).numpy() if W
             else np.zeros((0, 2, lanes), np.int32))  # [W, 2, lanes]
    st_one, ml_one = td.dense_pml_scan_plain(tdi.table, slots, codes_t, st0)
    assert np.array_equal(ml_one.numpy(), plain[:, 1])
    if W:
        assert np.array_equal(torch.stack(st_one).numpy(), plain[-1])
    # JAX from the start state (it returns ml only)
    if W:
        jml = jd._dense_pml_scan(jdi, jnp.asarray(
            codes_t.numpy().astype(np.int32)))
        assert np.array_equal(np.asarray(jml), ml_one.numpy())
    mid = max(W // 2, 3)
    for split in (1, 2, mid):
        if split >= W:
            continue
        # the port's scan carried across the split
        s1, m1 = td.dense_pml_scan(tdi.table, slots, codes_t[:split], st0)
        s2, m2 = td.dense_pml_scan(tdi.table, slots, codes_t[split:], s1)
        assert torch.equal(torch.cat([m1, m2]), ml_one)
        assert all(torch.equal(a, b) for a, b in zip(s2, st_one))
    # every lane under the spread rule: carried by one thread exactly
    lpw = lanes_per_warp(lanes)
    assert lpw == 1
    for i in range(lanes):
        c = codes_t[:, i].numpy()
        st_i = [int(s[i]) for s in st0]
        for split in (None, 1, 2, mid):
            if split is not None and split >= W:
                continue
            events = []
            trail = list(dense_lane(table, slots, c, st_i, events))
            if split is not None:
                st_mid = [int(v) for v in plain[split - 1, :, i]]
                trail = [s for s in trail if s[0] < split] + [
                    (t + split, *rest) for t, *rest in
                    dense_lane(table, slots, c[split:], st_mid, [])]
            assert [s[0] for s in trail] == list(range(W))
            for t, p, m in trail:
                assert [p, m] == plain[t, :, i].tolist(), (i, split, t)
            # the next row is issued before this step's ml is stored, the
            # last step's too (the reissue)
            for t in range(W):
                assert events.index(("issue", t + 1)) < \
                    events.index(("store", t))


def test_dense_spread_covers_every_lane():
    """spread.cuh's launch of kernel 14: one lane a warp up to the SM
    count, 32 a warp past it in 256-thread blocks; every lane taken by
    exactly one thread."""
    for lanes in (1, 5, 44, SMS, SMS + 1, 300):
        lpw = lanes_per_warp(lanes)
        block = 256 if lpw == 32 else 32
        per_block = block // 32 * lpw
        grid = (lanes + per_block - 1) // per_block
        seen = []
        for b in range(grid):
            for x in range(block):
                warp, jj = (b * block + x) >> 5, x & 31
                lane = warp * lpw + jj if jj < lpw else -1
                if 0 <= lane < lanes:
                    seen.append(lane)
        assert sorted(seen) == list(range(lanes))
        assert lpw == (1 if lanes <= SMS else 32)


# ---- kernel 7's compose: tiles of runs

GUARD, SENT_HI = 0xFFF, 0x1FFFFFF
TILE = 32              # compose_search2.cu kTileRuns
AHEAD = 1              # compose_search2.cu kAhead
MAX_SIGMA = 6          # compose_search2.cu kMaxSigma
SMEM_BYTES = 48 * 1024  # compose_search2.cu kSmemBytes


def stage_bytes(tile, s2):
    """compose_search2.cu stage_bytes."""
    pieces = (2 + 6 * tile * s2 + 3) // 4
    return (pieces + 7) // 8 * 8 * 16


def swizzle(g):
    return g ^ ((g >> 3) & 7)


def clamp(x, lo, hi):
    return lo if x < lo else (hi if x > hi else x)


def fields_of(up, cur, d, idd, off, n, nid, r):
    """compose_search2.cu fields_of."""
    ex = d < r and cur < r
    keep = d == cur
    A = idd if ex else (0 if up else SENT_HI)
    B = off + (0 if keep or not up else n - 1) if ex else 0
    C = nid if ex and idd < r - 1 else GUARD
    return A, B, C, int(ex and keep)


def i32(x):
    return (int(x) + 2 ** 31) % 2 ** 32 - 2 ** 31


def compose_blocks(id_a, off_a, n_a, nu, nd, r, sigma, base=0):
    """compose_search2_kernel over its grid, block by block and thread by
    thread, writing into a table whose first word sits `base` words past
    a 16 B boundary (0, or 2 for a table only 8 B aligned).  Returns the
    table [2*r*sigma^2, 6], how often each (direction, run, a1)'s step 1
    was evaluated, and the count of 16 B and 8 B stores."""
    tile, block = TILE, TILE * sigma
    s2 = sigma * sigma
    tiles = (r + tile - 1) // tile
    words_all = 2 * r * s2 * 6
    mem = np.zeros(base + words_all, np.int64)
    written = np.zeros(base + words_all, np.int64)
    step1 = np.zeros((2, r, sigma), np.int64)
    stores = {16: 0, 8: 0}
    for b in range(2 * tiles):
        up = b >= tiles
        run0 = (b - tiles if up else b) * tile
        nrun = min(tile, r - run0)
        row0 = (r * s2 if up else 0) + run0 * s2
        dst = base + row0 * 6          # the tile's first word
        shift = dst & 3
        tab = nu if up else nd
        smem = np.zeros(stage_bytes(tile, s2) // 4, np.int64)
        staged_at = np.zeros(len(smem), np.int64)
        warp_a1 = {}
        for x in range(block):
            j = x % tile
            if j >= nrun:
                continue
            run = run0 + j
            a1 = x // tile
            warp_a1.setdefault(x // 32, set()).add(a1)
            d1 = int(tab[a1, run])
            d1c = clamp(d1, 0, r - 1)
            id1 = int(id_a[d1c])
            s1 = fields_of(up, run, d1, id1, int(off_a[d1c]), int(n_a[d1c]),
                           int(n_a[clamp(id1, 0, r - 1)]), r)
            step1[int(up), run, a1] += 1
            cur = (s1[0], s1[0] + 1)
            cc = [clamp(c, 0, r - 1) for c in cur]

            def destinations(c0):
                """Step 2's first level for chars c0 .. c0+AHEAD-1."""
                return {(bb, k): int(tab[k, cc[bb]])
                        for k in range(c0, min(c0 + AHEAD, sigma))
                        for bb in (0, 1)}

            # the first group's before step 1's C is used
            d = destinations(0)
            for c0 in range(0, sigma, AHEAD):
                ks = range(c0, min(c0 + AHEAD, sigma))
                assert sorted(d) == [(bb, k) for bb in (0, 1) for k in ks]
                # each further level's loads before any use
                dc = {key: clamp(v, 0, r - 1) for key, v in d.items()}
                got = {key: (int(id_a[v]), int(off_a[v]), int(n_a[v]))
                       for key, v in dc.items()}
                nid = {key: int(n_a[clamp(v[0], 0, r - 1)])
                       for key, v in got.items()}
                for a2 in ks:
                    lo, hi = (fields_of(up, cur[bb], d[bb, a2],
                                        *got[bb, a2], nid[bb, a2], r)
                              for bb in (0, 1))
                    w = [s1[0] | (s1[3] << 25) | (lo[3] << 26)
                         | (hi[3] << 27), lo[0], hi[0],
                         s1[1] | (s1[2] << 12), lo[1] | (lo[2] << 12),
                         hi[1] | (hi[2] << 12)]
                    rec = (j * sigma + a1) * sigma + a2
                    a = shift + 6 * rec
                    for k in range(0, 6, 2):
                        g = (a + k) >> 2
                        at = swizzle(g) * 4 + ((a + k) & 3)
                        assert (a + k) % 2 == 0
                        smem[at:at + 2] = w[k:k + 2]
                        staged_at[at:at + 2] += 1
                # the next group's destinations
                d = destinations(c0 + AHEAD)
        # a warp takes 32 consecutive runs at one a1
        assert all(len(v) == 1 for v in warp_a1.values())
        words = nrun * s2 * 6
        # every record word staged once
        assert staged_at.sum() == words and staged_at.max() == 1
        pieces = (shift + words + 3) >> 2
        first = dst - shift            # a 16 B boundary
        for g in range(pieces):        # thread g % block
            v = smem[swizzle(g) * 4:swizzle(g) * 4 + 4]
            lo_half = g > 0 or shift == 0
            hi_half = g < pieces - 1 or (shift + words) % 4 == 0
            at = first + 4 * g
            assert at % 4 == 0
            if lo_half and hi_half:
                mem[at:at + 4] = v
                written[at:at + 4] += 1
                stores[16] += 1
            else:
                for half, on in ((0, lo_half), (2, hi_half)):
                    if on:
                        mem[at + half:at + half + 2] = v[half:half + 2]
                        written[at + half:at + half + 2] += 1
                        stores[8] += 1
    assert (written[base:] == 1).all() and not written[:base].any()
    table = np.array([i32(v) for v in mem[base:]], np.int64)
    return table.reshape(-1, 6).astype(np.int32), step1, stores


def compose_inputs(ix, r=None):
    """id/offset/n [r] and nu/nd [sigma, r] of an index, or of its first r
    runs (a valid input of the function as well: ids and destinations at
    or past r are clamped or mean "no run" alike everywhere)."""
    nu, nd = ix.next_tables_search()
    r = ix.r if r is None else r
    return [np.ascontiguousarray(np.asarray(x)[..., :r]).astype(np.int32)
            for x in (ix.id_arr, ix.offset_arr, ix.n_arr, nu, nd)]


@pytest.fixture(scope="module")
def compose_setup():
    return {"dna": small_index()[1], "odd": odd_index()[1]}


def test_compose_launch_shapes():
    """A block takes a 32-run tile, 32 * sigma threads: DNA's 128 threads
    stage 12 KB of records; up to the six chars a pair code holds, no
    tile passes the shared memory a block takes without an opt-in."""
    assert stage_bytes(TILE, 16) >= TILE * 16 * 24 + 8
    for sigma in range(1, MAX_SIGMA + 1):
        assert TILE * sigma % 32 == 0 and TILE * sigma <= 1024
        assert stage_bytes(TILE, sigma * sigma) >= TILE * sigma ** 2 * 24 + 8
        assert stage_bytes(TILE, sigma * sigma) <= SMEM_BYTES


def test_compose_wrapper_rejects_wide_alphabets():
    """The compose's wrapper, like every paired scan's, takes sigma <= 6
    (the chars a pair code holds) and refuses a wider alphabet before it
    looks at the tensors' device."""
    from movi_tpu_torch import kernels

    runs = torch.zeros(3, dtype=torch.int32)
    for sigma in (7, 46):
        nxt = torch.zeros((sigma, 3), dtype=torch.int32)
        with pytest.raises(ValueError, match="pair codes hold sigma <= 6"):
            kernels.compose_search2_records(runs, runs, runs, nxt, nxt, 3,
                                            sigma)


def test_compose_swizzle_spreads_a_warps_rows():
    """The 32 runs of a DNA warp stage their records 96 words apart: the
    swizzle puts each 8 B store of a warp into at most four threads a
    bank pair (32 without it), and permutes the pieces within each group
    of eight (the copy-out's reads stay conflict-free)."""
    sigma, s2 = 4, 16
    for shift in (0, 2):
        for a1 in range(sigma):
            for a2 in range(sigma):
                for k in range(0, 6, 2):
                    banks = {}
                    for j in range(32):
                        a = shift + 6 * ((j * sigma + a1) * sigma + a2) + k
                        word = swizzle(a >> 2) * 4 + (a & 3)
                        banks.setdefault(word % 32, []).append(j)
                        assert (6 * s2 * j) % 32 == 0
                    assert max(len(v) for v in banks.values()) <= 4
    for g0 in range(0, 256, 8):
        assert sorted(swizzle(g) for g in range(g0, g0 + 8)) == \
            list(range(g0, g0 + 8))


@pytest.mark.parametrize("base", [0, 2])
@pytest.mark.parametrize("which", ["1", "2", "T-1", "T", "T+1", "all"])
@pytest.mark.parametrize("index", ["dna", "odd"])
def test_compose_tiles_equal_plain(compose_setup, index, which, base):
    """The tile mapping on the first r runs of an index (r = 1, 2, T-1,
    T, T+1, and the whole index, whose last tile is ragged), into a table
    16 B aligned (base 0) or only 8 B (base 2): step 1 evaluated once a
    (direction, run, a1), every word written once, 8 B stores only for
    half-filled first or last pieces; the table equals
    compose_search2_plain's and JAX compose_search2's (chunks of 7 runs,
    of 97 on the whole index) byte for byte.  The three-letter index has
    r * sigma^2 odd, so its up slab starts 8 B past a 16 B boundary."""
    ix = compose_setup[index]
    sigma = ix.sigma
    T = TILE
    r = {"1": 1, "2": 2, "T-1": T - 1, "T": T, "T+1": T + 1,
         "all": ix.r}[which]
    if which == "all":
        assert r % T != 0  # a ragged last tile
        if index == "odd":
            assert (r * sigma * sigma) % 2 == 1 and sigma == 3
    inputs = compose_inputs(ix, r)
    got, step1, stores = compose_blocks(*inputs, r, sigma, base)
    assert (step1 == 1).all()
    tiles = 2 * ((r + T - 1) // T)
    assert stores[8] <= 2 * tiles
    want = ts2.compose_search2_plain(*[torch.from_numpy(x) for x in inputs],
                                     r, sigma)
    assert np.array_equal(got, want.numpy())
    jin = [jnp.asarray(x) for x in inputs]
    if which == "all":
        # jitted, in ragged chunks of 97 runs (one compile an index)
        jwant = js2.compose_search2(*jin, r=r, sigma=sigma, chunk_runs=97)
    else:
        # op by op: one compile per r would take seconds each
        with jax.disable_jit():
            jwant = js2.compose_search2(*jin, r=r, sigma=sigma,
                                        chunk_runs=min(7, r))
    assert np.array_equal(np.asarray(jwant), got)
    if which == "all" and index == "dna":
        # sentinels (a step with no matching run) and the last run's
        # GUARD are in the table
        w = got.reshape(2, r, sigma, sigma, 6)
        assert (w[0, ..., 1] == SENT_HI).any()
        # step 1 landing on the last run: C1 = GUARD there
        last = (w[..., 0] & 0x1FFFFFF) == r - 1
        assert last.any()
        assert (((w[..., 3] >> 12) & 0xFFF)[last] == GUARD).all()
