"""The row -> run directory of the MEM v1 machines
(movi_tpu_torch/engine/fused_mem.py, csrc/compact.cuh find_run_dir2, kernel
13d) on the CPU: the directory equals find_run (searchsorted - 1) at every
bucket, as built by the plain version and by a lane-by-lane emulation of
kernel 13d; the search through it equals the JAX package's searchsorted
(movi_tpu/engine/fused_mem.py _resolve) on every row and find_run's run 0
below row 0; the shift rule keeps it no larger than all_p; the plain
machines with the directory forced to b = 0, 2, 4 equal the JAX machines
register for register and the JAX engines and AdvancedEngine on the rc
index of tests/test_fused_mem.py ('#' reads and a first run longer than
one row: the oracle, ROADMAP §3.9, §3.10); and each lane's ticks, table
bytes and extensions equal a lane-by-lane emulation of kernels 13b and
13c, which loads what the kernels load.  Every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.engine import fused_mem as jfm
from movi_tpu.io.fastx import make_batches as jax_batches
from movi_tpu_torch.convert import fused_mem_index_from_jax
from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
from movi_tpu_torch.engine import fused_mem as tfm
from movi_tpu_torch.io.fastx import make_batches
from movi_tpu_torch.kernels import run_dir_size
from movi_tpu_torch.testing import mem_reads, random_text, rc_index

SHIFTS = [0, 2, 4]


def _synthetic_all_p(seed):
    """all_p of runs with seeded lengths: single-row runs, one run of
    10^4 rows, and a last run of one row."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 9, size=3000)
    lengths[rng.random(3000) < 0.3] = 1
    lengths[1234] = 10_000
    lengths[-1] = 1
    return np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)


def _find_run(all_p, x):
    """find_run (csrc/compact.cuh): the last run i with all_p[i] <= x,
    0 below row 0."""
    return np.maximum(np.searchsorted(all_p, x, side="right") - 1, 0)


def _kernel_13d(all_p, n, b):
    """Kernel 13d lane by lane: each run writes the buckets whose first
    row falls in it; the last run writes dir[K] = r."""
    r = len(all_p) - 1
    size = run_dir_size(n, b)
    K = size - 1
    out = np.full(size, -7, np.int64)

    def first_bucket_at(x):
        return ((x - 1) >> b) + 1 if x > 0 else 0

    for run in range(r):
        k0 = first_bucket_at(int(all_p[run]))
        k1 = min(first_bucket_at(int(all_p[run + 1])), K)
        out[k0:k1] = run
        if run == r - 1:
            out[K] = r
    return out


@pytest.mark.parametrize("b", range(7))
def test_run_dir_equals_find_run(b):
    """dir[k] = find_run(k << b) for every bucket and dir[K] = r, from the
    plain build and from kernel 13d's per-run writes."""
    all_p = _synthetic_all_p(3)
    n, r = int(all_p[-1]), len(all_p) - 1
    got = tfm.run_dir_plain(torch.from_numpy(all_p), n, b)
    K = ((n - 1) >> b) + 1
    want = np.append(_find_run(all_p, np.arange(K, dtype=np.int64) << b), r)
    assert got.dtype == torch.int32 and got.shape == (K + 1,)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(_kernel_13d(all_p, n, b), want)


@pytest.mark.parametrize("b", list(range(7)) + [None])
def test_resolve_dir_every_row(b):
    """Every row in [-3, n+3] and the int32 extremes: the run equals
    find_run (JAX's searchsorted for rows >= 0, run 0 below), the start
    is all_p[run], and the halvings are those of the row's bucket span,
    at most b + 1."""
    all_p = _synthetic_all_p(4)
    n, r = int(all_p[-1]), len(all_p) - 1
    if b is None:
        b = tfm.run_dir_shift(n, r)
    ap = torch.from_numpy(all_p)
    d = tfm.run_dir_plain(ap, n, b)
    x = np.concatenate([np.arange(-3, n + 4), [-2**31, 2**31 - 1]])
    run, start, halvings = tfm.resolve_dir(
        ap, d, b, torch.from_numpy(x.astype(np.int32)))
    want = _find_run(all_p, x)
    assert np.array_equal(run.numpy(), want)
    assert np.array_equal(start.numpy(), all_p[want])
    inside = (x >= 0) & (x < 2**31 - 1)
    jrun, joff = jfm._resolve(jnp.asarray(all_p), jnp.asarray(x[inside]))
    assert np.array_equal(run.numpy()[inside], np.asarray(jrun))
    assert np.array_equal((x - start.numpy())[inside], np.asarray(joff))
    k = np.clip(x >> b, 0, len(d) - 2)
    span = d.numpy()[k + 1] - d.numpy()[k] + 1
    assert np.array_equal(halvings.numpy(),
                          np.ceil(np.log2(span)).astype(np.int64))
    assert int(halvings.max()) <= b + 1


def test_dir_shift_rule():
    """The rule's directory is no larger than all_p and the smallest such
    b; n == r (every run one row) takes b = 0."""
    cases = [(1, 1), (2, 2), (5, 5), (1000, 1000), (10, 3), (1001, 1000),
             (2**28 - 1, 2**25), (2**31 - 1, 5_000_000), (2**31 - 1, 1),
             (6_000_001, 4_983_313), (123_457, 1024)]
    for n, r in cases:
        b = tfm.run_dir_shift(n, r)
        assert run_dir_size(n, b) <= r + 1, (n, r)
        assert b == 0 or run_dir_size(n, b - 1) > r + 1, (n, r)
    assert tfm.run_dir_shift(777, 777) == 0


@pytest.fixture(scope="module")
def setup():
    """The index of tests/test_fused_mem.py (4,000 random bases from
    default_rng(7) and their reverse complement) and its oracle."""
    fw, ix = rc_index(4000, 7)
    return dict(fw=fw, ix=ix, oracle=AdvancedEngine(ix, ftab_k=0))


def _tables(ix, monkeypatch, b):
    """The JAX table without pos2rba (POS2RUN_MAX_N at 0 in both
    packages) and the port's copy of it with the directory at shift b."""
    monkeypatch.setattr(jfm, "POS2RUN_MAX_N", 0)
    monkeypatch.setattr(tfm, "POS2RUN_MAX_N", 0)
    jmi = jfm.build_fused_mem_index(ix)
    return jmi, tfm.with_run_dir(fused_mem_index_from_jax(jmi), b)


@pytest.mark.parametrize("b", SHIFTS)
def test_built_directory(setup, monkeypatch, b):
    """The port's builder past POS2RUN_MAX_N and the converted JAX
    table: no pos2rba, the directory of the plain build at the rule's
    shift, no larger than all_p; with_run_dir at a forced shift b gives
    that shift's directory."""
    ix = setup["ix"]
    n = int(ix.all_p[-1])

    def want(shift):
        rows = np.arange(((n - 1) >> shift) + 1) << shift
        return np.append(_find_run(ix.all_p, rows), ix.r)

    monkeypatch.setattr(jfm, "POS2RUN_MAX_N", 0)
    monkeypatch.setattr(tfm, "POS2RUN_MAX_N", 0)
    rule = tfm.run_dir_shift(n, ix.r)
    built = tfm.build_fused_mem_index(ix, "cpu")
    conv = fused_mem_index_from_jax(jfm.build_fused_mem_index(ix))
    for t in (built, conv):
        assert t.pos2rba is None and t.dir_shift == rule
        assert np.array_equal(t.run_dir.numpy(), want(rule))
        assert t.run_dir.numel() <= ix.r + 1
        forced = tfm.with_run_dir(t, b)
        assert forced.pos2rba is None and forced.dir_shift == b
        assert np.array_equal(forced.run_dir.numpy(), want(b))


def _reads(fw, seed):
    """Reads with N's and substitutions, the short, one-base and all-N
    reads, and two reads past 512 bases."""
    rng = np.random.default_rng(seed)
    return (mem_reads(rng, fw, 14, with_n=True)
            + [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12)]
            + mem_reads(rng, fw, 2, err=0.03, prefix="L",
                        lengths=(530, 700)))


def _hash_reads(fw, seed=5):
    """10 reads of 30-80 bases from the text, each with one '#', and a
    read with '#' at both ends."""
    rng = np.random.default_rng(seed)
    reads = []
    for i in range(10):
        L = int(rng.integers(30, 80))
        s = int(rng.integers(0, len(fw) - L))
        seq = fw[s:s + L].copy()
        seq[int(rng.integers(0, L))] = ord("#")
        reads.append((f"h{i}", seq.tobytes()))
    return reads + [("edge", b"##" + fw[:20].tobytes() + b"#")]


def _engine(tmi, L):
    return (tfm.FusedMemEngine(tmi, L, "cpu") if L
            else tfm.FusedAllMemEngine(tmi, "cpu"))


def _prepared(tmi, reads, L):
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    return (batch,) + _engine(tmi, L).prepare(batch)


@pytest.mark.parametrize("b", SHIFTS)
@pytest.mark.parametrize("L,ticks", [(12, 45), (20, 3000), (0, 33),
                                     (0, 3000)])
def test_machine_registers_equal_jax(setup, monkeypatch, b, L, ticks):
    """Every register and the emissions after `ticks` lockstep ticks
    equal _mem_scan's / _all_mem_scan's on the JAX table without
    pos2rba (its searchsorted over all_p)."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, b)
    batch, al8, state, _ = _prepared(tmi, _reads(setup["fw"], 31), L)
    al = jnp.asarray(al8.numpy(), jnp.int32)
    if L:
        got, work = tfm.mem_ticks_plain(tmi, al8, state, L, ticks)
        jstate = jfm.make_mem_state(batch.lanes, batch.width,
                                    jnp.asarray(batch.lengths, jnp.int32), L)
        want, _ = jfm._mem_scan(jmi, al, jstate, L, ticks)
        keys = tfm.MEM1_STATE_KEYS
    else:
        start, _ = tfm.all_mem_ticks_plain(tmi, al8, state, 0)
        got, work = tfm.all_mem_ticks_plain(tmi, al8, state, ticks)
        want, _ = jfm._all_mem_scan(
            jmi, al, ticks, {k: jnp.asarray(v.numpy())
                             for k, v in start.items()})
        keys = tfm.AM1_STATE_KEYS
    assert set(got) == set(want) == set(keys) | {"ends", "counts"}
    for key in want:
        assert np.array_equal(got[key].numpy(), np.asarray(want[key])), key
    assert int(work[2].sum()) > 0


def _oracle(oracle, L, reads):
    return [oracle.query_mems(s, L) if L else oracle.query_all_mems(s)
            for _, s in reads]


def _port(tmi, L, reads):
    eng = _engine(tmi, L)
    got = []
    for batch in make_batches(reads, lanes=len(reads), bucket_widths=False):
        got.extend(eng.query_batch(batch))
    return got


def _jax(jmi, L, reads):
    eng = jfm.FusedMemEngine(jmi, L) if L else jfm.FusedAllMemEngine(jmi)
    return eng.query_batch(next(jax_batches(reads, lanes=len(reads))))


@pytest.mark.parametrize("b", SHIFTS)
def test_engines_equal_jax_and_oracle(setup, monkeypatch, record_property,
                                      b):
    """BML at L 12 and 20 and all-MEMs, on one batch of reads with N's,
    short, all-N and long reads and of '#' reads: every read equals
    AdvancedEngine, and the JAX engines too except on '#' reads, where
    their mismatches (ROADMAP §3.9) are recorded, not asserted."""
    jmi, tmi = _tables(setup["ix"], monkeypatch, b)
    plain = _reads(setup["fw"], 57)
    reads = plain + _hash_reads(setup["fw"])
    wrong = {}
    for L in (12, 20, 0):
        want = _oracle(setup["oracle"], L, reads)
        assert _port(tmi, L, reads) == want, L
        jgot = _jax(jmi, L, reads)
        assert jgot[:len(plain)] == want[:len(plain)], L
        wrong[L] = sum(g != w for g, w in zip(jgot[len(plain):],
                                              want[len(plain):]))
    record_property("jax_hash_reads_wrong", wrong)
    print(f"b = {b}: the JAX v1 engines get {wrong} (by L) of "
          f"{len(reads) - len(plain)} '#' reads wrong")


def test_first_run_longer_than_one(record_property):
    """ROADMAP §3.10 on the directory: a lone N counts 0, as the oracle
    does, where the JAX all-MEMs machine counts 1 - n_arr[0]."""
    _, ix = rc_index(50, 13)
    assert int(ix.n_arr[0]) > 1, "fixture must have a long first run"
    fw = random_text(50, 13)
    reads = [("n", b"N"), ("nn", b"NN"), ("mix", b"N" + fw[:9].tobytes()),
             ("tail", fw[5:20].tobytes() + b"N")]
    oracle = AdvancedEngine(ix)
    for b in SHIFTS:
        tmi = tfm.with_run_dir(tfm.build_fused_mem_index(ix, "cpu"), b)
        for L in (0, 3):
            assert _port(tmi, L, reads) == _oracle(oracle, L, reads), (b, L)
    jgot = _jax(jfm.build_fused_mem_index(ix), 0, reads)
    wrong = sum(g != w for g, w in zip(jgot, _oracle(oracle, 0, reads)))
    record_property("jax_reads_wrong", wrong)


# ---- kernels 13b and 13c, lane by lane, as their CUDA source reads

MASK = 0xFFFFFFFF


def _i32(v):
    v &= MASK
    return v - (1 << 32) if v >= 1 << 31 else v


class _Kernel:
    """One thread of kernel 13b or 13c on numpy copies of the tables: the
    tick loop of csrc/fused_mem.cu with its loads and byte tally."""

    def __init__(self, mi):
        si = mi.si
        self.r, self.sigma, self.n = si.r, si.sigma, mi.n
        self.rec = si.rec_all.numpy().astype(np.int64)
        self.init = si.init_rec.numpy().astype(np.int64)
        self.all_p = mi.all_p64.numpy().astype(np.int64)
        self.skip = mi.skip_rec.numpy().astype(np.int64)
        self.p2r = None if mi.pos2rba is None else mi.pos2rba.numpy()
        self.dir = None if mi.run_dir is None else mi.run_dir.numpy()
        self.b = mi.dir_shift
        self.bytes = self.ext = 0

    @staticmethod
    def clamp(x, lo, hi):
        return max(lo, min(x, hi))

    def init_iv(self, a):
        return [int(v) for v in self.init[max(a, 0) + 1]]

    def count(self, iv):
        r = self.r
        s = int(self.all_p[self.clamp(iv[0], 0, r)]) + iv[1]
        e = int(self.all_p[self.clamp(iv[2], 0, r)]) + iv[3]
        return _i32(e - s + 1)

    def bs_step(self, cur, a):
        r, sigma = self.r, self.sigma
        rd = self.rec[a * r + self.clamp(cur[0], 0, r - 1)]
        ru = self.rec[(sigma + a) * r + self.clamp(cur[2], 0, r - 1)]
        empty = rd[0] >= r or rd[0] > cur[2]
        os1 = 0 if rd[0] != cur[0] else cur[1]
        oe1 = int(ru[3]) - 1 if ru[0] != cur[2] else cur[3]
        nxt = []
        for rec, off in ((rd, os1), (ru, oe1)):
            off0 = ((int(rec[2]) & MASK) >> 16) + off
            ff = 1 if off0 >= (int(rec[2]) & 0xFFFF) else 0
            nxt += [int(rec[1]) + ff, off0 - ff * (int(rec[2]) & 0xFFFF)]
        return empty, nxt

    def find_run_dir(self, x):
        """One row's search of find_run_dir2 (the two rows' searches are
        independent; interleaving them changes no load)."""
        k = self.clamp(x >> self.b, 0, len(self.dir) - 2)
        base = int(self.dir[k])
        length = int(self.dir[k + 1]) - base + 1
        start = int(self.all_p[base])
        self.bytes += 8 + 4
        while length > 1:
            v = int(self.all_p[base + (length >> 1)])
            self.bytes += 4
            if v <= x:
                base += length >> 1
                start = v
            length -= length >> 1
        return base, start

    def resolve(self, x):
        if self.p2r is not None:
            row = self.p2r[self.clamp(x, 0, self.n - 1)]
            self.bytes += 8
            return [int(row[0]), x - int(row[1])]
        run, start = self.find_run_dir(x)
        return [run, x - start]

    def step(self, a, bidir, s, o):
        r, sigma = self.r, self.sigma
        if bidir:
            t = self.clamp(sigma - 1 - a, 0, sigma - 1) * r
            ss = self.skip[t + self.clamp(s[0], 0, r - 1)]
            se = self.skip[t + self.clamp(s[2], 0, r - 1)]
            o_start = int(self.all_p[self.clamp(o[0], 0, r)])
        empty, nxt = self.bs_step(s, a)
        self.bytes += 32
        if empty:
            return False, s, o
        if bidir:
            skip = (int(se[0]) + int(se[1]) * (s[3] + 1) - int(ss[0])
                    - int(ss[1]) * s[1])
            cnt = self.count(nxt)
            self.bytes += 20 + 8   # counted only where the step succeeds
            start = _i32(o_start + o[1] + skip)
            o = self.resolve(start) + self.resolve(_i32(start + cnt - 1))
            self.ext += 1
        return True, nxt, o


def _comp(c, sigma):
    return sigma - 1 - c if c >= 0 else (0 if c == -1 else -1)


def _bml_lane(k, row, L, ends, counts):
    W, sigma = len(row), k.sigma
    m = int((row != -2).sum())
    phase, pos, jc, end = (0 if m >= L else 4), 0, 0, 0
    f = rc = [0, 0, 0, 0]
    t = 0

    def at(p):
        return int(row[k.clamp(p, 0, W - 1)])

    while phase != 4:
        t += 1
        if phase == 0:
            if pos + L > m:
                phase = 4
            else:
                c0 = at(pos + L - 1)
                if c0 >= 0:
                    f, rc, jc, phase = (k.init_iv(c0),
                                        k.init_iv(sigma - 1 - c0), 0, 1)
                else:
                    pos = pos + L - 1
        back, fwd = phase == 1, phase == 2
        a = -1
        if back:
            a = at(pos + L - 2 - jc)
        elif fwd:
            a = _comp(at(jc), sigma) if jc < m else -1
        elif phase == 3 and jc <= end - pos - 2:
            a = at(end - 1 - jc)
        ok, s, o = False, (rc if fwd else f), rc
        if a >= 0:
            ok, s, o = k.step(a, back, s, o)
        if back:
            if ok:
                f, rc, jc = s, o, jc + 1
                if jc >= L - 1:
                    phase, jc = 2, pos + L
            else:
                pos, phase = pos + L - 1 - jc, 0
        elif fwd:
            if ok:
                rc, jc = s, jc + 1
            else:
                p = k.clamp(pos, 0, W - 1)
                ends[p] += jc
                counts[p] += k.count(rc)
                k.bytes += 8
                end = jc
                if jc >= m:
                    phase = 4
                else:
                    c_end = at(end)
                    f, jc = k.init_iv(c_end), 0
                    if c_end < 0:
                        pos, phase = end, 0
                    else:
                        phase = 3
        elif phase == 3:
            if ok:
                f, jc = s, jc + 1
            else:
                pos, phase = end - jc, 0
    return [phase, pos, jc, end] + f + rc, t


def _all_mem_lane(k, row, ends, counts):
    W, sigma = len(row), k.sigma
    m = int((row != -2).sum())
    empty = [1, 0, 0, 0]

    def init_pair(c):
        cr = _comp(c, sigma)
        return (k.init_iv(c) if c >= 0 else empty,
                k.init_iv(cr) if cr >= 0 else empty)

    phase, s, ml, e = (0 if m > 0 else 2), 0, 1, 0
    f, rc = init_pair(int(row[0]))
    t = 0
    while phase != 2:
        t += 1
        right = phase == 0
        a = -1
        if right:
            if s + ml < m:
                a = _comp(int(row[k.clamp(s + ml, 0, W - 1)]), sigma)
        elif e - ml >= 0:
            a = int(row[k.clamp(e - ml, 0, W - 1)])
        ok = False
        if a >= 0:
            ok, x, y = k.step(a, True, rc if right else f, f if right else rc)
        if ok:
            rc, f = (x, y) if right else (y, x)
            ml += 1
        elif right:
            cnt = k.count(f)
            k.bytes += 8
            ends[k.clamp(s, 0, W - 1)] += s + ml
            counts[k.clamp(s, 0, W - 1)] += max(cnt, 0)
            e = s + ml
            if e >= m:
                phase = 2
            else:
                f, rc = init_pair(int(row[k.clamp(e, 0, W - 1)]))
                ml, phase = 1, 1
        else:
            s, phase = e - ml + 1, 0
    return [phase, s, ml, e] + f + rc, t


@pytest.mark.parametrize("b", SHIFTS + ["pos2rba"])
@pytest.mark.parametrize("L", [12, 0])
def test_work_equals_kernel_emulation(setup, b, L):
    """Each lane's registers, emissions, ticks, table bytes (the step's
    records; where it succeeds the skip rows, all_p[o.rs], the count, and
    per reposition a pos2rba row or the directory pair, all_p[dir[k]] and the
    halvings) and successful bidirectional extensions from the plain
    machine equal kernel 13b's or 13c's, run lane by lane."""
    ix, fw = setup["ix"], setup["fw"]
    if b == "pos2rba":
        tmi = tfm.build_fused_mem_index(ix, "cpu")
        assert tmi.pos2rba is not None
    else:
        tmi = tfm.with_run_dir(tfm.build_fused_mem_index(ix, "cpu"), b)
    reads = _reads(fw, 77)[:10] + _hash_reads(fw)[-3:]
    _, al8, state, cap = _prepared(tmi, reads, L)
    got, work = (tfm.mem_scan_plain(tmi, al8, state, L, cap) if L
                 else tfm.all_mem_scan_plain(tmi, al8, state, cap))
    keys = tfm.MEM1_STATE_KEYS if L else tfm.AM1_STATE_KEYS
    al = al8.numpy().astype(np.int64)
    for lane in range(al.shape[0]):
        k = _Kernel(tmi)
        ends = np.zeros(al.shape[1], np.int64)
        counts = np.zeros(al.shape[1], np.int64)
        regs, ticks = (_bml_lane(k, al[lane], L, ends, counts) if L
                       else _all_mem_lane(k, al[lane], ends, counts))
        assert [int(got[key][lane]) for key in keys] == regs, lane
        assert np.array_equal(got["ends"][lane].numpy(), ends), lane
        assert np.array_equal(got["counts"][lane].numpy(), counts), lane
        assert work[:, lane].tolist() == [ticks, k.bytes, k.ext], lane
    assert int(work[2].sum()) > 0
