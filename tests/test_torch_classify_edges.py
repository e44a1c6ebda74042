"""The classification pass of the data-parallel PML engine (kernel 16a,
movi_tpu_torch/csrc/classify.cu) on the CPU, at its edge shapes: W below,
equal to and above bin_width, W not a multiple of it, bin_width 1;
lengths 0, 1, bw-1, bw, bw+1, W-1 and W; lanes not a multiple of 32;
thresholds -1, 0 and above every value.

classify_from_ml_plain equals movi_tpu.parallel.mesh._classify_from_ml
exactly, and at a Classifier's own threshold the host Classifier on each
lane.  An emulation of the kernel's decomposition (tiles of 32 lanes,
slices of bins, chunks in shared memory, each warp's piece of rows with
its unrolled predicated loads, the slices merged by integer atomics in
the call's zeroed scratch and a last-block ticket, blocks in any order)
equals the plain version too, with one slice a tile and with many."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from movi_tpu.parallel import mesh as jmesh
from movi_tpu_torch.classify import Classifier, EmpNullDatabase
from movi_tpu_torch.parallel import mesh as tmesh

INT_MIN = -2**31
# (W, bin_width, lanes)
SHAPES = [(100, 150, 45), (150, 150, 45), (400, 150, 45), (450, 150, 64),
          (20, 1, 33), (37, 5, 45)]
SHAPE_IDS = ["W<bw", "W=bw", "W>bw-ragged", "W=3bw", "bw1", "bw5-ragged"]
TOP = 70  # ml values lie in [0, TOP]


def _case(W, bw, lanes, seed=0):
    """ml int32 [W, lanes] and lengths int32 [lanes]: every edge length
    first, the other lanes random in [0, W]."""
    rng = np.random.default_rng(seed + 7 * W + bw)
    edges = sorted({min(max(x, 0), W) for x in
                    (0, 1, bw - 1, bw, bw + 1, W - 1, W)})
    lens = np.concatenate([edges, rng.integers(0, W + 1,
                                               lanes - len(edges))])
    ml = rng.integers(0, TOP + 1, size=(W, lanes))
    return ml.astype(np.int32), lens.astype(np.int32)


def _thresholds():
    return (-1, 0, 35, TOP + 1)


@pytest.mark.parametrize("thr", _thresholds())
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_equals_jax(shape, thr):
    W, bw, lanes = shape
    ml, lens = _case(W, bw, lanes)
    got = tmesh.classify_from_ml_plain(torch.from_numpy(ml),
                                       torch.from_numpy(lens), bw, thr)
    want = jmesh._classify_from_ml(jnp.asarray(ml), jnp.asarray(lens), bw,
                                   jnp.int32(thr))
    assert got[0].dtype == torch.bool
    assert got[1].dtype == got[2].dtype == torch.int32
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # a lane of length 0: one bin of -1, so (false, 0, 1) for thr >= 0
    # and (true, 1, 0) below
    zero = lens == 0
    assert zero.any()
    want0 = (False, 0, 1) if thr >= 0 else (True, 1, 0)
    for g, w in zip(got, want0):
        assert (g.numpy()[zero] == w).all()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_plain_equals_host_classifier(shape):
    """At the Classifier's own threshold, every lane with a read equals
    Classifier.classify on its lengths."""
    W, bw, lanes = shape
    db = EmpNullDatabase()
    db.compute([TOP // 2] * 5)
    cl = Classifier(db, bin_width=bw)
    ml, lens = _case(W, bw, lanes, seed=1)
    found, above, below = (t.numpy() for t in tmesh.classify_from_ml_plain(
        torch.from_numpy(ml), torch.from_numpy(lens), bw, cl.max_value_thr))
    n = 0
    for lane, L in enumerate(lens):
        if L == 0:
            continue
        wf, _, wa, wb = cl.classify(ml[:L, lane].tolist())
        assert (bool(found[lane]), int(above[lane]), int(below[lane])) == \
            (bool(wf), wa, wb)
        n += 1
    assert n == int((lens > 0).sum()) > lanes // 2
    assert int(above.sum()) > 0 and int(below.sum()) > 0


def _kernel_emulation(ml, lens, bw, thr, sms, chunk=64, warps=8, unroll=8,
                      seed=0):
    """classify.cu's classify_from_ml_kernel and its launch, block by block
    in a random order, a tile's 32 lanes at once; the scratch starts at
    zero, as the wrapper allocates it."""
    W, lanes = ml.shape
    tile_w = 32
    nb = -(-W // bw)
    tiles = -(-lanes // tile_w)
    target = sms * (2048 // (tile_w * warps))
    slice_bins = min(-(-tiles * nb // target), nb)
    slices = -(-nb // slice_bins)
    s_votes = np.zeros(lanes, np.int64)
    s_tail = np.full(lanes, INT_MIN, np.int64)  # order key 0
    ticket = np.zeros(tiles, np.int64)
    out = [np.full(lanes, -7, np.int64) for _ in range(3)]

    def finish(lane, B, votes, tail):
        tail = np.where((B > 1) & (tail < -1), -1, tail)
        above = votes + (tail >= thr)
        out[0][lane] = 2 * above > B
        out[1][lane] = above
        out[2][lane] = B - above

    rng = np.random.default_rng(seed)
    for blk in rng.permutation(tiles * slices):
        tile, sl = blk % tiles, blk // tiles
        lane = tile * tile_w + np.arange(tile_w)
        inn = lane < lanes
        col = np.where(inn, lane, 0)
        L = np.where(inn, lens[col], 0).astype(np.int64)
        B = np.maximum(L // bw, 1)
        b_hi = min(sl * slice_bins + slice_bins, nb)
        votes = np.zeros(tile_w, np.int64)
        tail = np.full(tile_w, INT_MIN, np.int64)
        for c0 in range(sl * slice_bins, b_hi, chunk):
            c1 = min(c0 + chunk, b_hi)
            bmax = np.full((c1 - c0, tile_w), INT_MIN, np.int64)
            r0, r1 = c0 * bw, min(c1 * bw, W)
            per = -(-(r1 - r0) // warps)
            for y in range(warps):
                t0 = r0 + y * per
                t1 = min(t0 + per, r1)
                lim = np.minimum(t1, L)
                b, nxt = t0 // bw, (t0 // bw + 1) * bw
                m = np.full(tile_w, INT_MIN, np.int64)
                for t in range(t0, t1, unroll):
                    v = [np.where(t + u < lim, ml[min(t + u, t1 - 1), col],
                                  -1) for u in range(unroll)]
                    for u in range(unroll):
                        if t + u < t1:
                            if t + u == nxt:
                                bmax[b - c0] = np.maximum(bmax[b - c0], m)
                                b, nxt = b + 1, nxt + bw
                                m = np.full(tile_w, INT_MIN, np.int64)
                            m = np.maximum(m, v[u])
                if t0 < t1:
                    bmax[b - c0] = np.maximum(bmax[b - c0], m)
            for bb in range(c0, c1):
                v = bmax[bb - c0]
                if bb == nb - 1 and nb * bw > W:
                    v = np.maximum(v, -1)
                pre = bb < B - 1
                votes += pre & (v >= thr)
                tail = np.where(pre, tail, np.maximum(tail, v))
        if slices == 1:
            finish(lane[inn], B[inn], votes[inn], tail[inn])
            continue
        s_votes[lane[inn]] += votes[inn]
        s_tail[lane[inn]] = np.maximum(s_tail[lane[inn]], tail[inn])
        ticket[tile] += 1
        if ticket[tile] == slices:
            finish(lane[inn], B[inn], s_votes[lane[inn]], s_tail[lane[inn]])
    assert (ticket == (slices if slices > 1 else 0)).all()
    return out, slices


@pytest.mark.parametrize("sms,chunk",
                         [(132, 64), (1, 2), (8, 1)],
                         ids=["H100", "one-SM-chunk2", "8-SMs-chunk1"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_kernel_emulation_equals_plain(shape, sms, chunk):
    """The kernel's blocks, emulated, give the plain version's answers at
    every threshold: a batch of more than one bin splits its tiles into
    slices, and a slice of more bins than a chunk walks them a chunk at a
    time."""
    W, bw, lanes = shape
    ml, lens = _case(W, bw, lanes, seed=2)
    for thr in _thresholds():
        got, slices = _kernel_emulation(ml, lens, bw, thr, sms, chunk,
                                        seed=thr + 3)
        want = tmesh.classify_from_ml_plain(torch.from_numpy(ml),
                                            torch.from_numpy(lens), bw, thr)
        for g, w in zip(got, want):
            assert np.array_equal(g, w.numpy().astype(np.int64))
        nb = -(-W // bw)
        assert (slices > 1) == (nb > 1)
