"""The one-launch model-sharded scans of
movi_tpu_torch/parallel/sharded_index.py (kernels 15a and 15b's scans) on
the CPU: their plain versions, on the shards of 1, 2 and 3 ranks emulated
in one process (the last shard padded), against JAX's sharded scans on
the 2 x 4 CPU mesh, the port's step loop (the route a 'model' group that
spans hosts takes) and the unsharded scans; keys on the first and last
row of every shard; illegal codes, 'N' and '#' reads and empty lanes; a
split at every step against one pass; the route each mesh takes; and the
host names that make_2d_mesh gathers, over two gloo ranks.  Every
comparison is exact."""

import numpy as np
import pytest
import torch

import jax

from movi_tpu.engine.fused import build_fused_index
from movi_tpu.engine.fused_search import build_fused_search_index
from movi_tpu.parallel import sharded_index as jsi
from movi_tpu_torch import kernels, testing
from movi_tpu_torch.convert import (fused_index_from_jax,
                                    fused_search_index_from_jax)
from movi_tpu_torch.engine import fused as tf
from movi_tpu_torch.engine import fused_search as ts
from movi_tpu_torch.parallel import Mesh, make_mesh
from movi_tpu_torch.parallel import sharded_index as tsi

MODELS = [1, 2, 3]
LANES, W = 16, 40


def _codes(amap, reads, fill):
    """[W, LANES] scan-order codes of reads (right to left), fill past
    each read."""
    out = np.full((LANES, W), fill, dtype=np.int32)
    for i, seq in enumerate(reads):
        b = np.frombuffer(seq, np.uint8)
        out[i, :len(b)] = amap[b][::-1]
    return np.ascontiguousarray(out.T)


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(62)
    text = testing.random_text(3000, 62)   # r = 2,482: 3 shards pad
    ix = testing.index_from_text(text)
    jfi, jsx = build_fused_index(ix), build_fused_search_index(ix)
    reads = [b"", b"ACGTNACGT#ACGT", b"#", b"N" * 7]
    while len(reads) < LANES:
        L = int(rng.integers(10, W))
        s = int(rng.integers(0, len(text) - L))
        seq = text[s:s + L].copy()
        if len(reads) % 3 == 0:
            seq[int(rng.integers(0, L))] = ord("N")
        if len(reads) % 5 == 0:
            seq[int(rng.integers(0, L))] = ord("#")
        reads.append(seq.tobytes())
    fi, si = fused_index_from_jax(jfi), fused_search_index_from_jax(jsx)
    return dict(ix=ix, jfi=jfi, jsx=jsx, fi=fi, si=si, reads=reads,
                pml=_codes(jfi.alphamap_query, reads, jfi.sigma),
                search=_codes(jsx.alphamap_query, reads, -2))


@pytest.fixture(scope="module")
def jax_res(case):
    assert len(jax.devices()) >= 8
    mesh = jsi.make_2d_mesh(data=2, model=4)
    m, c = jsi.sharded_fused_count(mesh, case["jsx"], case["search"])
    return dict(pml=np.asarray(jsi.sharded_fused_pml(mesh, case["jfi"],
                                                     case["pml"])),
                matched=np.asarray(m), count=np.asarray(c),
                zml=np.asarray(jsi.sharded_fused_zml(mesh, case["jsx"],
                                                     case["search"])))


def _plain(case, model):
    """The plain scans on `model` emulated shards: (pml ml, count state,
    zml state, zml ml)."""
    fi, si = case["fi"], case["si"]
    codes = torch.from_numpy(case["pml"].astype(np.uint8))
    chars = torch.from_numpy(case["search"].astype(np.int8))
    _, ml = tsi.sharded_pml_scan_plain(
        tsi.split_shards(fi.records, model), fi.sigma + 1, fi.p_dollar,
        codes, tf.initial_state(fi, LANES, "cpu"))
    shards = tsi.split_shards(si.rec_all, model)
    cst, _ = tsi.sharded_search_scan_plain(shards, si.r, si.sigma,
                                           si.init_rec, chars, False)
    zst, zml = tsi.sharded_search_scan_plain(shards, si.r, si.sigma,
                                             si.init_rec, chars, True)
    return ml, cst, zst, zml


def _step_loop(case, model):
    """The step route on `model` emulated ranks in one process: every
    step each rank gathers its own rows and the rows are summed, as the
    all-reduce sums them.  Returns (pml ml, count state, zml state, zml
    ml), each rank's equal."""
    fi, si = case["fi"], case["si"]
    codes = torch.from_numpy(case["pml"].astype(np.uint8))
    chars = torch.from_numpy(case["search"].astype(np.int8))
    ranks = [Mesh(1, model, 0, m, torch.device("cpu"), None)
             for m in range(model)]

    def run(records, steps, step, state0, ml0):
        parts = [tsi.local_shard(mesh, records) for mesh in ranks]
        states = [state0.clone() for _ in ranks]
        mls = [None if ml0 is None else ml0.clone() for _ in ranks]
        rec = None
        for t in range(steps):
            rows = [step(local, lo, t, rec, st, ml)
                    for (local, lo), st, ml in zip(parts, states, mls)]
            rec = None if rows[0] is None else sum(rows)
        for st, ml in zip(states[1:], mls[1:]):
            assert torch.equal(st, states[0])
            assert ml is None or torch.equal(ml, mls[0])
        return states[0], mls[0]

    st0 = torch.stack(tf.initial_state(fi, LANES, "cpu"))
    _, ml = run(fi.records, W + 1,
                lambda local, lo, t, rec, st, ml: tsi.sharded_pml_gather(
                    local, lo, fi.sigma + 1, fi.p_dollar, codes, t, rec, st,
                    ml), st0, torch.zeros((W, LANES), dtype=torch.int32))
    out = [ml]
    for zml in (False, True):
        st, zm = run(si.rec_all, W,
                     lambda local, lo, t, rec, st, ml, z=zml:
                     tsi.sharded_search_gather(local, lo, si.r, si.sigma,
                                               si.init_rec, chars, t, z,
                                               rec, st, ml),
                     torch.zeros((6, LANES), dtype=torch.int32),
                     torch.zeros((W, LANES), dtype=torch.int32) if zml
                     else None)
        out += [st] if not zml else [st, zm]
    return tuple(out)


@pytest.mark.parametrize("model", MODELS)
def test_plain_scans_equal_jax_steps_and_unsharded(case, jax_res, model):
    fi, si = case["fi"], case["si"]
    if model == 3:  # the last shard of each table is padded
        assert fi.records.shape[0] % 3 and si.rec_all.shape[0] % 3
    ml, cst, zst, zml = _plain(case, model)
    assert np.array_equal(ml.numpy(), jax_res["pml"])
    assert np.array_equal(cst[4].numpy(), jax_res["matched"])
    mesh = make_mesh(1, "cpu")
    all_p = si.all_p.to(torch.int64)
    rs, os_, re, oe, matched = (cst[i].to(torch.int64) for i in range(5))
    count = torch.where(matched > 0, all_p[re] + oe - all_p[rs] - os_ + 1, 0)
    assert np.array_equal(count.numpy(), jax_res["count"])
    assert np.array_equal(zml.numpy(), jax_res["zml"])
    # the step loop, emulated at this model, and through the API at one
    # rank; the unsharded scans
    steps = _step_loop(case, model)
    for got, want in zip((ml, cst, zst, zml), steps):
        assert torch.equal(got, want)
    assert torch.equal(ml, tsi.sharded_fused_pml(mesh, fi, case["pml"]))
    m_api, c_api = tsi.sharded_fused_count(mesh, si, case["search"])
    assert torch.equal(m_api, cst[4]) and torch.equal(c_api, count)
    assert torch.equal(zml, tsi.sharded_fused_zml(mesh, si, case["search"]))
    codes = torch.from_numpy(case["pml"].astype(np.uint8))
    chars = torch.from_numpy(case["search"].astype(np.int8))
    assert torch.equal(ml, tf.fused_pml_scan_plain(
        fi.records, fi.sigma + 1, fi.p_dollar, codes,
        tf.initial_state(fi, LANES, "cpu"))[1])
    assert torch.equal(cst, ts.fused_count_scan_plain(
        si.rec_all, si.init_rec, si.all_p, si.r, si.sigma, chars)[0])
    assert torch.equal(zml, ts.fused_zml_scan_plain(
        si.rec_all, si.init_rec, si.r, si.sigma, chars)[1])
    # empty lanes and the '#' and 'N' reads: nothing matched where a read
    # is empty, and JAX's answers there too
    assert case["reads"][0] == b"" and int(cst[4, 0]) == 0
    assert not zml[:, 0].any() and not ml[:, 0].any()


@pytest.mark.parametrize("model", [2, 3])
def test_split_at_every_step(case, model):
    """A scan split at any t, the state carried, equals one pass."""
    fi, si = case["fi"], case["si"]
    codes = torch.from_numpy(case["pml"].astype(np.uint8))
    chars = torch.from_numpy(case["search"].astype(np.int8))
    pshards = tsi.split_shards(fi.records, model)
    sshards = tsi.split_shards(si.rec_all, model)
    st0 = tf.initial_state(fi, LANES, "cpu")
    pst, pml = tsi.sharded_pml_scan_plain(pshards, fi.sigma + 1, fi.p_dollar,
                                          codes, st0)
    whole = {z: tsi.sharded_search_scan_plain(sshards, si.r, si.sigma,
                                              si.init_rec, chars, z)
             for z in (False, True)}
    for t in range(1, W):
        st, ml1 = tsi.sharded_pml_scan_plain(pshards, fi.sigma + 1,
                                             fi.p_dollar, codes[:t], st0)
        st, ml2 = tsi.sharded_pml_scan_plain(pshards, fi.sigma + 1,
                                             fi.p_dollar, codes[t:], st)
        assert torch.equal(torch.cat([ml1, ml2]), pml)
        assert all(torch.equal(a, b) for a, b in zip(st, pst))
        for z, (wst, wml) in whole.items():
            st, ml1 = tsi.sharded_search_scan_plain(
                sshards, si.r, si.sigma, si.init_rec, chars[:t], z)
            st, ml2 = tsi.sharded_search_scan_plain(
                sshards, si.r, si.sigma, si.init_rec, chars[t:], z, st)
            assert torch.equal(st, wst)
            if z:
                assert torch.equal(torch.cat([ml1, ml2]), wml)


@pytest.mark.parametrize("model", MODELS)
def test_keys_on_shard_bounds(case, model):
    """Every shard's first and last row, read directly and as the first
    key of a scan continued from a state that asks for it, equal the
    unsharded table's; rows past the table (the padding and beyond the
    last shard) read zero."""
    fi, si = case["fi"], case["si"]
    for records in (fi.records, si.rec_all):
        shards = tsi.split_shards(records, model)
        n, rows = shards[0].shape[0], records.shape[0]
        keys = torch.tensor(sorted({k for m in range(model)
                                    for k in (m * n, m * n + n - 1)}
                                   | {model * n, model * n + 7}),
                            dtype=torch.int64)
        got = tsi._shard_rows(shards, keys)
        inside = keys < rows
        assert torch.equal(got[inside], records[keys[inside]])
        assert not got[~inside].any()
        assert (~inside).sum() >= 2 + (rows < model * n)
    slots = fi.sigma + 1
    n = tsi.split_shards(fi.records, model)[0].shape[0]
    keys = sorted({k for m in range(model) for k in (m * n, m * n + n - 1)
                   if k < fi.records.shape[0]})
    idx = torch.tensor([k // slots for k in keys], dtype=torch.int32)
    codes = torch.from_numpy(case["pml"][:, :len(keys)].astype(np.uint8))
    codes[0] = torch.tensor([k % slots for k in keys], dtype=torch.uint8)
    st = (idx, torch.zeros_like(idx), torch.zeros_like(idx))
    got = tsi.sharded_pml_scan_plain(tsi.split_shards(fi.records, model),
                                     slots, fi.p_dollar, codes, st)
    want = tf.fused_pml_scan_plain(fi.records, slots, fi.p_dollar, codes, st)
    assert torch.equal(got[1], want[1])
    # search: a state whose down (row rs of char a) or up key (row re of
    # char sigma + a) is a bound
    r, sigma = si.r, si.sigma
    n = tsi.split_shards(si.rec_all, model)[0].shape[0]
    keys = sorted({k for m in range(model) for k in (m * n, m * n + n - 1)
                   if k < si.rec_all.shape[0]})
    lanes = len(keys)
    chars = torch.from_numpy(case["search"][:, :lanes].astype(np.int8))
    a = [(k // r) % sigma for k in keys]
    chars[0] = torch.tensor(a, dtype=torch.int8)
    run = torch.tensor([k % r for k in keys], dtype=torch.int32)
    down = torch.tensor([k < sigma * r for k in keys])
    last = torch.full_like(run, r - 1)
    state = torch.stack([torch.where(down, run, 0), torch.zeros_like(run),
                         torch.where(down, last, run), torch.zeros_like(run),
                         torch.ones_like(run), torch.zeros_like(run)])
    shards = tsi.split_shards(si.rec_all, model)
    for z in (False, True):
        got = tsi.sharded_search_scan_plain(shards, r, sigma, si.init_rec,
                                            chars, z, state)
        want = (ts.fused_zml_scan_plain(si.rec_all, si.init_rec, r, sigma,
                                        chars, state) if z else
                ts.fused_count_scan_plain(si.rec_all, si.init_rec, si.all_p,
                                          r, sigma, chars, state))
        assert torch.equal(got[0], want[0])
        if z:
            assert torch.equal(got[1], want[1])


def test_route_and_tables(case, monkeypatch):
    """The route is taken from the mesh: CUDA tensors with a 'model'
    group on one host scan in one launch, a group that spans hosts and
    CPU tensors take the step loop.  A table is split once per mesh and
    released by close_tables; the scan route's branch of the API, forced
    on a one-rank CPU mesh, equals the step loop."""
    cpu, gpu = torch.device("cpu"), torch.device("cuda", 0)
    for device, one_host, want in ((gpu, True, True), (gpu, False, False),
                                   (cpu, True, False), (cpu, False, False)):
        mesh = Mesh(1, 2, 0, 0, device, None, model_on_one_host=one_host)
        assert tsi.scan_route(mesh, mesh.device) is want
    fi, si = case["fi"], case["si"]
    mesh = make_mesh(1, "cpu")
    assert mesh.model_on_one_host and not tsi.scan_route(mesh, "cpu")
    calls = {"step": 0, "scan": 0}
    step = tsi.sharded_pml_gather

    def counting_step(*a):
        calls["step"] += 1
        return step(*a)

    monkeypatch.setattr(tsi, "sharded_pml_gather", counting_step)
    ml = tsi.sharded_fused_pml(mesh, fi, case["pml"])
    assert calls["step"] == W + 1
    table = tsi.shard_table(mesh, fi.records)
    assert table.shards is None and table is tsi.shard_table(mesh,
                                                             fi.records)
    tsi.close_tables(mesh)
    assert not mesh.tables

    scan = tsi.sharded_pml_scan

    def counting_scan(*a):
        calls["scan"] += 1
        return scan(*a)

    monkeypatch.setattr(tsi, "scan_route", lambda mesh, device: True)
    monkeypatch.setattr(tsi, "sharded_pml_scan", counting_scan)
    assert torch.equal(tsi.sharded_fused_pml(mesh, fi, case["pml"]), ml)
    assert calls == {"step": W + 1, "scan": 1}
    table = tsi.shard_table(mesh, fi.records)
    assert len(table.shards) == 1 and table.shards[0] is table.local
    assert table.ptrs.tolist() == [table.local.data_ptr()]
    matched, count = tsi.sharded_fused_count(mesh, si, case["search"])
    m0, c0 = tsi.sharded_fused_count(make_mesh(1, "cpu"), si,
                                     case["search"])
    assert torch.equal(matched, m0) and torch.equal(count, c0)
    assert torch.equal(tsi.sharded_fused_zml(mesh, si, case["search"]),
                       tsi.sharded_fused_zml(make_mesh(1, "cpu"), si,
                                             case["search"]))
    tsi.close_tables(mesh)


def test_scan_wrappers_refuse_cpu_tensors(case):
    fi, si = case["fi"], case["si"]
    codes = torch.zeros((3, 4), dtype=torch.uint8)
    shards = tsi.split_shards(fi.records, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sharded_pml_scan(shards, tsi.shard_ptrs(shards, "cpu"),
                                 fi.sigma + 1, fi.p_dollar, codes,
                                 tf.initial_state(fi, 4, "cpu"))
    shards = tsi.split_shards(si.rec_all, 2)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.sharded_search_scan(shards, tsi.shard_ptrs(shards, "cpu"),
                                    si.r, si.sigma, si.init_rec,
                                    torch.zeros((3, 4), dtype=torch.int8),
                                    True)


def test_host_names_gathered_over_two_ranks():
    """make_2d_mesh gathers every rank's host name once: a 'model' group
    of two ranks on this host is on one host; given two host names it
    spans hosts, unless each group holds one rank."""
    got = testing.run_ranks("movi_tpu_torch.testing:mesh_hosts_rank", 2,
                            cases=[((1, 2), None), ((1, 2), ["a", "b"]),
                                   ((2, 1), ["a", "b"]),
                                   ((1, 2), ["a", "a"])])
    assert got == [[True, False, True, True]] * 2
