"""Kernels 15a and 15b of the port: the model-sharded scans in one launch
(the scan route) against the step loop, a launch and an all-reduce a
base (the step route), on the card, on the inputs of `chip_smoke.py`.

    python tools/sharded_scan_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from `git
archive PARENT movi_tpu_torch/csrc`).  The trial builds its `sharded.cu`
into a library of its own: the parent's step kernels, which ran every
model-sharded query there.  The inputs are the smoke's: phase 4's index
(`chip_smoke.FULL_TEXT` bases) and the first batch of its 150 bp reads
(`chip_smoke.QUERY_LANES` lanes).  In a process group of one rank on the
card (NCCL, model = 1) it runs `sharded_fused_pml`, `_count` and `_zml`
in the rounds of ORDER: "parent", the step route on the parent's
library (the mesh made to span hosts, so that this tree's API runs the
parent's loop); "scan", this tree's scan route; "step", this tree's step
route on its own library.  Per round and query it prints the launches,
the wall of a query with its collectives (host clock, synchronised) and
the device time (CUDA events: the scan's launch; the step loop's
launches with the host loop between them, and the same launches queued
back to back behind a spin, `chip_smoke.queued_ms`), each the median of
TIMINGS; every round's answers must equal the first's bit for bit.  Then
the scans alone on the tables split for 2 and 4 ranks, emulated in this
process (every shard an allocation of its own), and two ranks sharing
the card (gloo, model = 2), each timing its scan route (the peer's shard
opened through CUDA IPC) and its step route (gloo all-reduces).  It
writes OUT/trials.json.  It needs one CUDA card, `nvcc` and `make` (for
`native/`).

    python tools/sharded_scan_trials.py --cards N --out OUT

runs instead a 'model' group of N ranks, one a card of the host (NCCL),
each timing its scan route (its peers' shards opened through IPC and
read over NVLink) and its step route (NCCL all-reduces), their answers
held to one card's scan.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.tick_trials import build, finish, load  # noqa: E402

ORDER = ("parent", "scan", "step", "scan", "parent")
TIMINGS = 5   # a time: the median of this many runs
REPS = 10     # a kernel time: the mean of this many calls
EMULATED = (2, 4)


def inputs(dev):
    """Phase 4's index on the card and the codes and chars of its first
    150 bp batch."""
    import torch

    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.testing import index_from_text, random_text

    t0 = time.perf_counter()
    text = random_text(smoke.FULL_TEXT, 0)
    ix = index_from_text(text)
    fi = tf.build_fused_index(ix).to(dev)
    si = ts.build_fused_search_index(ix).to(dev)
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    b = next(_as_batches(reads, smoke.QUERY_LANES))
    codes = tf.FusedPMLEngine(fi, dev).prepare(b)
    chars = torch.from_numpy(np.ascontiguousarray(ts.search_chars(
        si.alphamap_query, b, True).T).astype(np.int8)).to(dev)
    print(f"[trials] r={ix.r}; {codes.shape[1]} lanes x {codes.shape[0]} "
          f"steps; inputs {time.perf_counter() - t0:.1f} s", flush=True)
    return fi, si, codes, chars


def _median_wall(fn):
    import torch

    ts_ = []
    for _ in range(TIMINGS):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts_.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts_)


def _median_ms(fn):
    return statistics.median(smoke.cuda_ms(fn, REPS)
                             for _ in range(TIMINGS))


def queries(mesh, fi, si, codes_np, chars_np):
    """The three sharded queries of one batch on mesh, as closures."""
    from movi_tpu_torch.parallel import sharded_index as tsi

    return {"pml": lambda: (tsi.sharded_fused_pml(mesh, fi, codes_np),),
            "count": lambda: tsi.sharded_fused_count(mesh, si, chars_np),
            "zml": lambda: (tsi.sharded_fused_zml(mesh, si, chars_np),)}


def kernel_runs(fi, si, codes, chars, table, stable, scan: bool):
    """Per query, the kernels alone: the scan's launch, or the step
    loop's launches (the all-reduce left out: model = 1)."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused as tf

    W, lanes = codes.shape
    dev = codes.device
    init_rec = si.init_rec.to(dev)
    if scan:
        def pml():
            kernels.sharded_pml_scan(table.shards, table.ptrs, fi.sigma + 1,
                                     fi.p_dollar, codes,
                                     tf.initial_state(fi, lanes, dev))

        def search(z):
            return lambda: kernels.sharded_search_scan(
                stable.shards, stable.ptrs, si.r, si.sigma, init_rec, chars,
                z)
        return {"pml": pml, "count": search(False), "zml": search(True)}
    st0 = torch.stack(tf.initial_state(fi, lanes, dev))

    def pml_loop():
        st, rec = st0.clone(), None
        ml = torch.empty((W, lanes), dtype=torch.int32, device=dev)
        for t in range(W + 1):
            rec = kernels.sharded_pml_gather(table.local, table.lo,
                                             fi.sigma + 1, fi.p_dollar,
                                             codes, t, rec, st, ml)

    def search_loop(z):
        def run():
            st, rec = torch.empty((6, lanes), dtype=torch.int32,
                                  device=dev), None
            ml = (torch.empty((W, lanes), dtype=torch.int32, device=dev)
                  if z else None)
            for t in range(W):
                rec = kernels.sharded_search_gather(
                    stable.local, stable.lo, si.r, si.sigma, init_rec,
                    chars, t, z, rec, st, ml)
        return run
    return {"pml": pml_loop, "count": search_loop(False),
            "zml": search_loop(True)}


def rank_times(rank: int, world: int, init_method: str, tables: str,
               cards: int):
    """A rank of a 'model' group of `world`: on the one card over gloo
    (cards 1) or on card `rank` over NCCL.  Per route, the answers and
    per query the wall and the launches; the scan kernels' times."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.parallel import make_2d_mesh
    from movi_tpu_torch.parallel import sharded_index as tsi
    from movi_tpu_torch.testing import _joined, _left

    device, backend = ("cuda", "gloo") if cards == 1 else (f"cuda:{rank}",
                                                            None)
    _joined(rank, world, init_method, device, backend)
    try:
        fi, si, codes_np, chars_np = torch.load(tables, weights_only=False)
        mesh = make_2d_mesh(1, world, device, backend)
        out = {}
        for route, m in (("scan", mesh), ("step", dataclasses.replace(
                mesh, model_on_one_host=False))):
            kernels.reset_launches()
            res, walls = {}, {}
            for name, q in queries(m, fi, si, codes_np, chars_np).items():
                res[name] = [t.cpu().numpy() for t in q()]
                walls[name] = _median_wall(q)
            out[route] = dict(answers=res, walls=walls,
                              launches=dict(kernels.launches))
            if route == "scan":
                dev = torch.device(device)
                codes = torch.from_numpy(codes_np).to(dev)
                chars = torch.from_numpy(chars_np).to(dev)
                out["kernel_ms"] = {q: _median_ms(fn) for q, fn in
                                    kernel_runs(fi, si, codes, chars,
                                                tsi.shard_table(m, fi.records),
                                                tsi.shard_table(m, si.rec_all),
                                                True).items()}
            tsi.close_tables(m)
        return out
    finally:
        _left()


def group_of_ranks(fi, si, codes_np, chars_np, ref, world, cards, out_dir,
                   card):
    """`world` ranks of one 'model' group (rank_times), each route's
    answers held to ref; per route and rank the walls and launches."""
    import torch

    from movi_tpu_torch.testing import run_ranks

    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        tables = os.path.join(work, "tables.pt")
        torch.save((fi.to("cpu"), si.to("cpu"), codes_np, chars_np), tables)
        t0 = time.perf_counter()
        ranks = run_ranks("tools.sharded_scan_trials:rank_times", world,
                          timeout=900, tables=tables, cards=cards)
    group = {"kernel_ms": [res.pop("kernel_ms") for res in ranks]}
    for rank, res in enumerate(ranks):
        for route, r in res.items():
            for q, got in r["answers"].items():
                if not all(np.array_equal(a, b.numpy())
                           for a, b in zip(got, ref[q])):
                    raise AssertionError(f"rank {rank} {route} {q} differs "
                                         f"from model = 1")
            group.setdefault(route, []).append(dict(
                walls=r["walls"], launches={k: v for k, v in
                                            r["launches"].items() if v}))
    where = "the card (gloo" if cards == 1 else f"{cards} cards (NCCL"
    print(f"[trials] {world} ranks on {where}, model = {world}; "
          f"{time.perf_counter() - t0:.1f} s with start-up): " + "; ".join(
              f"{route} route rank {i} " + ", ".join(
                  f"{q} {w:.6f} ms" for q, w in r["walls"].items())
              + f" {r['launches']}"
              for route in ("scan", "step")
              for i, r in enumerate(group[route]))
          + "; scan kernels " + "; ".join(
              f"rank {i} " + ", ".join(f"{q} {ms:.6f} ms"
                                       for q, ms in k.items())
              for i, k in enumerate(group["kernel_ms"]))
          + f"  ({card})", flush=True)
    return group


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent",
                    help="the parent commit's csrc directory (one card)")
    ap.add_argument("--out", required=True,
                    help="a directory for the parent's library and "
                         "trials.json")
    ap.add_argument("--cards", type=int, default=1,
                    help="with more than one: only a 'model' group of one "
                         "rank a card (NCCL), against one card's scan")
    args = ap.parse_args(argv)
    if args.cards == 1 and not args.parent:
        ap.error("--parent is needed on one card")
    if not torch.cuda.is_available():
        print("sharded_scan_trials: no CUDA card", file=sys.stderr)
        return 1
    from movi_tpu_torch import kernels
    from movi_tpu_torch.build.suffix import _load_native
    from movi_tpu_torch.device import card_line, resolve_device
    from movi_tpu_torch.parallel import (init_process_group, make_2d_mesh,
                                         make_mesh)
    from movi_tpu_torch.parallel import sharded_index as tsi
    from movi_tpu_torch.testing import free_port

    mk = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                        capture_output=True, text=True, timeout=600)
    if mk.returncode != 0 or not _load_native():
        raise RuntimeError(f"make -C native failed:\n{mk.stderr}")
    dev = resolve_device("cuda")
    card = card_line(dev)
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    fi, si, codes, chars = inputs(dev)
    W, lanes = codes.shape
    codes_np, chars_np = codes.cpu().numpy(), chars.cpu().numpy()
    if args.cards > 1:
        one = make_mesh(1, dev)   # one card, no process group: the scan
        ref = {q: [t.cpu() for t in fn()] for q, fn in
               queries(one, fi, si, codes_np, chars_np).items()}
        tsi.close_tables(one)
        group = group_of_ranks(fi, si, codes_np, chars_np, ref, args.cards,
                               args.cards, args.out, card)
        with open(os.path.join(args.out, "trials.json"), "w") as f:
            json.dump({"card": card, "lanes": lanes, "steps": W,
                       "cards": args.cards, "group": group}, f, indent=1)
        return 0
    with tempfile.TemporaryDirectory(dir=args.out) as work:
        so = os.path.join(args.out, "parent.so")
        finish(*build(args.parent, so, [], work, ("sharded.cu",)), "parent")
    libs = {"parent": load(so), "scan": kernels._load(),
            "step": kernels._load()}

    init_process_group(f"tcp://127.0.0.1:{free_port()}", 1, 0, dev)
    mesh = make_2d_mesh(1, 1, dev)
    mesh.all_reduce_model(torch.zeros(1, dtype=torch.int32, device=dev))
    spans = dataclasses.replace(mesh, model_on_one_host=False)
    ref, rows = {}, []
    for rnd, name in enumerate(ORDER):
        kernels._lib = libs[name]
        m = mesh if name == "scan" else spans
        row = dict(library=name, round=rnd, queries={})
        for q, fn in queries(m, fi, si, codes_np, chars_np).items():
            kernels.reset_launches()
            out = [t.cpu() for t in fn()]
            torch.cuda.synchronize()
            launched = {k: v for k, v in kernels.launches.items() if v}
            if q not in ref:
                ref[q] = out
            elif not all(torch.equal(a, b) for a, b in zip(out, ref[q])):
                raise AssertionError(f"{name}: {q} differs from round 0's")
            row["queries"][q] = dict(launches=launched,
                                     wall_ms=_median_wall(fn))
        table = tsi.shard_table(m, fi.records)
        stable = tsi.shard_table(m, si.rec_all)
        for q, fn in kernel_runs(fi, si, codes, chars, table, stable,
                                 name == "scan").items():
            r = row["queries"][q]
            r["kernel_ms"] = _median_ms(fn)
            if name != "scan":
                queued = [smoke.queued_ms(fn) for _ in range(TIMINGS)]
                r["queued_ms"] = (None if None in queued
                                  else statistics.median(queued))
        tsi.close_tables(m)
        rows.append(row)
        print(f"[trials] {name} (round {rnd}): " + "; ".join(
            f"{q} {r['launches']} wall {r['wall_ms']:.6f} ms, kernels "
            f"{r['kernel_ms']:.6f} ms"
            + (f", queued {r['queued_ms']}" if "queued_ms" in r else "")
            for q, r in row["queries"].items()) + f"  ({card})", flush=True)
    kernels._lib = libs["scan"]

    # the scans alone on the tables of 2 and 4 ranks, emulated here
    emulated = {}
    for model in (1, *EMULATED):
        shards = tsi.split_shards(fi.records, model, dev)
        sshards = tsi.split_shards(si.rec_all, model, dev)
        table = tsi.ShardTable(shards[0], 0, shards,
                               tsi.shard_ptrs(shards, dev))
        stable = tsi.ShardTable(sshards[0], 0, sshards,
                                tsi.shard_ptrs(sshards, dev))
        per = {}
        for q, fn in kernel_runs(fi, si, codes, chars, table, stable,
                                 True).items():
            per[q] = _median_ms(fn)
        emulated[model] = per
        del shards, sshards, table, stable
        torch.cuda.empty_cache()
        print(f"[trials] scans alone, {model} shard(s) of their own: "
              + ", ".join(f"{q} {ms:.6f} ms" for q, ms in per.items())
              + f"  ({card})", flush=True)

    # two ranks sharing the card, gloo, model = 2
    two = group_of_ranks(fi, si, codes_np, chars_np, ref, 2, 1, args.out,
                         card)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "lanes": lanes, "steps": W, "rounds": rows,
                   "emulated_ms": emulated, "two_ranks": two}, f, indent=1)
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
