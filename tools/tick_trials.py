"""Kernels 6 (the one-step count and ZML scans) and 10b (the BML machine)
of the port, against their parent's sources and against variants of
this tree's, on the card, on the batches of `chip_smoke.py`'s main path.

    python tools/tick_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from
`git archive PARENT movi_tpu_torch/csrc`).  The trial times only
`fused_search.cu` and `fused_mem2.cu`: it builds these two sources of
each library into a library of its own: the parent's; this tree's; and
this tree's with one of the patches of VARIANTS applied ("plans both":
10b plans both outcomes' next ticks while the rows fly; "no spread":
every batch at 32 lanes a warp, the pipelined loops alone; "spread all":
one lane a warp at every batch size).  A variant whose patch no longer
matches this tree's source is left out, and the script says so.  The
inputs are the smoke's own (`chip_smoke.main_reads` and its sizes).  It
times each library on every batch in the order of ORDER, and requires
every library's outputs to equal the parent's bit for bit.  It prints,
per library and batch, the milliseconds (CUDA events), the lanes a warp
the launch carried, and for the 10 kb batch the time per tick or step of
its longest lane; it writes the parent's and this tree's SASS to OUT and
prints `tools/sass_inflight.py`'s report of the kernels' main loops.  It
needs one CUDA card, `nvcc`, `cuobjdump` and `make` (for `native/`).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.sass_inflight import disassemble, report  # noqa: E402

SOURCES = ("fused_search.cu", "fused_mem2.cu")
SPREAD_RULE = "return lanes <= sms ? 1 : 32;"
CB = ("        const int cb1 = q1.phase == INIT ? row[ix1.y] : 0;\n")
PLAN_AFTER = ("        P = bml_plan(q, ok ? ca0 : ca1, ok ? cb0 : cb1, m, L, "
              "use_ftab, r,\n                     sigma);\n")
VARIANTS = {  # name: [(file, text, its replacement)] in this tree's csrc
    "this tree": [],
    "plans both": [
        ("fused_mem2.cu", CB, CB + "        const BmlPlan P0 = bml_plan("
         "q0, ca0, cb0, m, L, use_ftab, r, sigma);\n        const BmlPlan "
         "P1 = bml_plan(q1, ca1, cb1, m, L, use_ftab, r, sigma);\n"),
        ("fused_mem2.cu", PLAN_AFTER, "        P = ok ? P0 : P1;\n")],
    "no spread": [("spread.cuh", SPREAD_RULE, "return 32;")],
    "spread all": [("spread.cuh", SPREAD_RULE, "return 1;")],
}
ORDER = ("parent", "this tree", "plans both", "no spread", "spread all",
         "this tree", "parent")
REPS = 5
# mangled: the BML machine, then the ZML and count scans
SASS_FUNCTIONS = ("11mem2_kernel", "24fused_search_scan_kernelILb1E",
                  "24fused_search_scan_kernelILb0E")


def build(csrc: str, out_so: str, patches, work: str, sources=SOURCES):
    """Start nvcc on `sources` of a copy of csrc with `patches` applied;
    return the processes and the link step, or None where a patch no
    longer matches."""
    from movi_tpu_torch import kernels

    src = os.path.join(work, os.path.basename(out_so) + ".src")
    shutil.copytree(csrc, src)
    for name, old, new in patches:
        p = os.path.join(src, name)
        with open(p) as f:
            text = f.read()
        if old not in text:
            return None
        with open(p, "w") as f:
            f.write(text.replace(old, new))
    nvcc = kernels._nvcc()
    objs, procs = [], []
    for name in sources:
        obj = os.path.join(src, name + ".o")
        log = open(obj + ".log", "w+")
        procs.append((subprocess.Popen(
            [nvcc, *kernels.NVCC_FLAGS, "-c", os.path.join(src, name),
             "-o", obj], stdout=log, stderr=subprocess.STDOUT), log))
        objs.append(obj)
    return procs, [nvcc, *kernels.NVCC_FLAGS, "-shared", "-o", out_so, *objs]


def finish(procs, link, what: str):
    """Wait for a build and link it."""
    for proc, log in procs:
        rc = proc.wait()
        log.seek(0)
        text = log.read()
        log.close()
        if rc != 0:
            raise RuntimeError(f"nvcc failed for {what}:\n{text}")
    res = subprocess.run(link, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"link failed for {what}:\n{res.stderr}")


def load(so: str):
    from movi_tpu_torch import kernels

    lib = ctypes.CDLL(so)
    for name, argtypes in kernels._SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def inputs(dev):
    """Per batch (what, batch, fn, args): kernel 6's count and ZML scans
    on the smoke's search index and reads, and kernel 10b on its MEM
    phase's."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.testing import (index_from_text, random_text,
                                        with_revcomp)

    t0 = time.perf_counter()
    text = random_text(smoke.FULL_TEXT, 0)
    si = ts.build_fused_search_index(index_from_text(text)).to(dev)
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    search = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        chars = ts.FusedCountEngine(si, dev).prepare(b)
        search.append(("count", b, kernels.fused_count_scan,
                       (si.rec_all, si.init_rec, si.all_p, si.r, si.sigma,
                        chars)))
        chars = ts.FusedZMLEngine(si, dev).prepare(b)
        search.append(("zml", b, kernels.fused_zml_scan,
                       (si.rec_all, si.init_rec, si.r, si.sigma, chars)))
    half = random_text(smoke.MEM_RC_HALF, 1)
    eng = Index(index_from_text(with_revcomp(half))).mem_engine(smoke.MEM_L,
                                                                dev)
    mreads = smoke.main_reads(half, smoke.MEM_LANES, smoke.LONG_READS,
                              smoke.LONG_LEN, smoke.MEM_SEED, "m")
    mem = []
    m2 = eng.m2
    for b in _as_batches(mreads, smoke.QUERY_LANES):
        alc, state, cap = eng.prepare(b)
        mem.append(("bml", b, kernels.mem2_scan,
                    (m2.rec_all, m2.init_rec6, m2.r, m2.sigma, m2.n,
                     m2.ftab_k, alc, state, smoke.MEM_L, cap, eng.use_ftab)))
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"search r={si.r}, MEM table {m2.rec_all.numel() * 4} B",
          flush=True)
    return search + mem


def _flat(out):
    """A run's outputs as a list of tensors."""
    if isinstance(out, dict):
        return [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in _flat(o)]
    return [out]


def main(argv=None) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the parent commit's csrc directory")
    ap.add_argument("--out", required=True,
                    help="a directory for the libraries, their SASS and "
                         "trials.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("tick_trials: no CUDA card", file=sys.stderr)
        return 1
    from movi_tpu_torch import kernels
    from movi_tpu_torch.build.suffix import _load_native
    from movi_tpu_torch.device import card_line, resolve_device

    # the host SA-IS of the index builds, as the smoke makes it
    mk = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                        capture_output=True, text=True, timeout=600)
    if mk.returncode != 0 or not _load_native():
        raise RuntimeError(f"make -C native failed:\n{mk.stderr}")
    dev = resolve_device("cuda")
    card = card_line(dev)
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    here = os.path.join(ROOT, "movi_tpu_torch", "csrc")
    libs = {}
    with tempfile.TemporaryDirectory(dir=args.out) as work:
        t0 = time.perf_counter()
        jobs = {"parent": (args.parent, [])}
        jobs.update({name: (here, p) for name, p in VARIANTS.items()})
        started = {}
        for name, (csrc, patches) in jobs.items():
            so = os.path.join(args.out, name.replace(" ", "_") + ".so")
            job = build(csrc, so, patches, work)
            if job is None:
                print(f"[trials] {name}: its patch no longer matches this "
                      f"tree's source; left out", flush=True)
                continue
            started[name] = (so, *job)
        for name, (so, procs, link) in started.items():
            finish(procs, link, name)
            libs[name] = load(so)
        print(f"[trials] built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in ("parent", "this tree"):
        so = os.path.join(args.out, name.replace(" ", "_") + ".so")
        sass = disassemble(so)
        with open(so[:-3] + ".sass", "w") as f:
            f.write(sass)
        for fn in SASS_FUNCTIONS:
            print(f"[trials] SASS {name} {report(sass, fn)}", flush=True)

    runs = inputs(dev)
    old_lib = kernels._lib
    ref, times, shapes = {}, {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    for rnd, name in order:
        lib = kernels._lib = libs[name]
        for i, (what, b, fn, a) in enumerate(runs):
            out = fn(*a)
            torch.cuda.synchronize()
            flat = [t.clone() for t in _flat(out)]
            if i not in ref:
                ref[i] = (flat, out)
            elif not all(torch.equal(x, y) for x, y in zip(flat, ref[i][0])):
                raise AssertionError(f"{name}: {what} batch {i} differs from "
                                     f"the parent's")
            ms = smoke.cuda_ms(lambda: fn(*a), REPS)
            # the parent's launch has no record: it carries 32 a warp
            lpw = (int(lib.movi_last_lanes_per_warp())
                   if hasattr(lib, "movi_last_lanes_per_warp") else 32)
            times.setdefault((name, rnd), []).append(ms)
            shapes.setdefault((name, rnd), []).append(lpw)
    kernels._lib = old_lib

    rows = []
    for (name, rnd), per in times.items():
        for what in ("count", "zml", "bml"):
            idx = [i for i, r in enumerate(runs) if r[0] == what]
            row = dict(library=name, round=rnd, kernel=what,
                       query_ms=sum(per[i] for i in idx),
                       batches_ms=[per[i] for i in idx],
                       shapes=[tuple(runs[i][1].seqs.shape) for i in idx],
                       lanes_per_warp=[shapes[name, rnd][i] for i in idx])
            for i in idx:
                if runs[i][1].width < smoke.LONG_LEN // 2:
                    continue
                out = ref[i][1]
                if what == "bml":
                    work = out[1]
                    ticks = int(work[0].max())
                    row["long_ticks"] = ticks
                    row["long_step_ticks"] = int(work[2].max())
                    row["us_per_tick"] = per[i] * 1e3 / ticks
                elif what == "zml":
                    steps = runs[i][1].width - 1
                    row["long_steps"] = steps
                    row["us_per_step"] = per[i] * 1e3 / steps
            rows.append(row)
            print(f"[trials] {name} (round {rnd}) {what}: query "
                  f"{row['query_ms']:.6f} ms; per batch " + ", ".join(
                      f"{s[0]}x{s[1]} ({w} a warp): {ms:.6f}"
                      for s, w, ms in zip(row["shapes"],
                                          row["lanes_per_warp"],
                                          row["batches_ms"]))
                  + "".join(f"; {k} {v:.6f}" if isinstance(v, float)
                            else f"; {k} {v}" for k, v in row.items()
                            if k.startswith(("long_", "us_")))
                  + f"  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
