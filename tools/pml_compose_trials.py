"""Kernels 1 (the one-step PML scan) and 2 (the paired compose, PML and
color forms) of the port, against their parent's sources and against
variants, on the card, on the inputs of `chip_smoke.py`'s main path.

    python tools/pml_compose_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from
`git archive PARENT movi_tpu_torch/csrc`).  The trial builds
`fused_pml.cu` and `compose2.cu` (and `fused_search.cu`, for
`movi_last_lanes_per_warp`) of each library into a library of its own:
the parent's; this tree's; and each entry of VARIANTS, a list of patches
on the parent's or this tree's sources ("A alone": kernel 1's codes
ahead, every batch at 32 lanes a warp; "B alone": the parent's loop
through the spread launch; "B2": this tree's at 64-thread blocks where a
warp carries 32 lanes; "C alone": the parent's compose with one B-range
atomic pair a block; "D stcs": this tree's compose with streaming
stores; "D a1 in turn": this tree's compose with one thread a run,
looping over a1; "D T 64": 64-run tiles, which the color form's shared
memory halves back to 32; "D T 16": 16-run tiles).  A variant whose patch no
longer matches is left out, and the script says so.  The inputs are the smoke's own: phase 4's index
(`chip_smoke.FULL_TEXT`), its reads and batches (`chip_smoke.main_reads`,
`QUERY_LANES`), and phase 7's 12-genome pangenome and color ids.  It
times each library on every input in the order of ORDER and requires
every library's outputs (ml and state; table and B range) to equal the
parent's bit for bit.  It prints, per library, kernel 1's ms per query
and per batch with the lanes a warp each launch carried and the µs a
step of the 10 kb batch, and the two composes' ms; the share of (run,
run+1) pairs at one a1 whose destination does not decrease; and
`tools/sass_inflight.py`'s report of the kernels' main loops.  It needs
one CUDA card, `nvcc`, `cuobjdump` and `make` (for `native/`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.sass_inflight import disassemble, report  # noqa: E402
from tools.tick_trials import _flat, build, finish, load  # noqa: E402

SOURCES = ("fused_pml.cu", "compose2.cu", "fused_search.cu")
SPREAD_RULE = "return lanes <= sms ? 1 : 32;"
# the parent's kernel 1 through spread.cuh's launch (its loop unchanged)
B_ALONE = [
    ("fused_pml.cu", '#include "records.cuh"\n',
     '#include "records.cuh"\n#include "spread.cuh"\n'),
    ("fused_pml.cu",
     "    int* __restrict__ ml) {\n"
     "    const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "    if (lane >= lanes) return;\n",
     "    int* __restrict__ ml, int lpw) {\n"
     "    const int lane = movi::spread_lane(lpw);\n"
     "    if (lane < 0 || lane >= lanes) return;\n"),
    ("fused_pml.cu",
     "    const int block = 256;\n"
     "    const int grid = (lanes + block - 1) / block;\n"
     "    if (grid > 0) {\n"
     "        fused_pml_scan_kernel<<<grid, block, 0, "
     "(cudaStream_t)stream>>>(\n",
     "    movi::Spread s;\n"
     "    const cudaError_t e = movi::spread(lanes, 256, &s);\n"
     "    if (e != cudaSuccess) return (int)e;\n"
     "    if (lanes > 0) {\n"
     "        fused_pml_scan_kernel<<<s.grid, s.block, 0, "
     "(cudaStream_t)stream>>>(\n"),
    ("fused_pml.cu", "            (int*)ml_state_out, (int*)ml);\n",
     "            (int*)ml_state_out, (int*)ml, s.lpw);\n"),
]
# the parent's compose with the warps' B ranges reduced across the block
C_ALONE = [(
    "compose2.cu",
    "    if ((threadIdx.x & 31) == 0) {\n"
    "        atomicMin(&bminmax[0], bmin);\n"
    "        atomicMax(&bminmax[1], bmax);\n"
    "    }\n",
    "    __shared__ int red[2][32];\n"
    "    if ((threadIdx.x & 31) == 0) {\n"
    "        red[0][threadIdx.x >> 5] = bmin;\n"
    "        red[1][threadIdx.x >> 5] = bmax;\n"
    "    }\n"
    "    __syncthreads();\n"
    "    if (threadIdx.x == 0) {\n"
    "        for (int w = 1; w < (int)(blockDim.x >> 5); ++w) {\n"
    "            bmin = min(bmin, red[0][w]);\n"
    "            bmax = max(bmax, red[1][w]);\n"
    "        }\n"
    "        atomicMin(&bminmax[0], bmin);\n"
    "        atomicMax(&bminmax[1], bmax);\n"
    "    }\n")]
VARIANTS = {  # name: (base, [(file, text, its replacement)])
    "this tree": ("here", []),
    "A alone": ("here", [("spread.cuh", SPREAD_RULE, "return 32;")]),
    "B alone": ("parent", B_ALONE),
    "B2": ("here", [("fused_pml.cu", "movi::spread(lanes, 256, &s)",
                     "movi::spread(lanes, 64, &s)")]),
    "C alone": ("parent", C_ALONE),
    "D stcs": ("here", [("compose2.cu", "to[i] = recs[i];",
                         "__stcs(&to[i], recs[i]);")]),
    "D a1 in turn": ("here", [
        ("compose2.cu",
         "    const int a1 = threadIdx.x / tile;\n"
         "    const int j = threadIdx.x - a1 * tile;\n"
         "    int bmin = INT_MAX;\n"
         "    int bmax = INT_MIN;\n"
         "    if (a1 < slots && j < nrun) {\n",
         "    const int j = threadIdx.x;\n"
         "    int bmin = INT_MAX;\n"
         "    int bmax = INT_MIN;\n"
         "    if (j < nrun) for (int a1 = 0; a1 < slots; ++a1) {\n"),
        ("compose2.cu", "const int block = (tile * slots + 31) / 32 * 32;",
         "const int block = (tile + 31) / 32 * 32;")]),
    "D T 64": ("here", [("compose2.cu", "constexpr int kTileRuns = 32;",
                         "constexpr int kTileRuns = 64;")]),
    "D T 16": ("here", [("compose2.cu", "constexpr int kTileRuns = 32;",
                         "constexpr int kTileRuns = 16;")]),
}
ORDER = ("parent", "this tree", "A alone", "B alone", "B2", "C alone",
         "D stcs", "D a1 in turn", "D T 64", "D T 16", "this tree",
         "parent")
REPS = {"pml": 10, "compose": 10, "color compose": 10}
# mangled: kernel 1, kernel 2's PML and color forms
SASS_FUNCTIONS = ("21fused_pml_scan_kernel", "21compose_paired_kernelILb0E",
                  "21compose_paired_kernelILb1E")


def lf_order(records, r, slots):
    """Per a1, the share of (run, run+1) pairs whose one-step destination
    m does not decrease."""
    m = records.reshape(r, slots, 2)[..., 0]
    return [float((m[1:, a] >= m[:-1, a]).mean()) for a in range(slots)]


def inputs(dev):
    """(runs, facts): per input (kind, label, fn, args) for kernel 1's
    batches and the two composes, and what the report needs."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.testing import (colored_index, index_from_text,
                                        pangenome, random_text)

    t0 = time.perf_counter()
    text = random_text(smoke.FULL_TEXT, 0)
    fi = tf.build_fused_index(index_from_text(text)).to(dev)
    slots = fi.sigma + 1
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    eng = tf.FusedPMLEngine(fi, dev)
    runs = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        codes = eng.prepare(b)
        runs.append(("pml", tuple(codes.shape), kernels.fused_pml_scan,
                     (fi.records, slots, fi.p_dollar, codes,
                      tf.initial_state(fi, codes.shape[1], dev))))
    runs.append(("compose", (fi.r,), kernels.compose_paired_records,
                 (fi.records, fi.r, slots, fi.p_dollar)))
    order = lf_order(fi.records.cpu().numpy(), fi.r, slots)
    gen = pangenome(smoke.COLOR_GENOMES, smoke.COLOR_GENOME_LEN)
    ix, ct = colored_index(gen, [1000 + g for g in
                                 range(smoke.COLOR_GENOMES)])
    ci = tf.build_fused_index(ix).to(dev)
    cids = torch.from_numpy(np.minimum(ct.doc_set_inds,
                                       len(ct.unique_doc_sets))
                            .astype(np.int32)).to(dev)
    runs.append(("color compose", (ci.r,),
                 kernels.compose_paired_color_records,
                 (ci.records, cids, ci.r, ci.sigma + 1, ci.p_dollar)))
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"PML r={fi.r}, color r={ci.r}", flush=True)
    return runs, dict(r=fi.r, order=order)


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
        print("pml_compose_trials: no CUDA card", file=sys.stderr)
        return 1
    from movi_tpu_torch import kernels
    from movi_tpu_torch.build.suffix import _load_native
    from movi_tpu_torch.device import card_line, resolve_device

    mk = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                        capture_output=True, text=True, timeout=600)
    if mk.returncode != 0 or not _load_native():
        raise RuntimeError(f"make -C native failed:\n{mk.stderr}")
    dev = resolve_device("cuda")
    card = card_line(dev)
    print(card, flush=True)
    os.makedirs(args.out, exist_ok=True)
    here = os.path.join(ROOT, "movi_tpu_torch", "csrc")
    bases = {"parent": args.parent, "here": here}
    libs, spread = {}, {}
    with tempfile.TemporaryDirectory(dir=args.out) as work:
        t0 = time.perf_counter()
        jobs = {"parent": (args.parent, [])}
        jobs.update({name: (bases[base], p)
                     for name, (base, p) in VARIANTS.items()})
        started = {}
        for name, (csrc, patches) in jobs.items():
            so = os.path.join(args.out, name.replace(" ", "_") + ".so")
            job = build(csrc, so, patches, work, SOURCES)
            if job is None:
                print(f"[trials] {name}: its patch no longer matches; left "
                      f"out", flush=True)
                continue
            started[name] = (so, *job)
            with open(os.path.join(work, os.path.basename(so) + ".src",
                                   "fused_pml.cu")) as f:
                spread[name] = "movi::spread(" in f.read()
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

    runs, facts = inputs(dev)
    print(f"[trials] LF order on r={facts['r']}: share of (run, run+1) "
          f"pairs at one a1 whose m does not decrease, per a1 "
          + ", ".join(f"{s:.6f}" for s in facts["order"]), flush=True)
    old_lib = kernels._lib
    ref, times, lpws = {}, {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    for rnd, name in order:
        lib = kernels._lib = libs[name]
        for i, (what, shape, fn, a) in enumerate(runs):
            out = fn(*a)
            torch.cuda.synchronize()
            flat = [t.clone() if torch.is_tensor(t) else t
                    for t in _flat(out)]
            if i not in ref:
                ref[i] = flat
            elif not all(torch.equal(x, y) if torch.is_tensor(x) else x == y
                         for x, y in zip(flat, ref[i])):
                raise AssertionError(f"{name}: {what} {shape} differs from "
                                     f"the parent's")
            del out, flat
            ms = smoke.cuda_ms(lambda: fn(*a), REPS[what])
            # a launch without the spread carries 32 lanes a warp
            lpw = (int(lib.movi_last_lanes_per_warp()) if spread[name]
                   else 32)
            times.setdefault((name, rnd), []).append(ms)
            lpws.setdefault((name, rnd), []).append(lpw)
            torch.cuda.empty_cache()
    kernels._lib = old_lib

    rows = []
    for (name, rnd), per in times.items():
        row = dict(library=name, round=rnd)
        k1 = [i for i, x in enumerate(runs) if x[0] == "pml"]
        row["pml_query_ms"] = sum(per[i] for i in k1)
        row["pml_batches"] = [dict(shape=runs[i][1], ms=per[i],
                                   lanes_per_warp=lpws[name, rnd][i])
                              for i in k1]
        long_i = max(k1, key=lambda i: runs[i][1][0])
        steps = runs[long_i][1][0]
        row["pml_long_steps"] = steps
        row["pml_us_per_step"] = per[long_i] * 1e3 / steps
        for i, (what, shape, _, _) in enumerate(runs):
            if what != "pml":
                row[what.replace(" ", "_") + "_ms"] = per[i]
        rows.append(row)
        print(f"[trials] {name} (round {rnd}): kernel 1 query "
              f"{row['pml_query_ms']:.6f} ms; per batch " + ", ".join(
                  f"{b['shape'][1]}x{b['shape'][0]} ({b['lanes_per_warp']} "
                  f"a warp): {b['ms']:.6f}" for b in row["pml_batches"])
              + f"; 10 kb {row['pml_us_per_step']:.6f} us a step of "
              f"{steps}; compose PML {row['compose_ms']:.6f} ms, color "
              f"{row['color_compose_ms']:.6f} ms  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "lf_order": facts["order"], "rows": rows},
                  f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
