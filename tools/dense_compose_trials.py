"""Kernel 14 (the dense PML scan) and kernel 7's compose (the paired
search records) of the port, against their parent's sources and against
variants, on the card, on the inputs of `chip_smoke.py`.

    python tools/dense_compose_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from `git
archive PARENT movi_tpu_torch/csrc`). The trial builds `dense_pml.cu`
and `compose_search2.cu` (and `fused_search.cu`, for
`movi_last_lanes_per_warp`) of each library into a library of its own:
the parent's; this tree's (kernel 14: codes two steps ahead from clamped
addresses, the next row issued before the store, few lanes spread; the
compose: tiles of consecutive runs at one a1, step 1 once a (run, a1),
step 2 one char a2 at a time with its first destinations issued before
step 1's last load lands, the tile written out with coalesced 16 B
stores); and each entry of VARIANTS ("14 codes ahead alone": this tree's
loop, every batch at 32 lanes a warp; "14 spread alone": the parent's
loop through the spread launch; "14 64-thread blocks": this tree's at
64-thread blocks where a warp carries 32 lanes; "14 unroll 1": this
tree's loop one step an iteration; "7 stores alone": one thread a
record, step 1 evaluated by each, staged through the shared tile; "7
step 1 once alone": this tree's threads storing straight to the table;
"7 step 2 after step 1": each char's destinations issued in its turn,
after step 1 has landed; "7 next early": the next char's destinations
issued with this one's last level; "7 kAhead 2", "7 kAhead 4": two or
four chars' loads in flight together; "7 128x16": registers capped for
16 blocks of 128 threads an SM (DNA's block only); "7 stcs": streaming
16 B stores; "7 tile 16", "7 tile 64": the tile's runs). A variant
whose patch no longer matches is left out, and the script says so. The
inputs are the smoke's own: phase 4's index (`chip_smoke.FULL_TEXT`),
its dense table and its batches of `chip_smoke.main_reads` in
`QUERY_LANES` for kernel 14, and the same index's run arrays and
next-run tables for the compose (phase 5's paired search table). It
times each library on every input in the order of ORDER (CUDA events,
`chip_smoke.cuda_ms`: an input's time is the median of TIMINGS means of
REPS calls) and requires every library's outputs (ml and state; the
whole table) to equal the parent's bit for bit. It prints each
library's registers a thread (`cuobjdump -res-usage`) and, per library,
kernel 14's ms a query and a batch with the lanes a warp each launch
carried and the µs a step of the 10 kb batch, the compose's ms and its
share of the bound (bytes over 3.35 TB/s, as the smoke counts them);
the share of (run, run+1) pairs at one a1 whose step-1 destination does
not decrease; and `tools/sass_inflight.py`'s report of both kernels'
main loops. It needs one CUDA card, `nvcc`, `cuobjdump` and `make` (for
`native/`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
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

SOURCES = ("dense_pml.cu", "compose_search2.cu", "fused_search.cu")
SPREAD_RULE = "return lanes <= sms ? 1 : 32;"
# the parent's kernel 14 through spread.cuh's launch (its loop unchanged)
SPREAD_ALONE = [
    ("dense_pml.cu", "#include <cstdint>\n",
     '#include <cstdint>\n\n#include "spread.cuh"\n'),
    ("dense_pml.cu",
     "    int* __restrict__ ml_state_out, int* __restrict__ ml) {\n"
     "    const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "    if (lane >= lanes) return;\n",
     "    int* __restrict__ ml_state_out, int* __restrict__ ml, int lpw) {\n"
     "    const int lane = movi::spread_lane(lpw);\n"
     "    if (lane < 0 || lane >= lanes) return;\n"),
    ("dense_pml.cu",
     "    const int block = 256;\n"
     "    const int grid = (lanes + block - 1) / block;\n"
     "    if (grid > 0) {\n"
     "        dense_pml_scan_kernel<<<grid, block, 0, "
     "(cudaStream_t)stream>>>(\n",
     "    movi::Spread s;\n"
     "    const cudaError_t e = movi::spread(lanes, 256, &s);\n"
     "    if (e != cudaSuccess) return (int)e;\n"
     "    if (lanes > 0) {\n"
     "        dense_pml_scan_kernel<<<s.grid, s.block, 0, "
     "(cudaStream_t)stream>>>(\n"),
    ("dense_pml.cu", "            (int*)ml_state_out, (int*)ml);\n",
     "            (int*)ml_state_out, (int*)ml, s.lpw);\n"),
]
# this tree's compose with one thread a record (step 1 evaluated by each
# of the sigma records of a (run, a1)), staged as this tree's
STORES_ALONE = [
    ("compose_search2.cu", "    const int a1 = threadIdx.x / kTileRuns;\n",
     "    const int a1 = threadIdx.x / kTileRuns % sigma;\n"),
    ("compose_search2.cu", "destinations(tab, r, sigma, 0, cc, d);",
     "destinations(tab, r, sigma, threadIdx.x / (kTileRuns * sigma), cc, "
     "d);"),
    ("compose_search2.cu",
     "        for (int c0 = 0; c0 < sigma; c0 += kAhead) {\n",
     "        for (int c0 = threadIdx.x / (kTileRuns * sigma); c0 < sigma;\n"
     "             c0 += sigma) {\n"),
    ("compose_search2.cu", "destinations(tab, r, sigma, c0 + kAhead, cc, d);",
     "destinations(tab, r, sigma, c0 + sigma, cc, d);"),
    ("compose_search2.cu",
     "compose_search2_kernel<<<(unsigned)grid, kTileRuns * sigma,",
     "compose_search2_kernel<<<(unsigned)grid, kTileRuns * sigma * sigma,"),
]
# this tree's threads storing each record straight into the table, three
# 8 B stores, with no shared tile
STRAIGHT = [
    ("compose_search2.cu",
     "                const int a = shift + 6 * (int)rec;\n"
     "                put2(smem, a, (int)w0, lo.A);\n"
     "                put2(smem, a + 2, hi.A, (int)w3);\n"
     "                put2(smem, a + 4, (int)w4, (int)w5);\n",
     "                int2* const row = reinterpret_cast<int2*>(dst + rec "
     "* 6);\n"
     "                row[0] = make_int2((int)w0, lo.A);\n"
     "                row[1] = make_int2(hi.A, (int)w3);\n"
     "                row[2] = make_int2((int)w4, (int)w5);\n"),
    ("compose_search2.cu", "    __syncthreads();\n", "    return;\n"),
    ("compose_search2.cu", "(size_t)stage_bytes(kTileRuns, s2),", "0,"),
]
# this tree's compose with step 2's first loads issued in each group's
# turn, after step 1's last load has landed
STEP2_AFTER = [
    ("compose_search2.cu",
     "        int d[2][kAhead];\n"
     "        destinations(tab, r, sigma, 0, cc, d);\n",
     "        int d[2][kAhead];\n"),
    ("compose_search2.cu",
     "            // the next chars' destinations\n"
     "            destinations(tab, r, sigma, c0 + kAhead, cc, d);\n", ""),
    ("compose_search2.cu",
     "        for (int c0 = 0; c0 < sigma; c0 += kAhead) {\n",
     "        for (int c0 = 0; c0 < sigma; c0 += kAhead) {\n"
     "            destinations(tab, r, sigma, c0, cc, d);\n"),
]
# this tree's compose with the next group's destinations issued with this
# group's last level, not after its stores
NEXT_EARLY = [
    ("compose_search2.cu",
     "            // step 2's last level (n at each id, for C2)\n",
     "            int dn[2][kAhead];\n"
     "            destinations(tab, r, sigma, c0 + kAhead, cc, dn);\n"),
    ("compose_search2.cu",
     "            // the next chars' destinations\n"
     "            destinations(tab, r, sigma, c0 + kAhead, cc, d);\n",
     "#pragma unroll\n"
     "            for (int k = 0; k < kAhead; ++k)\n"
     "                d[0][k] = dn[0][k], d[1][k] = dn[1][k];\n"),
]
KERNEL7 = "__global__ void compose_search2_kernel("
K_AHEAD = "constexpr int kAhead = 1;"
TILE = "constexpr int kTileRuns = 32;"


def bounds(blocks):
    """this tree's compose at most 128 threads a block, `blocks` blocks an
    SM (registers capped to fit): DNA's block only."""
    return [("compose_search2.cu", KERNEL7, KERNEL7.replace(
        "void ", f"void __launch_bounds__(128, {blocks}) "))]


VARIANTS = {  # name: (base, [(file, text, its replacement)])
    "this tree": ("here", []),
    "14 codes ahead alone": ("here", [("spread.cuh", SPREAD_RULE,
                                       "return 32;")]),
    "14 spread alone": ("parent", SPREAD_ALONE),
    "14 64-thread blocks": ("here", [("dense_pml.cu",
                                      "movi::spread(lanes, 256, &s)",
                                      "movi::spread(lanes, 64, &s)")]),
    "14 unroll 1": ("here", [("dense_pml.cu",
                              "        for (int t = 0; t < W; ++t) {\n",
                              "#pragma unroll 1\n"
                              "        for (int t = 0; t < W; ++t) {\n")]),
    "7 stores alone": ("here", STORES_ALONE),
    "7 step 1 once alone": ("here", STRAIGHT),
    "7 step 2 after step 1": ("here", STEP2_AFTER),
    "7 next early": ("here", NEXT_EARLY),
    "7 kAhead 2": ("here", [("compose_search2.cu", K_AHEAD,
                             "constexpr int kAhead = 2;")]),
    "7 kAhead 4": ("here", [("compose_search2.cu", K_AHEAD,
                             "constexpr int kAhead = 4;")]),
    "7 128x16": ("here", bounds(16)),
    "7 stcs": ("here", [("compose_search2.cu", "to[g] = v;",
                         "__stcs(&to[g], v);")]),
    "7 tile 16": ("here", [("compose_search2.cu", TILE,
                            "constexpr int kTileRuns = 16;")]),
    # a 64-run tile of six chars passes 48 KB: DNA's only
    "7 tile 64": ("here", [("compose_search2.cu", TILE,
                            "constexpr int kTileRuns = 64;"),
                           ("compose_search2.cu",
                            "constexpr int kMaxSigma = 6;",
                            "constexpr int kMaxSigma = 4;")]),
}
ORDER = ("parent", "this tree", "14 codes ahead alone", "14 spread alone",
         "14 64-thread blocks", "14 unroll 1", "7 stores alone",
         "7 step 1 once alone", "7 step 2 after step 1", "7 next early",
         "7 kAhead 2", "7 kAhead 4", "7 128x16", "7 stcs", "7 tile 16",
         "7 tile 64", "this tree", "parent")
REPS = 10
TIMINGS = 5  # an input's time: the median of this many means of REPS calls
# mangled: kernel 14, the compose
SASS_FUNCTIONS = ("21dense_pml_scan_kernel", "22compose_search2_kernelEPKi")


def registers(so, function):
    """`cuobjdump -res-usage`'s registers of the first function of a
    library whose mangled name holds `function`."""
    cuobjdump = os.path.join(os.path.dirname(shutil.which("nvcc") or
                                             "/usr/local/cuda/bin/nvcc"),
                             "cuobjdump")
    out = subprocess.run([cuobjdump, "-res-usage", so], capture_output=True,
                         text=True).stdout.splitlines()
    for i, line in enumerate(out):
        if "Function" in line and function in line and i + 1 < len(out):
            reg = re.search(r"REG:(\d+)", out[i + 1])
            return f"{function} {reg.group(1) if reg else '?'}"
    return f"{function} ?"


def lf_order(ix):
    """Per direction and a1, the share of (run, run+1) pairs whose step-1
    destination run A1 does not decrease (sentinels as the compose makes
    them)."""
    nu, nd = ix.next_tables_search()
    r = ix.r
    ids = np.asarray(ix.id_arr).astype(np.int64)
    out = {}
    for name, tab, sent in (("down", nd, 0x1FFFFFF), ("up", nu, 0)):
        for a1 in range(ix.sigma):
            d = np.asarray(tab[a1]).astype(np.int64)
            A = np.where(d < r, ids[np.clip(d, 0, r - 1)], sent)
            out[f"{name} a1={a1}"] = float((A[1:] >= A[:-1]).mean())
    return out


def inputs(dev):
    """(runs, facts): per input (what, label, fn, args) for kernel 14's
    batches and the compose, and what the report needs."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import dense as td
    from movi_tpu_torch.testing import index_from_text, random_text

    t0 = time.perf_counter()
    text = random_text(smoke.FULL_TEXT, 0)
    ix = index_from_text(text)
    r, sigma = ix.r, ix.sigma
    eng = td.DensePMLEngine(td.build_dense_index(ix), dev)
    di = eng.di
    slots = di.sigma + 1
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    runs = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        codes = eng.prepare(b)
        runs.append(("dense", tuple(codes.shape), kernels.dense_pml_scan,
                     (di.table, slots, codes,
                      td.initial_state(di, codes.shape[1], dev))))
    comp = smoke.compose_inputs(ix, dev)
    runs.append(("compose", (r,), kernels.compose_search2_records,
                 (*comp, r, sigma)))
    nbytes = 4 * r * (3 + 2 * sigma) + 24 * 2 * r * sigma * sigma
    bound_ms = smoke.bound(nbytes, 2 * r * sigma * sigma
                           * smoke.OPS_PER_ROW)[0]
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"r={r}, dense table {di.table.numel() * 4} B, paired search "
          f"table {nbytes - 4 * r * (3 + 2 * sigma)} B", flush=True)
    return runs, dict(r=r, order=lf_order(ix), bound_ms=bound_ms)


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
        print("dense_compose_trials: no CUDA card", file=sys.stderr)
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
                                   "dense_pml.cu")) as f:
                spread[name] = "movi::spread(" in f.read()
        for name, (so, procs, link) in started.items():
            finish(procs, link, name)
            libs[name] = load(so)
        print(f"[trials] built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name in libs:
        so = os.path.join(args.out, name.replace(" ", "_") + ".so")
        sass = disassemble(so)
        with open(so[:-3] + ".sass", "w") as f:
            f.write(sass)
        for fn in SASS_FUNCTIONS:
            try:
                print(f"[trials] SASS {name} {report(sass, fn)}", flush=True)
            except KeyError:
                pass  # not a kernel of this library
        print(f"[trials] registers {name}: " + "; ".join(
            registers(so, fn) for fn in SASS_FUNCTIONS if fn in sass),
            flush=True)

    runs, facts = inputs(dev)
    print(f"[trials] LF order on r={facts['r']}: share of (run, run+1) "
          f"pairs at one a1 whose step-1 destination does not decrease: "
          + ", ".join(f"{k} {v:.6f}" for k, v in facts["order"].items()),
          flush=True)
    old_lib = kernels._lib
    ref, times, lpws = {}, {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    for rnd, name in order:
        lib = kernels._lib = libs[name]
        for i, (what, shape, fn, a) in enumerate(runs):
            out = fn(*a)
            torch.cuda.synchronize()
            flat = [t.clone() for t in _flat(out)]
            if i not in ref:
                ref[i] = flat
            elif not all(torch.equal(x, y) for x, y in zip(flat, ref[i])):
                raise AssertionError(f"{name}: {what} {shape} differs from "
                                     f"the parent's")
            del out, flat
            torch.cuda.empty_cache()
            ms = statistics.median(smoke.cuda_ms(lambda: fn(*a), REPS)
                                   for _ in range(TIMINGS))
            # a launch without the spread carries 32 lanes a warp
            lpw = (int(lib.movi_last_lanes_per_warp())
                   if what == "dense" and spread[name] else 32)
            times.setdefault((name, rnd), []).append(ms)
            lpws.setdefault((name, rnd), []).append(lpw)
            torch.cuda.empty_cache()
    kernels._lib = old_lib

    rows = []
    k14 = [i for i, x in enumerate(runs) if x[0] == "dense"]
    ci = next(i for i, x in enumerate(runs) if x[0] == "compose")
    long_i = max(k14, key=lambda i: runs[i][1][0])
    steps = runs[long_i][1][0]
    for (name, rnd), per in times.items():
        row = dict(library=name, round=rnd,
                   dense_query_ms=sum(per[i] for i in k14),
                   dense_batches=[dict(shape=runs[i][1], ms=per[i],
                                       lanes_per_warp=lpws[name, rnd][i])
                                  for i in k14],
                   dense_long_steps=steps,
                   dense_us_per_step=per[long_i] * 1e3 / steps,
                   compose_ms=per[ci],
                   compose_bound_share=facts["bound_ms"] / per[ci])
        rows.append(row)
        print(f"[trials] {name} (round {rnd}): kernel 14 query "
              f"{row['dense_query_ms']:.6f} ms; per batch " + ", ".join(
                  f"{b['shape'][1]}x{b['shape'][0]} ({b['lanes_per_warp']} "
                  f"a warp): {b['ms']:.6f}" for b in row["dense_batches"])
              + f"; 10 kb {row['dense_us_per_step']:.6f} us a step of "
              f"{steps}; compose {row['compose_ms']:.6f} ms = "
              f"{row['compose_bound_share']:.6f} of its bound "
              f"{facts['bound_ms']:.6f} ms  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "lf_order": facts["order"],
                   "compose_bound_ms": facts["bound_ms"], "rows": rows},
                  f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
