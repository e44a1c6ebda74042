"""Kernels 5 (the one-step color scan, all four forms) and 7 (the paired
count and ZML scans) of the port, against their parent's sources and
against variants, on the card, on the inputs of `chip_smoke.py`.

    python tools/color_search2_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from
`git archive PARENT movi_tpu_torch/csrc`).  The trial builds
`fused_color.cu` and `fused_search2.cu` (and `fused_search.cu`, for
`movi_last_lanes_per_warp`) of each library into a library of its own:
the parent's; this tree's; and each entry of VARIANTS ("A alone": this
tree's loops, codes two steps ahead and stores after the next issue,
every batch at 32 lanes a warp; "C alone": the parent's loops through
the spread launch; "codes selected": the code two steps on selected
against 0 past the last step, not loaded from a clamped address; "issue
gated": the next rows issued only for a step that runs; "no sink":
kernel 5's early-stop forms without `sink`; "unroll 2": both loops
unrolled twice).  A variant whose patch no longer matches is left out,
and the script says so.  The inputs are the smoke's own: phase 7's
12-genome pangenome and reads (`chip_smoke.color_reads`), the two-load
form's 24-genome pangenome compressed to 2^16 sets, and phase 5's index
and reads (`chip_smoke.main_reads`), each in the batches of
`QUERY_LANES`.  It times each library on every batch in the order of
ORDER (CUDA events, `chip_smoke.cuda_ms`) and requires every library's
outputs (ml, color ids or counts, and the state) to equal the parent's
bit for bit.  It prints, per library and kernel form, the ms a query
and a batch with the lanes a warp each launch carried and the µs a step
of the 10 kb batch (kernel 5: its width, or with early stop the longest
lane's steps; ZML: its pair steps; count: its longest lane's pair
steps), and `tools/sass_inflight.py`'s report of the kernels' main
loops.  It needs one CUDA card, `nvcc`, `cuobjdump` and `make` (for
`native/`).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.sass_inflight import disassemble, report  # noqa: E402
from tools.tick_trials import _flat, build, finish, load  # noqa: E402

SOURCES = ("fused_color.cu", "fused_search2.cu", "fused_search.cu")
SPREAD_RULE = "return lanes <= sms ? 1 : 32;"
# the parent's kernel 5 and kernel 7 through spread.cuh's launch, their
# loops unchanged
LANE = ("    const int lane = blockIdx.x * blockDim.x + threadIdx.x;\n"
        "    if (lane >= lanes) return;\n")
SPREAD_LANE = ("    const int lane = movi::spread_lane(lpw);\n"
               "    if (lane < 0 || lane >= lanes) return;\n")
C_ALONE = [
    ("fused_color.cu", '#include "records.cuh"\n',
     '#include "records.cuh"\n#include "spread.cuh"\n'),
    ("fused_color.cu", "    int* __restrict__ ml, int* __restrict__ cid) {\n"
     + LANE, "    int* __restrict__ ml, int* __restrict__ cid, int lpw) {\n"
     + SPREAD_LANE),
    ("fused_color.cu",
     "    const int block = 256;\n"
     "    const int grid = (lanes + block - 1) / block;\n",
     "    movi::Spread s;\n"
     "    const cudaError_t e = movi::spread(lanes, 256, &s);\n"
     "    if (e != cudaSuccess) return (int)e;\n"
     "    const int block = s.block;\n"
     "    const int grid = lanes > 0 ? s.grid : 0;\n"),
    ("fused_color.cu", "        (int*)stop_out, (int*)ml, (int*)cid);\n",
     "        (int*)stop_out, (int*)ml, (int*)cid, s.lpw);\n"),
    ("fused_search2.cu", '#include "search2.cuh"\n',
     '#include "search2.cuh"\n#include "spread.cuh"\n'),
    ("fused_search2.cu", "    int* __restrict__ out) {\n",
     "    int* __restrict__ out, int lpw) {\n"),
    ("fused_search2.cu", LANE, SPREAD_LANE),
    ("fused_search2.cu",
     "    const int block = 256;\n"
     "    const int grid = (lanes + block - 1) / block;\n",
     "    movi::Spread s;\n"
     "    const cudaError_t e = movi::spread(lanes, 256, &s);\n"
     "    if (e != cudaSuccess) return (int)e;\n"
     "    const int block = s.block;\n"
     "    const int grid = lanes > 0 ? s.grid : 0;\n"),
    ("fused_search2.cu",
     "                sigma, first, (const int*)st_in, (int*)st_out, "
     "(int*)out);\n",
     "                sigma, first, (const int*)st_in, (int*)st_out, "
     "(int*)out,\n                s.lpw);\n"),
]
# this tree's loops with the code two steps on selected (0 past the last
# step) rather than loaded from a clamped address
CODES_SELECTED = [
    ("fused_color.cu", "alphas[t + 2 < steps ? at + 2 * lanes_s : at];",
     "t + 2 < steps ? alphas[at + 2 * lanes_s] : 0;"),
    ("fused_search2.cu", "pairs[t + 2 < W2 ? at + 2 * lanes_s : at];",
     "t + 2 < W2 ? pairs[at + 2 * lanes_s] : 0;")]
UNROLL2 = [
    ("fused_color.cu", "        for (int t = 0; t < steps; ++t) {\n",
     "#pragma unroll 2\n        for (int t = 0; t < steps; ++t) {\n"),
    ("fused_search2.cu", "        for (int t = 0; t < W2; ++t) {\n",
     "#pragma unroll 2\n        for (int t = 0; t < W2; ++t) {\n")]
# this tree's loops with the next step's rows issued only for a step that
# runs
ISSUE_GATED = [
    ("fused_color.cu", "            rec = load_row<THREE>(records, "
     "(int64_t)idx * slots + a_next);\n",
     "            if (t + 1 < steps)\n                rec = load_row<THREE>("
     "records, (int64_t)idx * slots + a_next);\n"),
    ("fused_search2.cu",
     "            rows = movi::bs2_rows(rec_all, r, S2, cur, pn.a12);\n",
     "            if (t + 1 < W2 && (ZML || !y))\n                rows = "
     "movi::bs2_rows(rec_all, r, S2, cur, pn.a12);\n")]
# this tree's kernel 5 without the early-stop form's `sink`, so that the
# compiler may sink its next row below the stop test
NO_SINK = [("fused_color.cu",
            "sink = (rec.pml.x | rec.pml.y | rec.wc | a_next) & keep;",
            "sink = 0;")]
VARIANTS = {  # name: (base, [(file, text, its replacement)])
    "this tree": ("here", []),
    "A alone": ("here", [("spread.cuh", SPREAD_RULE, "return 32;")]),
    "C alone": ("parent", C_ALONE),
    "codes selected": ("here", CODES_SELECTED),
    "issue gated": ("here", ISSUE_GATED),
    "no sink": ("here", NO_SINK),
    "unroll 2": ("here", UNROLL2),
}
ORDER = ("parent", "this tree", "A alone", "C alone", "codes selected",
         "issue gated", "no sink", "unroll 2", "this tree", "parent")
REPS = 5
# mangled: kernel 5's four forms (THREE, ES), kernel 7's count and ZML
SASS_FUNCTIONS = ("23fused_color_scan_kernelILb1ELb0E",
                  "23fused_color_scan_kernelILb1ELb1E",
                  "23fused_color_scan_kernelILb0ELb0E",
                  "23fused_color_scan_kernelILb0ELb1E",
                  "25fused2_search_scan_kernelILb0E",
                  "25fused2_search_scan_kernelILb1E")
FORMS = ("three-word", "three-word early stop", "two-load",
         "two-load early stop", "count2", "zml2")


def inputs(dev):
    """Per batch (form, width, lanes, fn, args, kw): kernel 5 in its four
    forms on phase 7's and the two-load phase's pangenomes and reads,
    kernel 7's count and ZML on phase 5's index and reads."""
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.color import compress_color_table
    from movi_tpu_torch.engine.fused_search2 import build_fused_search2_index
    from movi_tpu_torch.testing import (colored_index, index_from_text,
                                        pangenome, random_text)

    t0 = time.perf_counter()
    runs = []
    for genomes, glen, wide in (
            (smoke.COLOR_GENOMES, smoke.COLOR_GENOME_LEN, False),
            (smoke.WIDE_GENOMES, smoke.WIDE_GENOME_LEN, True)):
        gen = pangenome(genomes, glen)
        ix, ct = colored_index(gen, [1000 + g for g in range(genomes)])
        if wide:
            ct = compress_color_table(ct)  # the top 2^16 sets
        index = Index(ix)
        reads = smoke.color_reads(gen, smoke.FULL_LANES, smoke.LONG_READS)
        for es in (False, True):
            eng = index.color_engine(ct, paired=False, device=dev,
                                     early_stop=es)
            if (eng.ci.records3 is None) != wide:
                raise AssertionError(f"{genomes} genomes: records3 "
                                     f"{eng.ci.records3 is not None}")
            form = ("two-load" if wide else "three-word") + (
                " early stop" if es else "")
            for b in _as_batches(reads, smoke.QUERY_LANES):
                fn, _, args, kw, _ = smoke.color_scan(eng, b)
                runs.append((form, b.width, b.lanes, fn, args, kw))
    text = random_text(smoke.FULL_TEXT, 0)
    s2 = build_fused_search2_index(index_from_text(text), dev)
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    for b in _as_batches(reads, smoke.QUERY_LANES):
        for kind in ("count2", "zml2"):
            fn, _, args, kw = smoke.search_args(kind, s2, b, dev)
            runs.append((kind, b.width, b.lanes, fn, args, kw))
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"paired search r={s2.r}, table {s2.rec_all.numel() * 4} B",
          flush=True)
    return runs


def long_steps(form, width, out, kw):
    """The dependent steps of a batch's longest lane: kernel 5 its width
    (early stop: the most rows a lane scanned), ZML its pair steps, the
    count its longest lane's pair steps."""
    if form == "zml2":
        return out[1].shape[0] // 2
    if form == "count2":
        return int(smoke.count_steps(form, out[0]).max())
    if "early stop" in form:
        from movi_tpu_torch.engine.fused_color import scanned_rows

        return scanned_rows(out[0], kw["lens"], out[1].shape[0])
    return width


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
        print("color_search2_trials: no CUDA card", file=sys.stderr)
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
            src = os.path.join(work, os.path.basename(so) + ".src")
            for f in SOURCES[:2]:
                with open(os.path.join(src, f)) as fh:
                    spread[name, f] = "movi::spread(" in fh.read()
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
    ref, times, lpws = {}, {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    for rnd, name in order:
        lib = kernels._lib = libs[name]
        for i, (form, width, lanes, fn, a, kw) in enumerate(runs):
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            flat = [t.clone() for t in _flat(out)]
            if i not in ref:
                ref[i] = (flat, long_steps(form, width, out, kw))
            elif not all(torch.equal(x, y) for x, y in zip(flat, ref[i][0])):
                raise AssertionError(f"{name}: {form} batch {i} differs from "
                                     f"the parent's")
            del out, flat
            ms = smoke.cuda_ms(lambda: fn(*a, **kw), REPS)
            src = SOURCES[1] if form in ("count2", "zml2") else SOURCES[0]
            # a launch without the spread carries 32 lanes a warp
            lpw = (int(lib.movi_last_lanes_per_warp()) if spread[name, src]
                   else 32)
            times.setdefault((name, rnd), []).append(ms)
            lpws.setdefault((name, rnd), []).append(lpw)
            torch.cuda.empty_cache()
    kernels._lib = old_lib

    rows = []
    for (name, rnd), per in times.items():
        for form in FORMS:
            idx = [i for i, x in enumerate(runs) if x[0] == form]
            row = dict(library=name, round=rnd, form=form,
                       query_ms=sum(per[i] for i in idx),
                       batches=[dict(width=runs[i][1], lanes=runs[i][2],
                                     ms=per[i],
                                     lanes_per_warp=lpws[name, rnd][i])
                                for i in idx])
            long_i = max(idx, key=lambda i: runs[i][1])
            row["long_steps"] = ref[long_i][1]
            row["us_per_step"] = per[long_i] * 1e3 / max(ref[long_i][1], 1)
            rows.append(row)
            print(f"[trials] {name} (round {rnd}) {form}: query "
                  f"{row['query_ms']:.6f} ms; per batch " + ", ".join(
                      f"{b['lanes']}x{b['width']} ({b['lanes_per_warp']} a "
                      f"warp): {b['ms']:.6f}" for b in row["batches"])
                  + f"; 10 kb {row['us_per_step']:.6f} us a step of "
                  f"{row['long_steps']}  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
