"""Kernels 3 (the paired PML scan) and 4 (the paired color scan, with and
without early stop) of the port, against their parent's sources and
against variants, on the card, on the inputs of `chip_smoke.py`.

    python tools/pair_scan_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from `git
archive PARENT movi_tpu_torch/csrc`). The trial builds `fused2_pml.cu`
and `fused2_color.cu` (and `fused_search.cu`, for
`movi_last_lanes_per_warp`) of each library into a library of its own:
the parent's; this tree's (pair codes two steps ahead from clamped
addresses, the next record issued before the stores, few lanes spread);
and each entry of VARIANTS ("A alone": this tree's loops, every batch at
32 lanes a warp; "C alone": the parent's loops through the spread
launch; "stores first": each step's stores before the next record's
issue; "3 next always": after a lane's last step kernel 3 issuing the
record its state addresses, not its own again; "4 own row again": kernel
4 issuing its own row again there; "unroll default": both loops as the
compiler unrolls them by itself; "no word-7 sink": kernel 4 without each
row's word 7 in `sink`; "no sink": kernel 4 without `sink`). A variant
whose patch no longer matches is left out, and the script says so. The
inputs are the smoke's own: phase 5's index and reads
(`chip_smoke.main_reads`) for kernel 3, phase 7's 12-genome pangenome
and reads (`chip_smoke.color_reads`) for kernel 4, each in the batches
of `QUERY_LANES`, with the pair codes as the engines make them (uint8)
and widened to int32 (each kernel's other instantiation). It times each
library on every batch in the order of ORDER (CUDA events,
`chip_smoke.cuda_ms`: a batch's time is the median of TIMINGS means of
REPS calls) and requires every library's outputs (ml, color ids and the
state) to equal the parent's bit for bit. It prints, per library and
form, the ms a query and a batch with the lanes a warp each launch
carried and the µs a pair step of the 10 kb batch (its W2 pair steps, or
with early stop the most a lane scanned), and `tools/sass_inflight.py`'s
report of both kernels' main loops in every library. It needs one CUDA
card, `nvcc`, `cuobjdump` and `make` (for `native/`).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.color_search2_trials import LANE, SPREAD_LANE  # noqa: E402
from tools.sass_inflight import disassemble, report  # noqa: E402
from tools.tick_trials import _flat, build, finish, load  # noqa: E402

SOURCES = ("fused2_pml.cu", "fused2_color.cu", "fused_search.cu")
SPREAD_RULE = "return lanes <= sms ? 1 : 32;"
PARENT_LAUNCH = ("    const int block = 256;\n"
                 "    const int grid = (lanes + block - 1) / block;\n")
SPREAD_LAUNCH = ("    movi::Spread s;\n"
                 "    const cudaError_t e = movi::spread(lanes, 256, &s);\n"
                 "    if (e != cudaSuccess) return (int)e;\n"
                 "    const int block = s.block;\n"
                 "    const int grid = lanes > 0 ? s.grid : 0;\n")
# the parent's kernels 3 and 4 through spread.cuh's launch, their loops
# unchanged
C_ALONE = [
    (f, '#include "records.cuh"\n',
     '#include "records.cuh"\n#include "spread.cuh"\n')
    for f in SOURCES[:2]] + [
    (f, PARENT_LAUNCH, SPREAD_LAUNCH) for f in SOURCES[:2]] + [
    ("fused2_pml.cu", "    int* __restrict__ ml) {\n" + LANE,
     "    int* __restrict__ ml, int lpw) {\n" + SPREAD_LANE),
    ("fused2_pml.cu", "(int*)ml_state_out, (int*)ml);",
     "(int*)ml_state_out, (int*)ml, s.lpw);"),
    ("fused2_color.cu", "    int* __restrict__ cid) {\n" + LANE,
     "    int* __restrict__ cid, int lpw) {\n" + SPREAD_LANE),
    ("fused2_color.cu", "        (int*)cid);\n",
     "        (int*)cid, s.lpw);\n")]
# this tree's loops with each step's stores before the next record's issue
STORES_FIRST = [
    ("fused2_pml.cu",
     "            rec = records[row];\n"
     "            const size_t out = 2 * (size_t)t * lanes_s + lane;\n"
     "            ml[out] = ml1;\n"
     "            ml[out + lanes_s] = ml2;\n",
     "            const size_t out = 2 * (size_t)t * lanes_s + lane;\n"
     "            ml[out] = ml1;\n"
     "            ml[out + lanes_s] = ml2;\n"
     "            rec = records[row];\n"),
    ("fused2_color.cu",
     "            q0 = records[2 * row];\n"
     "            q1 = records[2 * row + 1];\n"
     "            const size_t out = 2 * (size_t)t * lanes_s + lane;\n"
     "            ml[out] = ml1;\n"
     "            ml[out + lanes_s] = ml2;\n"
     "            cid[out] = cid1;\n"
     "            cid[out + lanes_s] = cid2;\n",
     "            const size_t out = 2 * (size_t)t * lanes_s + lane;\n"
     "            ml[out] = ml1;\n"
     "            ml[out + lanes_s] = ml2;\n"
     "            cid[out] = cid1;\n"
     "            cid[out + lanes_s] = cid2;\n"
     "            q0 = records[2 * row];\n"
     "            q1 = records[2 * row + 1];\n")]
# after a lane's last step, kernel 3 issuing the record its state
# addresses (inside the table on the smoke's indexes), not its own again
NEXT_ALWAYS = [
    ("fused2_pml.cu", "row = t + 1 < W2 ? (int64_t)idx * s2 + a_next : row;",
     "row = (int64_t)idx * s2 + a_next;")]
# after a lane's last step, kernel 4 issuing its own row again, not the
# row its state addresses
OWN_ROW = [
    ("fused2_color.cu", "row = (int64_t)idx * s2 + a_next;",
     "row = t + 1 < steps ? (int64_t)idx * s2 + a_next : row;")]
# this tree's kernel 4 without the in-loop word 7 in `sink`, or without
# `sink` at all
WORD7 = ("fused2_color.cu", "            sink |= q1.w;\n", "")
NO_SINK = [WORD7, ("fused2_color.cu",
                   "        sink |= q0.x | q0.y | q0.z | q0.w | q1.x | q1.y "
                   "| q1.z | q1.w\n                | a_next;\n", "")]
# both loops as the compiler unrolls them by itself
UNROLL_DEFAULT = [("fused2_pml.cu", "#pragma unroll 1\n", ""),
                  ("fused2_color.cu", "#pragma unroll 2\n", "")]
VARIANTS = {  # name: (base, [(file, text, its replacement)])
    "this tree": ("here", []),
    "A alone": ("here", [("spread.cuh", SPREAD_RULE, "return 32;")]),
    "C alone": ("parent", C_ALONE),
    "stores first": ("here", STORES_FIRST),
    "3 next always": ("here", NEXT_ALWAYS),
    "4 own row again": ("here", OWN_ROW),
    "unroll default": ("here", UNROLL_DEFAULT),
    "no word-7 sink": ("here", [WORD7]),
    "no sink": ("here", NO_SINK),
}
ORDER = ("parent", "this tree", "A alone", "C alone", "stores first",
         "3 next always", "4 own row again", "unroll default",
         "no word-7 sink", "no sink", "this tree", "parent")
REPS = 10
TIMINGS = 5  # a batch's time: the median of this many means of REPS calls
# mangled: kernel 3 (uint8, int32 codes), kernel 4 (uint8, int32; early
# stop off, on)
SASS_FUNCTIONS = ("22fused2_pml_scan_kernelIhE",
                  "22fused2_pml_scan_kernelIiE",
                  "24fused2_color_scan_kernelIhLb0EE",
                  "24fused2_color_scan_kernelIhLb1EE",
                  "24fused2_color_scan_kernelIiLb0EE",
                  "24fused2_color_scan_kernelIiLb1EE")
FORMS = ("pml2", "pml2 int32", "color2", "color2 early stop",
         "color2 int32", "color2 int32 early stop")


def inputs(dev):
    """Per batch (form, width, lanes, fn, args, kw): kernel 3 on phase 5's
    index and reads, kernel 4 with and without early stop on phase 7's
    pangenome and reads, each with uint8 and int32 pair codes."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.testing import (colored_index, index_from_text,
                                        pangenome, random_text)

    t0 = time.perf_counter()
    runs = []
    text = random_text(smoke.FULL_TEXT, 0)
    f2 = tf2.build_fused2_index(tf.build_fused_index(
        index_from_text(text)).to(dev))
    slots = f2.sigma + 1
    eng = tf2.Fused2PMLEngine(f2, dev)
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    for b in _as_batches(reads, smoke.QUERY_LANES):
        a12_t, _ = eng.prepare(b)
        st0 = tf.initial_state(f2, b.lanes, dev)
        for form, codes in (("pml2", a12_t),
                            ("pml2 int32", a12_t.to(torch.int32))):
            runs.append((form, b.width, b.lanes, kernels.fused2_pml_scan,
                         (f2.records, slots, f2.p_dollar, codes, st0), {}))
    table3 = f2.records.numel() * 4
    del f2, eng
    gen = pangenome(smoke.COLOR_GENOMES, smoke.COLOR_GENOME_LEN)
    ix, ct = colored_index(gen, [1000 + g for g in
                                 range(smoke.COLOR_GENOMES)])
    index = Index(ix)
    reads = smoke.color_reads(gen, smoke.FULL_LANES, smoke.LONG_READS)
    for es in (False, True):
        ceng = index.color_engine(ct, paired=True, device=dev,
                                  early_stop=es)
        if not isinstance(ceng, tf2.Fused2ColorEngine):
            raise AssertionError("phase 7's paired color engine is not "
                                 "the paired layout")
        for b in _as_batches(reads, smoke.QUERY_LANES):
            fn, _, args, kw, _ = smoke.color_scan(ceng, b)
            for wide in (False, True):
                a = args if not wide else (*args[:3],
                                           args[3].to(torch.int32), args[4])
                form = ("color2" + (" int32" if wide else "")
                        + (" early stop" if es else ""))
                runs.append((form, b.width, b.lanes, fn, a, kw))
    table4 = index._paired_color[1].f2.records.numel() * 4
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"paired PML table {table3} B, paired color table {table4} B",
          flush=True)
    return runs


def long_steps(form, width, out, kw):
    """The pair steps of a batch's longest lane: its W2, or with early
    stop the most a lane scanned (`chip_smoke.scanned_pairs`)."""
    W2 = (width + 1) // 2
    if "early stop" not in form:
        return W2
    return smoke.scanned_pairs(out[0], kw["lens"], W2)


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
        print("pair_scan_trials: no CUDA card", file=sys.stderr)
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
    for name in libs:
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
            ms = statistics.median(smoke.cuda_ms(lambda: fn(*a, **kw), REPS)
                                   for _ in range(TIMINGS))
            src = SOURCES[0] if form.startswith("pml2") else SOURCES[1]
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
                  + f"; 10 kb {row['us_per_step']:.6f} us a pair step of "
                  f"{row['long_steps']}  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "rows": rows}, f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
