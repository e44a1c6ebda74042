"""Kernels 9b and 7b (the exact k-mer count scans) of the port, against
their parent's sources and against variants, on the card, on the inputs
of `chip_smoke.py`'s k-mer phase, with a probe of the card's random row
gather rate.

    python tools/kmer_count_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from `git
archive PARENT movi_tpu_torch/csrc`). The trial builds `fused_kmer.cu`
and `fused2_kmer_count.cu` of each library into a library of its own:
the parent's (two rows a step, 7b's 24 B rows as three 8 B loads); this
tree's (one row a step where the interval lies in one run and the rule
of each kernel allows, 7b's rows as an int4 and an int2); and each entry
of VARIANTS ("7b two rows a step": this tree's row loads, the rule off;
"7b three loads a row": the rule with the parent's row loads; "7b no
empty rule": a one-run step whose first micro-step leaves the run loads
the up row too; "7b 32 registers": 7b's registers capped for eight
256-thread blocks an SM; "128-thread blocks", "512-thread blocks": both
kernels' blocks). A variant whose patch no longer matches is left out, and the
script says so. The inputs are the smoke's own: phase 4's index
(`chip_smoke.FULL_TEXT`, its one-step and paired search tables), the
k-mer phase's reads (`KMER_LANES` screening reads and phase 4's 10 kb
reads) in `QUERY_LANES` batches, k = `KMER_K`. Rounds run in the order of
ORDER, parent, this tree, parent, this tree first; an input's time is the
median of TIMINGS means of REPS calls (CUDA events); every library's
(found, count) must equal the parent's bit for bit. Per batch it prints
the k-mers, the steps and the rows (the plain row tallies) a k-mer, and
each library's ms; per library the registers a thread (`cuobjdump
-res-usage`) and `tools/sass_inflight.py`'s report of both kernels' main
loops, with the count of their global loads and of those predicated.

The probe: PROBE_THREADS independent threads, each PROBE_STEPS dependent
gathers of a random row (16 B as 9b's, 24 B read as 7b reads it, 32 B),
from a buffer of 32 MB (in the L2), of 9b's table size and of 7b's; it
prints the rows a second and the ns a row. It needs one CUDA card,
`nvcc`, `cuobjdump` and `make` (for `native/`).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as smoke  # noqa: E402
from tools.dense_compose_trials import registers  # noqa: E402
from tools.sass_inflight import (_function_body, disassemble,  # noqa: E402
                                 main_loop, report)
from tools.tick_trials import build, finish, load  # noqa: E402

SOURCES = ("fused_kmer.cu", "fused2_kmer_count.cu")
RULE_ON = "    const bool one = cur.rs == cur.re;\n    const Rec6 rd ="
ROW_LOADS = (
    "    const int* p = rec_all + row * 6;\n"
    "    const bool lead8 = (((int)row ^ p0) & 1) != 0;  // int2 first\n"
    "    const int4 q = *reinterpret_cast<const int4*>(p + (lead8 ? 2 : "
    "0));\n"
    "    const int2 d = *reinterpret_cast<const int2*>(p + (lead8 ? 0 : "
    "4));\n"
    "    return lead8 ? Rec6{{d.x, d.y, q.x, q.y, q.z, q.w}}\n"
    "                 : Rec6{{q.x, q.y, q.z, q.w, d.x, d.y}};\n")
EMPTY_RULE = [
    ("fused2_kmer_count.cu",
     "    if (one && u1 && !u2) ru = load_row(rec_all, up, p0);\n",
     "    if (one && !(u1 && u2)) ru = load_row(rec_all, up, p0);\n"),
    ("fused2_kmer_count.cu", "PairRows{rd, one && u2 ? rd : ru}",
     "PairRows{rd, one && u1 && u2 ? rd : ru}"),
    ("fused2_kmer_count.cu", "    e1 = e1 || (one && !u1);\n", ""),
]
KERNEL_7B = "__global__ void fused2_kmer_count_kernel("
VARIANTS = {  # name: (base, [(file, text, its replacement)])
    "this tree": ("here", []),
    "7b two rows a step": ("here", [(
        "fused2_kmer_count.cu", RULE_ON,
        "    const bool one = false;\n    const Rec6 rd =")]),
    "7b three loads a row": ("here", [(
        "fused2_kmer_count.cu", ROW_LOADS,
        "    (void)p0;\n    return movi::load_rec6(rec_all, row);\n")]),
    "7b no empty rule": ("here", EMPTY_RULE),
    "7b 32 registers": ("here", [(
        "fused2_kmer_count.cu", KERNEL_7B,
        KERNEL_7B.replace("void ", "void __launch_bounds__(256, 8) "))]),
    "128-thread blocks": ("here", "blocks 128"),
    "512-thread blocks": ("here", "blocks 512"),
}
ORDER = ("parent", "this tree", "parent", "this tree", "7b two rows a step",
         "7b three loads a row", "7b no empty rule", "7b 32 registers",
         "128-thread blocks", "512-thread blocks")
REPS = 10
TIMINGS = 5  # an input's time: the median of this many means of REPS calls
# mangled: 9b, 7b
SASS_FUNCTIONS = ("17kmer_count_kernel", "24fused2_kmer_count_kernel")
PROBE_THREADS = 1 << 20
PROBE_STEPS = 16
PROBE_SOURCE = r"""
#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t mix(uint32_t x) {
    x ^= x >> 16;
    x *= 0x7feb352du;
    x ^= x >> 15;
    x *= 0x846ca68bu;
    return x ^ (x >> 16);
}

// n threads, each `steps` dependent gathers of a random row of W words
// (the next row from the last one's words); 24 B rows read as kernel 7b
// reads them.
template <int W>
__global__ void gather_kernel(const int* __restrict__ buf, long long rows,
                              int steps, int n, int p0,
                              int* __restrict__ out) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t >= n) return;
    uint32_t x = mix((uint32_t)t * 2654435761u + 1u);
    int acc = 0;
    for (int s = 0; s < steps; ++s) {
        const long long row = (long long)(((unsigned long long)x *
                                           (unsigned long long)rows) >> 32);
        const int* p = buf + row * W;
        if (W == 4) {
            const int4 q = *reinterpret_cast<const int4*>(p);
            acc += q.x ^ q.w;
        } else if (W == 6) {
            const bool lead8 = (((int)row ^ p0) & 1) != 0;
            const int4 q = *reinterpret_cast<const int4*>(p + (lead8 ? 2 : 0));
            const int2 d = *reinterpret_cast<const int2*>(p + (lead8 ? 0 : 4));
            acc += q.x ^ d.y;
        } else {
            const int4 q = *reinterpret_cast<const int4*>(p);
            const int4 v = *reinterpret_cast<const int4*>(p + 4);
            acc += q.x ^ v.w;
        }
        x = mix(x + (uint32_t)acc);
    }
    out[t] = acc;
}

}  // namespace

extern "C" int movi_gather_probe(const void* buf, long long rows, int words,
                                 int steps, int n, void* out) {
    const int p0 = (int)((reinterpret_cast<uintptr_t>(buf) >> 3) & 1);
    const int block = 256;
    const int grid = (n + block - 1) / block;
    const int* b = (const int*)buf;
    if (words == 4)
        gather_kernel<4><<<grid, block>>>(b, rows, steps, n, p0, (int*)out);
    else if (words == 6)
        gather_kernel<6><<<grid, block>>>(b, rows, steps, n, p0, (int*)out);
    else
        gather_kernel<8><<<grid, block>>>(b, rows, steps, n, p0, (int*)out);
    return (int)cudaGetLastError();
}
"""


def patches_of(spec):
    """A variant's patches; "blocks N" sets both kernels' blocks to N."""
    if not isinstance(spec, str):
        return spec
    n = int(spec.split()[1])
    return [("fused2_kmer_count.cu", "    const int block = 256;\n",
             f"    const int block = {n};\n"),
            ("fused_kmer.cu",
             "    const int block = 256;\n    const int grid = (nk + block",
             f"    const int block = {n};\n    const int grid = (nk + block")]


def loads(sass, function):
    """(global loads, predicated ones) in the main loop of `function`."""
    lo, hi = main_loop(sass, function)
    n = pred = 0
    for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;",
                         _function_body(sass, function)):
        if lo <= int(m.group(1), 16) <= hi and "LDG" in m.group(2):
            n += 1
            pred += m.group(2).startswith("@")
    return n, pred


def ptxas_registers(csrc, work, tag):
    """`-Xptxas -v` lines of the two kernels, compiled from csrc."""
    from movi_tpu_torch import kernels

    out = []
    for name in SOURCES:
        res = subprocess.run(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-Xptxas", "-v", "-c",
             os.path.join(csrc, name), "-o",
             os.path.join(work, f"{tag}_{name}.o")],
            capture_output=True, text=True)
        lines = res.stderr.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry function" in line and "kmer_count" in line:
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "")
                out.append(f"{line.split()[-1]}: {regs.strip()}")
    return out


def inputs(dev):
    """Per batch its label, k-mers, (slots, lane, start), and the steps
    and rows a k-mer (9b's steps, 7b's pair steps, each kernel's rows from
    the plain row tallies); and the two tables."""
    import torch

    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.testing import (index_from_text, random_text,
                                        screening_reads, sim_reads)

    t0 = time.perf_counter()
    k = smoke.KMER_K
    text = random_text(smoke.FULL_TEXT, 0)
    ix = index_from_text(text)
    si = ts.build_fused_search_index(ix).to(dev)
    s2 = ts2.build_fused_search2_index(ix, dev)
    short = screening_reads(text, smoke.KMER_LANES, smoke.READ_LEN,
                            seed=smoke.KMER_SEED)
    longs = sim_reads(text, smoke.LONG_READS, smoke.LONG_LEN, seed=43)
    reads = ([(f"m{i}", s.tobytes()) for i, s in enumerate(short)]
             + [(f"l{i}", s.tobytes()) for i, s in enumerate(longs)])
    batches = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        slots, lane, start = smoke.kmer_batch_inputs(b, si.alphamap_query, k,
                                                     dev)
        win = tk.kmer_windows(slots, lane, start, k)
        steps = smoke.kmer_count_steps(si, win, k)
        rows = {}
        for paired, idx in ((False, si), (True, s2)):
            tally = (ts2.fused2_kmer_count_rows_plain if paired
                     else tk.kmer_count_rows_plain)
            rows[paired] = int(tally(idx.rec_all, idx.init_rec, idx.all_p,
                                     idx.r, idx.sigma, win, k)[2].sum())
        nk = int(lane.numel())
        batches.append(dict(
            label=f"{b.lanes} lanes x {b.width}", kmers=nk,
            args=(slots, lane, start),
            steps_9b=int(steps.sum()) / nk,
            steps_7b=int(smoke.pair_steps(steps).sum()) / nk,
            rows_9b=rows[False] / nk, rows_7b=rows[True] / nk))
        del win
        torch.cuda.empty_cache()
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s: "
          f"r={ix.r}, one-step table {si.rec_all.numel() * 4} B, paired "
          f"{s2.rec_all.numel() * 4} B", flush=True)
    return si, s2, batches


def probe(lib, dev, sizes, card):
    """The random row gather rate: rows a second and ns a row, per row
    size and buffer size."""
    import torch

    biggest = max(sizes.values())
    buf = torch.zeros(biggest // 4, dtype=torch.int32, device=dev)
    buf.copy_(torch.randint(0, 1 << 30, buf.shape, device=dev,
                            dtype=torch.int32))
    out = torch.empty(PROBE_THREADS, dtype=torch.int32, device=dev)
    res = []
    for label, nbytes in sizes.items():
        for words in (4, 6, 8):
            rows = nbytes // (4 * words)

            def run():
                code = lib.movi_gather_probe(buf.data_ptr(), rows, words,
                                             PROBE_STEPS, PROBE_THREADS,
                                             out.data_ptr())
                if code:
                    raise RuntimeError(f"gather probe: cudaError {code}")

            ms = statistics.median(smoke.cuda_ms(run, 3)
                                   for _ in range(TIMINGS))
            n = PROBE_THREADS * PROBE_STEPS
            res.append(dict(buffer=label, bytes=nbytes, row_bytes=4 * words,
                            ms=ms, rows_per_s=n / ms * 1e3,
                            ns_per_row=ms * 1e6 / n))
            print(f"[trials] probe {label} ({nbytes} B), {4 * words} B "
                  f"rows: {ms:.6f} ms for {n} rows = "
                  f"{n / ms * 1e3:.6e} rows/s, {ms * 1e6 / n:.6f} ns a row, "
                  f"{n * 4 * words / ms / 1e6:.3f} GB/s of rows  ({card})",
                  flush=True)
    del buf
    torch.cuda.empty_cache()
    return res


def main(argv=None) -> int:
    import ctypes

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True,
                    help="the parent commit's csrc directory")
    ap.add_argument("--out", required=True,
                    help="a directory for the libraries, their SASS and "
                         "trials.json")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kmer_count_trials: no CUDA card", file=sys.stderr)
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
    libs = {}
    with tempfile.TemporaryDirectory(dir=args.out) as work:
        t0 = time.perf_counter()
        probe_src = os.path.join(work, "gather_probe.cu")
        with open(probe_src, "w") as f:
            f.write(PROBE_SOURCE)
        probe_so = os.path.join(args.out, "gather_probe.so")
        probe_job = subprocess.Popen(
            [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", probe_src,
             "-o", probe_so])
        jobs = {"parent": (args.parent, [])}
        jobs.update({name: (bases[base], patches_of(p))
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
        for name, (so, procs, link) in started.items():
            finish(procs, link, name)
            libs[name] = load(so)
        if probe_job.wait() != 0:
            raise RuntimeError("nvcc failed for the gather probe")
        gather = ctypes.CDLL(probe_so)
        gather.movi_gather_probe.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        gather.movi_gather_probe.restype = ctypes.c_int
        print(f"[trials] built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for tag, csrc in (("parent", args.parent), ("this tree", here)):
            for line in ptxas_registers(csrc, work, tag.replace(" ", "_")):
                print(f"[trials] -Xptxas -v {tag}: {line}", flush=True)
    for name in libs:
        so = os.path.join(args.out, name.replace(" ", "_") + ".so")
        sass = disassemble(so)
        with open(so[:-3] + ".sass", "w") as f:
            f.write(sass)
        for fn in SASS_FUNCTIONS:
            n, pred = loads(sass, fn)
            print(f"[trials] SASS {name} {report(sass, fn)}; {n} global "
                  f"loads in the loop, {pred} predicated", flush=True)
        print(f"[trials] registers {name}: " + "; ".join(
            registers(so, fn) for fn in SASS_FUNCTIONS), flush=True)

    si, s2, batches = inputs(dev)
    k = smoke.KMER_K
    for b in batches:
        print(f"[trials] batch {b['label']}: {b['kmers']} k-mers; a k-mer "
              f"{b['steps_9b']:.6f} steps and {b['rows_9b']:.6f} rows (9b), "
              f"{b['steps_7b']:.6f} pair steps and {b['rows_7b']:.6f} rows "
              f"(7b)", flush=True)
    kern = {"9b": (kernels.kmer_count_scan, si),
            "7b": (kernels.fused2_kmer_count_scan, s2)}
    old_lib = kernels._lib
    ref, times = {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    for rnd, name in order:
        kernels._lib = libs[name]
        for which, (fn, idx) in kern.items():
            for i, b in enumerate(batches):
                a = (idx.rec_all, idx.init_rec, idx.all_p, idx.r, idx.sigma,
                     *b["args"], k)
                out = [t.clone() for t in fn(*a)]
                torch.cuda.synchronize()
                if (which, i) not in ref:
                    ref[which, i] = out
                elif not all(torch.equal(x, y)
                             for x, y in zip(out, ref[which, i])):
                    raise AssertionError(f"{name}: {which} on {b['label']} "
                                         f"differs from the parent's")
                ms = statistics.median(smoke.cuda_ms(lambda: fn(*a), REPS)
                                       for _ in range(TIMINGS))
                times.setdefault((name, rnd), {}).setdefault(
                    which, []).append(ms)
    kernels._lib = old_lib

    rows = []
    for (name, rnd), per in times.items():
        row = dict(library=name, round=rnd)
        for which, ms in per.items():
            row[which] = dict(query_ms=sum(ms), batches=[
                dict(label=b["label"], ms=t,
                     ns_per_kmer=t * 1e6 / b["kmers"])
                for b, t in zip(batches, ms)])
        rows.append(row)
        print(f"[trials] {name} (round {rnd}): " + "; ".join(
            f"{which} {row[which]['query_ms']:.6f} ms a query, per batch "
            + ", ".join(f"{x['label']}: {x['ms']:.6f} "
                        f"({x['ns_per_kmer']:.6f} ns a k-mer)"
                        for x in row[which]["batches"])
            for which in per) + f"  ({card})", flush=True)
    sizes = {"in the L2": 32 << 20, "9b's table": si.rec_all.numel() * 4,
             "7b's table": s2.rec_all.numel() * 4}
    del si, s2, kern, ref
    torch.cuda.empty_cache()
    probes = probe(gather, dev, sizes, card)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card,
                   "batches": [{x: b[x] for x in b if x != "args"}
                               for b in batches],
                   "rows": rows, "probe": probes}, f, indent=1)
    print("[trials] every library's outputs equal the parent's", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
