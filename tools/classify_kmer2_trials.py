"""Kernels 16a (the classification pass) and 11b (the bidirectional
k-mer counts' left scan) of the port, with 7b beside them, against their
parent's sources and against variants, on the card, on the inputs of
`chip_smoke.py`'s mesh and MEM phases.

    python tools/classify_kmer2_trials.py --parent DIR --out OUT

DIR is a `csrc` directory of the parent commit (for example from `git
archive PARENT movi_tpu_torch/csrc`). The trial builds `classify.cu`,
`fused_kmer2.cu` and `fused2_kmer_count.cu` of each library into a
library of its own: the parent's; this tree's (16a spread over the SMs
along the read, slices merged by integer atomics in the call's zeroed
scratch and a last-block ticket; 11b with group-major threads, the next
pair's chars loaded a step ahead and both rows of each pair step); and
each entry of VARIANTS ("16a two launches": the slices merged by a
second, tiny launch in place of the ticket; "16a 4 warps", "16a 16
warps": the warps a block that split its rows; "16a unroll 4", "16a
unroll 16": the loads in flight a thread; "11b one-row rule": kernel
7b's one-row pair step, the down row also standing in for an odd
depth's pad pair; "11b depth-major threads": t = d*G + g, the parent's
layout, in place of t = g*p + d; "11b 256-thread blocks").  The
parent's 16a is called through its own C signature, which has no
scratch.
A variant whose patch no longer matches is left out, and the script says
so.

The inputs are the smoke's own. 16a: phase 4's index
(`chip_smoke.FULL_TEXT`) and reads (`FULL_LANES` 150 bp and `LONG_READS`
10 kb) in `QUERY_LANES` batches through kernel 1, the one-step mesh
path's ml, at the mesh phase's bin width and threshold. 7b: the k-mer
phase's batches on the same index. 11b: the MEM phase's
reverse-complement closed index and its k-mer batches, behind this
tree's kernel 11a, at k = `KMER_K`, p = k // 2. Rounds run in the order
of ORDER, parent, this tree, parent, this tree first; an input's time is
the median of TIMINGS means of REPS calls (CUDA events), once as the
host paces them and once queued behind a spin kernel (the device time);
every library's outputs must equal the parent's bit for bit, and this
tree's 16a its plain version and 11b its row tally. Per batch it prints
16a's bytes and bound, 11b's live partials, pair steps and rows (the
row tally) with the bound they give, and per library the ms a batch and
a query; per library the registers a thread (`cuobjdump -res-usage`),
`tools/sass_inflight.py`'s report of 11b's and 7b's main loops, and
whether 7b's SASS is the parent's (its source is). It needs one CUDA card, `nvcc`,
`cuobjdump` and `make` (for `native/`).
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
from tools.kmer_count_trials import loads  # noqa: E402
from tools.sass_inflight import (_function_body, disassemble,  # noqa: E402
                                 report)
from tools.tick_trials import build, finish, load  # noqa: E402

SOURCES = ("classify.cu", "fused_kmer2.cu", "fused2_kmer_count.cu")
TICKET = """    __threadfence();
    __syncthreads();
    if (x == 0 && y == 0)
        last = atomicAdd(&ticket[tile], 1u) == (unsigned)slices - 1;
    __syncthreads();
    if (!last || y != 0 || !in) return;
    // the other slices' atomics, read past the L1
    const int v = __ldcg(&votes_s[lane]);
    const int tl = (int)(__ldcg(&tail_s[lane]) ^ 0x80000000u);
    finish(lane, B, thr, v, tl, found, above_out, below_out);
}
"""
FINISH_KERNEL = """}

__global__ void classify_finish_kernel(const int* __restrict__ lengths,
                                       int lanes, int bin_width, int thr,
                                       const int* __restrict__ votes_s,
                                       const unsigned* __restrict__ tail_s,
                                       uint8_t* __restrict__ found,
                                       int* __restrict__ above_out,
                                       int* __restrict__ below_out) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= lanes) return;
    const int q = lengths[lane] / bin_width;
    finish(lane, q > 1 ? q : 1, thr, votes_s[lane],
           (int)(tail_s[lane] ^ 0x80000000u), found, above_out, below_out);
}
"""
LAUNCH_END = """        (unsigned*)scratch + (int64_t)tiles * 2 * TILE);
"""
SECOND_LAUNCH = LAUNCH_END + """    if (slices > 1)
        classify_finish_kernel<<<(lanes + 255) / 256, 256, 0,
                                 (cudaStream_t)stream>>>(
            (const int*)lengths, lanes, bin_width, thr, (const int*)scratch,
            (const unsigned*)scratch + (int64_t)tiles * TILE,
            (uint8_t*)found, (int*)above, (int*)below);
"""
STEP_11B = """        movi::bs2_step(s2_rec, r, S2, cur, a1 * sigma + (l2 ? a2 : 0), true,
                       l2, mid, fin, e1, e2);
"""
ONE_ROW_11B = """        pair_count_step(s2_rec, r, S2, cur, a1 * sigma + (l2 ? a2 : 0),
                        l2, mid, fin, e1, e2);
"""
# kernel 7b's one-row pair step (csrc/fused2_kmer_count.cu load_row and
# pair_count_step), with the down row standing in for an odd depth's pad
# pair too: the rule whose rows the bound counts
ONE_ROW_STEP = """__device__ __forceinline__ movi::Rec6 load_row(
    const int* __restrict__ rec_all, int64_t row, int p0) {
    const int* p = rec_all + row * 6;
    const bool lead8 = (((int)row ^ p0) & 1) != 0;
    const int4 q = *reinterpret_cast<const int4*>(p + (lead8 ? 2 : 0));
    const int2 d = *reinterpret_cast<const int2*>(p + (lead8 ? 0 : 4));
    return lead8 ? movi::Rec6{{d.x, d.y, q.x, q.y, q.z, q.w}}
                 : movi::Rec6{{q.x, q.y, q.z, q.w, d.x, d.y}};
}

__device__ __forceinline__ void pair_count_step(
    const int* __restrict__ rec_all, int r, int S2, const Interval& cur,
    int a12, bool l2, Interval& mid, Interval& fin, bool& e1, bool& e2) {
    const int p0 = (int)((reinterpret_cast<uintptr_t>(rec_all) >> 3) & 1);
    const int a = movi::clampi(a12, 0, S2 - 1);
    const int64_t up = ((int64_t)r + movi::clampi(cur.re, 0, r - 1)) * S2 + a;
    const bool one = cur.rs == cur.re;
    const movi::Rec6 rd = load_row(
        rec_all, (int64_t)movi::clampi(cur.rs, 0, r - 1) * S2 + a, p0);
    movi::Rec6 ru{{0, 0, 0, 0, 0, 0}};
    if (!one) ru = load_row(rec_all, up, p0);
    const int w0 = rd.w[0], w3 = rd.w[3];
    const bool u1 = ((w0 >> 25) & 1) != 0;
    const bool hi = (w3 & movi::S2_GUARD) + cur.oe >=
                    ((w3 >> 12) & movi::S2_GUARD);
    const bool u2 = ((w0 >> (hi ? 27 : 26)) & 1) != 0;
    const bool stand = u2 || !l2;
    if (one && u1 && !stand) ru = load_row(rec_all, up, p0);
    movi::bs2_decode(movi::PairRows{rd, one && stand ? rd : ru}, cur, true,
                     l2, mid, fin, e1, e2);
    e1 = e1 || (one && !u1);
}

__global__ void kmer2_left_kernel("""
G_MAJOR = """    const int g = (int)(t / p);
    const int d = (int)(t - (int64_t)g * p);
"""
D_MAJOR = """    const int d = (int)(t / G);
    const int g = (int)(t - (int64_t)d * G);
"""
BLOCK_11B = "    const int block = 128;\n    const long long grid"
VARIANTS = {  # name: [(file, text, its replacement)] in this tree's csrc
    "this tree": [],
    "16a two launches": [("classify.cu", TICKET, FINISH_KERNEL),
                         ("classify.cu", LAUNCH_END, SECOND_LAUNCH)],
    "16a 4 warps": [("classify.cu", "constexpr int WARPS = 8;",
                     "constexpr int WARPS = 4;")],
    "16a 16 warps": [("classify.cu", "constexpr int WARPS = 8;",
                      "constexpr int WARPS = 16;")],
    "16a unroll 4": [("classify.cu", "constexpr int UNROLL = 8;",
                      "constexpr int UNROLL = 4;")],
    "16a unroll 16": [("classify.cu", "constexpr int UNROLL = 8;",
                       "constexpr int UNROLL = 16;")],
    "11b one-row rule": [("fused_kmer2.cu", STEP_11B, ONE_ROW_11B),
                         ("fused_kmer2.cu",
                          "__global__ void kmer2_left_kernel(",
                          ONE_ROW_STEP)],
    "11b depth-major threads": [("fused_kmer2.cu", G_MAJOR, D_MAJOR)],
    "11b 256-thread blocks": [("fused_kmer2.cu", BLOCK_11B,
                               BLOCK_11B.replace("128", "256"))],
}
ORDER = ("parent", "this tree", "parent", "this tree", "16a two launches",
         "16a 4 warps", "16a 16 warps", "16a unroll 4", "16a unroll 16",
         "11b one-row rule", "11b depth-major threads",
         "11b 256-thread blocks")
REPS = 10
TIMINGS = 5  # an input's time: the median of this many means of REPS calls
# mangled: 16a, 11b, 7b
SASS_FUNCTIONS = ("23classify_from_ml_kernel", "17kmer2_left_kernel",
                  "24fused2_kmer_count_kernel")
SECTOR_BYTES_PER_S = 1.0e12  # random 32 B sectors past the L2 (PERF.md)
SPIN_CYCLES = 20_000_000  # ~10 ms: the host issues REPS launches inside


def sass_lines(sass, function):
    """A function's SASS instructions, without its name (whose anonymous
    namespace carries a hash of the source file) and encodings."""
    body = _function_body(sass, function).split("\n", 1)[1]
    return [re.sub(r"_GLOBAL__N__\w+", "", m.group(1)) for m in
            re.finditer(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", body)]


def device_ms(fn, a):
    """The device time of one launch: REPS launches queued back to back
    behind a spin kernel (chip_smoke.queued_ms), so that the host's ~30
    us a call through the wrapper does not pace them."""
    ms = smoke.queued_ms(lambda: [fn(*a) for _ in range(REPS)],
                         SPIN_CYCLES)
    if ms is None:
        raise RuntimeError("the spin ended before the host had issued the "
                           "launches")
    return ms / REPS


def ptxas_registers(csrc, work, tag):
    """`-Xptxas -v` lines of 16a, 11b and 7b, compiled from csrc."""
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
            if "Compiling entry function" in line and any(
                    f in line for f in SASS_FUNCTIONS):
                regs = next((x for x in lines[i + 1:i + 4]
                             if "registers" in x), "")
                out.append(f"{line.split()[-1]}: {regs.strip()}")
    return out


def parent_classify(lib):
    """Kernel 16a of the parent's library through the parent's wrapper:
    its C call takes no scratch."""
    import torch

    from movi_tpu_torch import kernels

    fn = lib.movi_classify_from_ml
    fn.argtypes = kernels._SIGNATURES["movi_classify_from_ml"][:-1]

    def call(ml, lengths, bin_width, thr):
        W, lanes = ml.shape
        found = torch.empty(lanes, dtype=torch.bool, device=ml.device)
        above, below = (torch.empty(lanes, dtype=torch.int32,
                                    device=ml.device) for _ in range(2))
        kernels._raise_on(fn(ml.data_ptr(), lengths.data_ptr(), W, lanes,
                             bin_width, int(thr), found.data_ptr(),
                             above.data_ptr(), below.data_ptr(),
                             kernels._stream(ml.device)),
                          "classify_from_ml")
        return found, above, below

    return call


def classify_inputs(dev, ix, text):
    """16a's batches: phase 4's reads through kernel 1 (the one-step mesh
    path's ml) at the mesh phase's bin width and threshold."""
    import numpy as np
    import torch

    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.classify import Classifier, EmpNullDatabase
    from movi_tpu_torch.engine import fused as tf

    db = EmpNullDatabase()
    db.compute([smoke.NULL_PERCENTILE] * 5)
    thr = Classifier(db, bin_width=smoke.BIN_WIDTH).max_value_thr
    fi = tf.build_fused_index(ix).to(dev)
    reads = smoke.main_reads(text, smoke.FULL_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, 42, "s")
    out = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        alphas = fi.alphamap_query[b.seqs[:, ::-1]]
        codes = torch.from_numpy(np.ascontiguousarray(alphas.T).astype(
            np.uint8)).to(dev)
        state = tf.initial_state(fi, alphas.shape[0], dev)
        ml = tf.fused_pml_scan(fi.records, fi.sigma + 1, fi.p_dollar, codes,
                               state)[1]
        lens = torch.from_numpy(b.lengths.astype(np.int32)).to(dev)
        nbytes, nops = smoke.classify_work(ml, lens)
        out.append(dict(label=f"{b.lanes} lanes x {b.width}",
                        args=(ml, lens, smoke.BIN_WIDTH, thr),
                        bytes=nbytes, bound_ms=smoke.bound(nbytes, nops)[0]))
    del fi
    return out, thr


def kmer_inputs(dev, ix, text):
    """7b's batches on phase 4's index: the k-mer phase's screening reads
    and 10 kb reads."""
    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.testing import screening_reads, sim_reads

    k = smoke.KMER_K
    s2 = ts2.build_fused_search2_index(ix, dev)
    short = screening_reads(text, smoke.KMER_LANES, smoke.READ_LEN,
                            seed=smoke.KMER_SEED)
    longs = sim_reads(text, smoke.LONG_READS, smoke.LONG_LEN, seed=43)
    reads = ([(f"m{i}", s.tobytes()) for i, s in enumerate(short)]
             + [(f"l{i}", s.tobytes()) for i, s in enumerate(longs)])
    out = []
    for b in _as_batches(reads, smoke.QUERY_LANES):
        slots, lane, start = smoke.kmer_batch_inputs(b, s2.alphamap_query, k,
                                                     dev)
        out.append(dict(label=f"{b.lanes} lanes x {b.width}",
                        args=(s2.rec_all, s2.init_rec, s2.all_p, s2.r,
                              s2.sigma, slots, lane, start, k)))
    return out


def left_inputs(dev):
    """11b's batches: the MEM phase's index and k-mer reads behind this
    tree's kernel 11a, with the row tally's partials, pair steps, rows
    and the bytes they give."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused_kmer2 as tk2
    from movi_tpu_torch.testing import (index_from_text, random_text,
                                        screening_reads, with_revcomp)

    k = smoke.KMER_K
    half = random_text(smoke.MEM_RC_HALF, 1)
    index = Index(index_from_text(with_revcomp(half)))
    index.mem_engine(smoke.MEM_L, dev)  # the ftab-10 table
    keng = index.kmer_engine(k, True, True, dev)
    m2, s2, p = keng.m2, keng.s2, keng.p
    reads = smoke.main_reads(half, smoke.MEM_LANES, smoke.LONG_READS,
                             smoke.LONG_LEN, smoke.MEM_SEED, "m")
    kshort = screening_reads(half, smoke.MEM_LANES, smoke.READ_LEN,
                             seed=smoke.KMER_SEED)
    kreads = ([(f"k{i}", s.tobytes()) for i, s in enumerate(kshort)]
              + reads[smoke.MEM_LANES:])
    out = []
    for b in _as_batches(kreads, smoke.QUERY_LANES):
        slots, own, anchor = keng.prepare(b)
        right = kernels.kmer2_right_scan(m2.rec_all, m2.init_rec6, m2.r,
                                         m2.sigma, m2.n, m2.ftab_k, slots,
                                         own, anchor, k)
        found, cnt, rows, steps = tk2.kmer2_left_rows_plain(
            m2, s2, *right, slots, own, anchor, k, p)
        G = own.shape[0]
        live = smoke.live_partials(right[0], anchor, p)
        n_steps, n_rows = int(steps.sum()), int(rows.sum())
        nbytes = (slots.numel() + 8 * G + live * (64 + 8) + 24 * n_rows
                  + p * G * (1 + 5))
        out.append(dict(
            label=f"{b.lanes} lanes x {b.width}", groups=G, live=live,
            pair_steps=n_steps, rows=n_rows,
            rows_share=n_rows / max(2 * n_steps, 1), bytes=nbytes,
            bound_ms=smoke.bound(nbytes, (n_steps + live)
                                 * smoke.OPS_PER_ROW)[0],
            sector_ms=nbytes / SECTOR_BYTES_PER_S * 1e3,
            tally=(found, cnt),
            args=(m2.rec_all, m2.r, m2.sigma, m2.n, m2.ftab_k, s2.rec_all,
                  s2.all_p, slots, own, anchor, *right, k, p)))
        torch.cuda.empty_cache()
    return out


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
        print("classify_kmer2_trials: no CUDA card", file=sys.stderr)
        return 1
    from movi_tpu_torch import kernels
    from movi_tpu_torch.build.suffix import _load_native
    from movi_tpu_torch.device import card_line, resolve_device
    from movi_tpu_torch.parallel import mesh as tmesh
    from movi_tpu_torch.testing import index_from_text, random_text

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
        kernels._load()  # this tree's whole library: kernels 1 and 11a
        jobs = {"parent": (args.parent, [])}
        jobs.update({name: (here, p) for name, p in VARIANTS.items()})
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
        print(f"[trials] built {len(libs)} libraries in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        for tag, csrc in (("parent", args.parent), ("this tree", here)):
            for line in ptxas_registers(csrc, work, tag.replace(" ", "_")):
                print(f"[trials] -Xptxas -v {tag}: {line}", flush=True)
    sass_of = {}
    for name in libs:
        so = os.path.join(args.out, name.replace(" ", "_") + ".so")
        sass_of[name] = disassemble(so)
        with open(so[:-3] + ".sass", "w") as f:
            f.write(sass_of[name])
        for fn in SASS_FUNCTIONS[1:]:
            n, pred = loads(sass_of[name], fn)
            print(f"[trials] SASS {name} {report(sass_of[name], fn)}; {n} "
                  f"global loads in the loop, {pred} predicated", flush=True)
        print(f"[trials] registers {name}: " + "; ".join(
            registers(so, fn) for fn in SASS_FUNCTIONS), flush=True)
    body_7b = [sass_lines(sass_of[name], SASS_FUNCTIONS[2])
               for name in ("parent", "this tree")]
    same_7b = body_7b[0] == body_7b[1]
    print(f"[trials] 7b's SASS is the parent's: {same_7b} ("
          f"{len(body_7b[0])} and {len(body_7b[1])} instructions, "
          f"{sum(x != y for x, y in zip(*body_7b))} differ in place)",
          flush=True)

    t0 = time.perf_counter()
    text = random_text(smoke.FULL_TEXT, 0)
    ix = index_from_text(text)
    cls, thr = classify_inputs(dev, ix, text)
    k7 = kmer_inputs(dev, ix, text)
    del ix
    left = left_inputs(dev)
    print(f"[trials] inputs built in {time.perf_counter() - t0:.1f} s; 16a "
          f"threshold {thr}", flush=True)
    for b in cls:
        print(f"[trials] 16a batch {b['label']}: {b['bytes']} B, bound "
              f"{b['bound_ms']:.6f} ms", flush=True)
    for b in left:
        print(f"[trials] 11b batch {b['label']}: {b['groups']} groups, "
              f"{b['live']} live partials, {b['pair_steps']} pair steps, "
              f"{b['rows']} rows ({b['rows_share']:.6f} of two a pair "
              f"step), {b['bytes']} B: bound {b['bound_ms']:.6f} ms, at "
              f"1.0 TB/s of sectors {b['sector_ms']:.6f} ms", flush=True)

    kern = {"16a": (kernels.classify_from_ml, cls),
            "11b": (kernels.kmer2_left_scan, left),
            "7b": (kernels.fused2_kmer_count_scan, k7)}
    old_lib = kernels._lib
    ref, times = {}, {}
    order = [(rnd, name) for rnd, name in enumerate(ORDER) if name in libs]
    old_16a = parent_classify(libs["parent"])
    for rnd, name in order:
        kernels._lib = libs[name]
        for which, (fn, batches) in kern.items():
            if which == "16a" and name == "parent":
                fn = old_16a
            for i, b in enumerate(batches):
                a = b["args"]
                out = [t.clone() for t in fn(*a)]
                torch.cuda.synchronize()
                if (which, i) not in ref:
                    ref[which, i] = out
                elif not all(torch.equal(x, y)
                             for x, y in zip(out, ref[which, i])):
                    raise AssertionError(f"{name}: {which} on {b['label']} "
                                         f"differs from the parent's")
                if name == "this tree":
                    want = (tmesh.classify_from_ml_plain(*a)
                            if which == "16a" else b.get("tally"))
                    if want is not None and not all(
                            torch.equal(x, y) for x, y in zip(out, want)):
                        raise AssertionError(
                            f"{which} on {b['label']} differs from its "
                            f"plain version")
                ms = statistics.median(smoke.cuda_ms(lambda: fn(*a), REPS)
                                       for _ in range(TIMINGS))
                dms = statistics.median(device_ms(fn, a)
                                        for _ in range(TIMINGS))
                times.setdefault((name, rnd), {}).setdefault(
                    which, []).append((ms, dms))
    kernels._lib = old_lib

    rows = []
    for (name, rnd), per in times.items():
        row = dict(library=name, round=rnd)
        for which, ms in per.items():
            row[which] = dict(
                query_ms=sum(t for t, _ in ms),
                device_ms=sum(t for _, t in ms), batches=[
                    dict(label=b["label"], ms=t, device_ms=dt)
                    for b, (t, dt) in zip(kern[which][1], ms)])
        rows.append(row)
        print(f"[trials] {name} (round {rnd}): " + "; ".join(
            f"{which} {row[which]['query_ms']:.6f} ms a query (device "
            f"{row[which]['device_ms']:.6f}), per batch "
            + ", ".join(f"{x['label']}: {x['ms']:.6f} ({x['device_ms']:.6f})"
                        for x in row[which]["batches"])
            for which in per) + f"  ({card})", flush=True)
    with open(os.path.join(args.out, "trials.json"), "w") as f:
        json.dump({"card": card, "threshold_16a": thr,
                   "batches_16a": [{x: b[x] for x in b if x != "args"}
                                   for b in cls],
                   "batches_11b": [{x: b[x] for x in b
                                    if x not in ("args", "tally")}
                                   for b in left],
                   "sass_7b_same": same_7b, "rows": rows}, f, indent=1)
    print("[trials] every library's outputs equal the parent's; this "
          "tree's 16a equals its plain version and 11b its row tally",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
