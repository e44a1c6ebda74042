#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (movi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the three CUDA kernels from movi_tpu_torch/csrc, checks each one
against its plain PyTorch version on the card, drives the PML main path
(`Index.query_pml`, both record layouts, and `python -m
movi_tpu_torch.cli query --pml --classify`) at a real index size, checks
the answers against the scalar oracle, and prints timings with the card's
name and power limit.  Phases:

  1. device   the card, and its nvidia-smi name and power limit
  2. build    nvcc of the kernels; `make -C native` for the host SA-IS
  3. small    5,000-base index: each kernel equals its plain version on
              the card (ml, carried state, the compose table); both
              layouts equal ScalarEngine; kernel 3 on synthetic records
              whose run ids pass 2^24 (w0's sign bit)
  4. full     bench.py's synthetic index (6 Mb random ACGT, seed 0,
              regular thresholds, bound_ff=1): 32,768 reads x 150 bp with
              1% substitutions (seed 42) plus 64 reads of 10 kb, through
              Index.query_pml(paired=False) and then paired=True (the
              compose runs on the card); every kernel's output equals its
              plain version over all lanes; 256 sampled reads equal
              ScalarEngine; every launch counter is above 0; timings
              (CUDA events) of each scan over the batches the main path
              ran and of the compose, the scan rate against lanes, and
              where a warm query_pml's time goes (host stages, the
              device's busy and idle shares)
  5. cli     the port's CLI on the card against an index that
              `movi_tpu.cli build` made; its report equals --platform cpu

Any failed check raises and the script exits nonzero.  The line before
the last is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}.  Without a card it exits nonzero and
prints no result.  It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

FULL_TEXT = 6_000_000     # bench.py HBM_TEXT
FULL_LANES = 32768        # bench.py LANES
READ_LEN = 150            # bench.py READ_LEN
LONG_READS = 64
LONG_LEN = 10_000
QUERY_LANES = 8192        # Index.query_pml's default batch
ORACLE_SAMPLE = 256

CUDA_SOURCES = {
    "fused_pml_scan": ("movi_tpu_torch/csrc/fused_pml.cu",
                       "movi_tpu/engine/fused.py:312"),
    "compose_paired_records": ("movi_tpu_torch/csrc/compose2.cu",
                               "movi_tpu/engine/fused2.py:96"),
    "fused2_pml_scan": ("movi_tpu_torch/csrc/fused2_pml.cu",
                        "movi_tpu/engine/fused2.py:355"),
}


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call between CUDA events, after warmup."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def max_abs_err(a, b):
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def require_equal(what, a, b, errs=None, key=None):
    err = max_abs_err(a, b)
    if errs is not None:
        errs[key] = max(errs.get(key, 0), err)
    if err != 0:
        raise AssertionError(f"{what}: kernel and plain differ "
                             f"(max abs err {err})")


def require_state_equal(what, st_a, st_b, errs, key):
    for name, a, b in zip(("idx", "off", "ml"), st_a, st_b):
        require_equal(f"{what} state {name}", a, b, errs, key)


def timed_ms(fn):
    """fn() and the milliseconds it took on the card (CUDA events)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def scan_pair(kernel, plain, args, what, errs, key):
    """Run a scan kernel and its plain version on the same inputs
    (records, slots, p_dollar, codes, state0); both ml and the carried
    state must agree exactly.  Returns the kernel's ml and the plain
    version's milliseconds."""
    st_k, ml_k = kernel(*args)
    (st_p, ml_p), plain_ms = timed_ms(lambda: plain(*args))
    require_equal(f"{what} ml", ml_k, ml_p, errs, key)
    require_state_equal(what, st_k, st_p, errs, key)
    return ml_k, plain_ms


def check_oracle(what, reads, got, oracle):
    for (name, seq), (gname, pmls) in zip(reads, got):
        if gname != name or pmls != oracle.query_pml(seq):
            raise AssertionError(f"{what}: read {name} differs from "
                                 f"ScalarEngine")


def phase_small(dev, errs):
    import torch

    from movi_tpu.cpu_ref.scalar import ScalarEngine
    from movi_tpu.io.fastx import make_batches
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.testing import length_reads, mixed_reads, small_index

    text, ix = small_index()
    reads = mixed_reads(text) + length_reads(text)
    oracle = ScalarEngine(ix)
    fi = tf.build_fused_index(ix).to(dev)
    slots = fi.sigma + 1
    batch = next(make_batches(reads, lanes=len(reads)))
    st0 = tf.initial_state(fi, batch.lanes, dev)

    eng1 = tf.FusedPMLEngine(fi, dev)
    scan_pair(kernels.fused_pml_scan, tf.fused_pml_scan_plain,
              (fi.records, slots, fi.p_dollar, eng1.prepare(batch), st0),
              "small one-step", errs, "fused_pml_scan")

    table_k, b_k = kernels.compose_paired_records(fi.records, fi.r, slots,
                                                  fi.p_dollar)
    table_p, b_p = tf2.compose_records_plain(fi.records, fi.r, slots,
                                             fi.p_dollar)
    require_equal("small compose table", table_k, table_p, errs,
                  "compose_paired_records")
    if b_k != b_p:
        raise AssertionError(f"compose B range {b_k} != plain {b_p}")

    f2 = tf2.build_fused2_index(fi)
    eng2 = tf2.Fused2PMLEngine(f2, dev)
    a12_t, _ = eng2.prepare(batch)
    scan_pair(kernels.fused2_pml_scan, tf2.fused2_pml_scan_plain,
              (f2.records, slots, f2.p_dollar, a12_t, st0), "small paired",
              errs, "fused2_pml_scan")

    index = Index(ix)
    for paired in (False, True):
        got = index.query_pml(reads, paired=paired, device=dev)
        check_oracle(f"small paired={paired}", reads, got, oracle)
    say("small", f"r={ix.r}: kernels equal plain on {len(reads)} reads "
                 f"(lengths 1-4097, with N); both layouts equal "
                 f"ScalarEngine")

    # kernel 3 on run ids past 2^24: CONST branches whose next state is
    # (A, C), so one pair step writes A out as the run id
    cases = [(0x1ABCDEF, 0x1FFFFFF), (0, tf2.MAX_RUNS - 1),
             (0xFFFFFF, 0x1000000)]
    T1, C_lo, C_hi = 5, 7, 9
    rows = []
    for A_lo, A_hi in cases:
        t = lambda v: torch.tensor([v] * (slots * slots))  # noqa: E731
        k = tf2.KIND_CONST
        rows.append(tf2.pack_words(t(T1), t(1),
                                   (t(A_lo), t(0), t(C_lo), t(k), t(0)),
                                   (t(A_hi), t(0), t(C_hi), t(k), t(0))))
    records = torch.cat(rows).to(dev)
    n = len(cases)
    idx = torch.arange(n, dtype=torch.int32).repeat(2)
    off = torch.tensor([T1 - 1] * n + [T1] * n, dtype=torch.int32)
    state = (idx.to(dev), off.to(dev), torch.zeros_like(idx).to(dev))
    codes = torch.zeros((1, 2 * n), dtype=torch.uint8, device=dev)
    st_k, _ = kernels.fused2_pml_scan(records, slots, (0, 0), codes, state)
    st_p, _ = tf2.fused2_pml_scan_plain(records, slots, (0, 0), codes, state)
    want_idx = [c[0] for c in cases] + [c[1] for c in cases]
    want_off = [C_lo] * n + [C_hi] * n
    if st_k[0].tolist() != want_idx or st_k[1].tolist() != want_off:
        raise AssertionError(f"25-bit decode: got {st_k[0].tolist()}, "
                             f"{st_k[1].tolist()}")
    require_state_equal("25-bit decode", st_k, st_p, errs, "fused2_pml_scan")
    say("small", "kernel 3 decodes run ids up to 2^25-1 (sign bit set) "
                 "exactly")


def phase_full(dev, card, errs, timings, text_len=FULL_TEXT,
               lanes=FULL_LANES, long_reads=LONG_READS, long_len=LONG_LEN):
    import torch

    from movi_tpu.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.testing import index_from_text, random_text, sim_reads

    t0 = time.perf_counter()
    text = random_text(text_len, 0)
    ix = index_from_text(text)
    t_ix = time.perf_counter() - t0
    index = Index(ix)
    t0 = time.perf_counter()
    index._fused = tf.build_fused_index(ix)
    t_fused = time.perf_counter() - t0
    r, slots = ix.r, ix.sigma + 1
    say("full", f"text {text_len} bases, r={r}, one-step table "
                f"{8 * slots * r} B, paired table {16 * slots**2 * r} B")
    say("full", f"host index build {t_ix:.3f} s + one-step records "
                f"{t_fused:.3f} s (host CPU)")

    short = sim_reads(text, lanes, READ_LEN, seed=42)
    longs = sim_reads(text, long_reads, long_len, seed=43)
    reads = ([(f"s{i}", s.tobytes()) for i, s in enumerate(short)]
             + [(f"l{i}", s.tobytes()) for i, s in enumerate(longs)])
    n_bases = lanes * READ_LEN + long_reads * long_len

    # the main path, counted: nothing else launches between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res_one = index.query_pml(reads, paired=False, device=dev)
    torch.cuda.synchronize()
    t_one = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_two = index.query_pml(reads, paired=True, device=dev)
    torch.cuda.synchronize()
    t_two = time.perf_counter() - t0
    counts = dict(kernels.launches)
    say("full", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"main path")
    if res_one != res_two:
        raise AssertionError("one-step and paired layouts disagree")
    say("full", f"query_pml end to end (host clock, {n_bases} bases): "
                f"one-step {t_one:.3f} s = {n_bases / t_one:.6e} bases/s; "
                f"paired incl. compose {t_two:.3f} s = "
                f"{n_bases / t_two:.6e} bases/s  ({card})")

    rng = np.random.default_rng(7)
    pick = np.sort(np.concatenate([
        rng.choice(lanes, ORACLE_SAMPLE - 4, replace=False),
        lanes + rng.choice(long_reads, 4, replace=False)]))
    oracle = ScalarEngine(ix)
    check_oracle("full sample", [reads[i] for i in pick],
                 [res_one[i] for i in pick], oracle)
    say("full", f"{len(pick)} sampled reads equal ScalarEngine")

    # every kernel against its plain version over all lanes, on the
    # batches the main path ran; the plain scans are timed in this pass
    fi = index._fused
    f2 = index._paired
    eng1 = tf.FusedPMLEngine(fi, dev)
    eng2 = tf2.Fused2PMLEngine(f2, dev)
    comp = (fi.records, r, slots, fi.p_dollar)
    (table_p, b_p), compose_plain_ms = timed_ms(
        lambda: tf2.compose_records_plain(*comp))
    require_equal("full compose table", f2.records, table_p, errs,
                  "compose_paired_records")
    del table_p
    batches = list(_as_batches(reads, QUERY_LANES))
    args = {"fused_pml_scan": [], "fused2_pml_scan": []}
    plain_ms = {"fused_pml_scan": 0.0, "fused2_pml_scan": 0.0}
    for batch in batches:
        st0 = tf.initial_state(fi, batch.lanes, dev)
        a1 = (fi.records, slots, fi.p_dollar, eng1.prepare(batch), st0)
        a12_t, W = eng2.prepare(batch)
        a2 = (f2.records, slots, f2.p_dollar, a12_t, st0)
        ml1, ms1 = scan_pair(kernels.fused_pml_scan, tf.fused_pml_scan_plain,
                             a1, "full one-step", errs, "fused_pml_scan")
        ml2, ms2 = scan_pair(kernels.fused2_pml_scan,
                             tf2.fused2_pml_scan_plain, a2, "full paired",
                             errs, "fused2_pml_scan")
        require_equal("full layouts", ml1, ml2[:W])
        args["fused_pml_scan"].append(a1)
        args["fused2_pml_scan"].append(a2)
        plain_ms["fused_pml_scan"] += ms1
        plain_ms["fused2_pml_scan"] += ms2
    say("full", "each kernel equals its plain version over all lanes")

    # timings at the main path's shapes, CUDA events: a scan's time is
    # that of all the batches of one query_pml, as the main path ran them
    shapes = [tuple(b.seqs.shape) for b in batches]
    kfn = {"fused_pml_scan": kernels.fused_pml_scan,
           "fused2_pml_scan": kernels.fused2_pml_scan}
    for name, fn in kfn.items():
        timings[name] = (
            cuda_ms(lambda: [fn(*a) for a in args[name]], reps=10),
            plain_ms[name])
        per_batch = [cuda_ms(lambda: fn(*a), reps=10) for a in args[name]]
        timings[name + ".per_batch"] = per_batch
    timings["compose_paired_records"] = (
        cuda_ms(lambda: kernels.compose_paired_records(*comp), reps=3),
        compose_plain_ms)
    for name, layout in (("fused_pml_scan", "one-step"),
                         ("fused2_pml_scan", "paired")):
        k_ms, p_ms = timings[name]
        per = ", ".join(f"{lanes_b} lanes x {w_b}: {ms:.6f} ms"
                        for (lanes_b, w_b), ms in
                        zip(shapes, timings[name + ".per_batch"]))
        say("full", f"{layout} scan over the main path's {len(batches)} "
                    f"batches ({n_bases} bases): kernel {k_ms:.6f} ms = "
                    f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                    f"{p_ms:.6f} ms = {n_bases / p_ms * 1e3:.6e} bases/s; "
                    f"kernel per batch [{per}]  ({card})")
    k_ms, p_ms = timings["compose_paired_records"]
    say("full", f"compose r={r}: kernel {k_ms / 1e3:.6f} s, plain "
                f"{p_ms / 1e3:.6f} s  ({card})")

    # scan rate against lanes in flight: the first 150 bp batch's codes,
    # repeated across more lanes
    for name, fn, a in (("one-step", kernels.fused_pml_scan,
                         args["fused_pml_scan"][0]),
                        ("paired", kernels.fused2_pml_scan,
                         args["fused2_pml_scan"][0])):
        rates = []
        for rep in (1, 4, 16, 64):
            codes = a[3].repeat(1, rep)
            st = tf.initial_state(fi, codes.shape[1], dev)
            ms = cuda_ms(lambda: fn(*a[:3], codes, st), reps=10)
            rates.append(f"{codes.shape[1]} lanes {ms:.6f} ms = "
                         f"{codes.shape[1] * READ_LEN / ms * 1e3:.6e} "
                         f"bases/s")
        say("full", f"{name} scan, {READ_LEN} bp, against lanes: "
                    f"{'; '.join(rates)}  ({card})")

    # where a warm query_pml's time goes (tables on the card, kernels
    # loaded): host batching, prepare + scan (read codes to the card and
    # the kernel), trim (ml to the host, per-read lists)
    for paired, name in ((False, "fused_pml_scan"),
                         (True, "fused2_pml_scan")):
        layout = "paired" if paired else "one-step"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.query_pml(reads, paired=paired, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        eng = index.engine(paired, dev)
        t0 = time.perf_counter()
        bs = list(_as_batches(reads, QUERY_LANES))
        t_batch = time.perf_counter() - t0
        t_scan = t_trim = 0.0
        for b in bs:
            t0 = time.perf_counter()
            ml = eng.query_batch_device(b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tf.trim(ml, b)
            t_scan += t1 - t0
            t_trim += time.perf_counter() - t1
        k_ms = timings[name][0]
        busy = k_ms / 1e3 / wall
        say("full", f"warm query_pml {layout}: wall {wall:.6f} s = "
                    f"{n_bases / wall:.6e} bases/s; kernel {k_ms:.6f} ms, "
                    f"device busy share (kernel / wall) {busy:.6f}, idle "
                    f"share "
                    f"{1 - busy:.6f}; host stages: batching {t_batch:.6f} s, "
                    f"prepare+scan {t_scan:.6f} s, trim {t_trim:.6f} s  "
                    f"({card})")
    say("full", f"peak device memory {torch.cuda.max_memory_allocated(dev)}"
                f" B  ({card})")
    return counts


def phase_cli(platform):
    from movi_tpu_torch.testing import mixed_reads, random_text

    with tempfile.TemporaryDirectory() as d:
        refs = [random_text(20000, 11), random_text(15000, 12)]
        fasta = os.path.join(d, "ref.fa")
        with open(fasta, "w") as f:
            for i, t in enumerate(refs):
                f.write(f">doc{i}\n{t.tobytes().decode()}\n")
        idx = os.path.join(d, "idx")
        subprocess.run([sys.executable, "-m", "movi_tpu.cli", "build",
                        "--fasta", fasta, "--index", idx], cwd=ROOT,
                       check=True, capture_output=True, timeout=600)
        reads = mixed_reads(refs[0], seed=5, count=30)
        rng = np.random.default_rng(4)
        for i in range(30):
            src = refs[1] if i % 2 else random_text(1000, 100 + i)
            s = int(rng.integers(0, len(src) - 600))
            reads.append((f"long{i}", src[s:s + 600].tobytes()))
        rpath = os.path.join(d, "reads.fa")
        with open(rpath, "w") as f:
            f.writelines(f">{n}\n{s.decode()}\n" for n, s in reads)
        report = f"{rpath}.regular-thresholds.pml.report"
        texts = {}
        for plat in (platform, "cpu"):
            subprocess.run([sys.executable, "-m", "movi_tpu_torch.cli",
                            "query", "--index", idx, "--read", rpath,
                            "--pml", "--classify", "--platform", plat,
                            "--out-file", os.path.join(d, plat)],
                           cwd=ROOT, check=True,
                           capture_output=True, timeout=600)
            with open(report) as f:
                texts[plat] = f.read()
            os.unlink(report)
        if texts[platform] != texts["cpu"]:
            raise AssertionError("CLI --classify report differs between "
                                 f"--platform {platform} and cpu")
        n_found = sum(ln.split()[1] == "FOUND"
                      for ln in texts["cpu"].splitlines()[1:]
                      if len(ln.split()) > 1)
    say("cli", f"query --pml --classify on --platform {platform}: report "
               f"({len(reads)} reads, {n_found} found) equals "
               f"--platform cpu")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the smoke "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from movi_tpu.build.suffix import _load_native
    from movi_tpu_torch import kernels
    from movi_tpu_torch.device import card_line, resolve_device

    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line(dev)
    say("device", f"{kind}; torch {torch.__version__}, CUDA "
                  f"{torch.version.cuda}")
    print(card, flush=True)

    t0 = time.perf_counter()
    so = kernels.build()
    kernels._load()
    say("build", f"nvcc sm_90a build of {len(CUDA_SOURCES)} kernels: "
                 f"{time.perf_counter() - t0:.3f} s -> "
                 f"{os.path.relpath(so, ROOT)}")
    mk = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                        capture_output=True, text=True, timeout=600)
    if mk.returncode != 0 or not _load_native():
        raise RuntimeError(f"make -C native failed (rc {mk.returncode}) or "
                           f"its library does not load:\n{mk.stderr}")
    say("build", "make -C native: rc 0; native SA-IS yes")

    errs = {}
    timings = {}
    phase_small(dev, errs)
    counts = phase_full(dev, card, errs, timings)
    phase_cli("gpu")

    rows = [dict(name=name, route="cuda", source=src, replaces=rep,
                 launches=counts[name], max_abs_err=errs[name],
                 ms=timings[name][0], plain_ms=timings[name][1])
            for name, (src, rep) in CUDA_SOURCES.items()]
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
