#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (movi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from movi_tpu_torch/csrc (eight sources, eleven
launch counters), checks each one against its plain PyTorch version on
the card, drives the PML, count, ZML and Movi Color paths
(`Index.query_pml`, `query_count`, `query_zml` and `query_multiclass`/
`multi_classify`, both record layouts each, and
`python -m movi_tpu_torch.cli query`) at a real index size, checks the
answers against the scalar oracles, and prints timings with the card's
name and power limit.  Phases:

  1. device   the card, and its nvidia-smi name and power limit
  2. build    nvcc of the kernels; `make -C native` for the host SA-IS
  3. small    5,000-base index: each kernel equals its plain version on
              the card (ml or count, carried state, a scan split in two
              equal to one pass, the compose tables); every layout of PML,
              count and ZML equals ScalarEngine; kernel 3 on synthetic
              records whose run ids pass 2^24 (w0's sign bit)
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
  5. search   the same index and reads through Index.query_count and
              query_zml, paired=False then paired=True (the paired search
              compose runs on the card), counted apart from phase 4: the
              two layouts agree, 256 sampled reads equal ScalarEngine,
              kernels 4-6 equal their plain versions over all lanes and
              the whole table, their timings, and a warm breakdown for
              each (query, layout)
  6. small color  the three-document index of tests/test_fused_color.py:
              kernels A (3-word and two-load forms), B and C equal their
              plain versions with early stop off and on (ml, color ids,
              carried state, a scan split in two equal to one pass, the
              compose table with real color ids and with ids past 2^15);
              the one-step, two-load and paired engines equal ColorEngine
              for every read; two exact 70 kb reads (5*csum past 2^31)
              run to their end with early stop on (64-bit csum)
  7. color    a 12-genome pangenome (12 x 500,000 bases, one ancestor
              with 2% substitutions per genome, 12 species): 32,768 x
              150 bp reads from the genomes (1% substitutions, seed 42),
              64 x 10 kb from the genomes (seed 43) and 64 x 10 kb random
              (seed 44) through Index.query_multiclass one-step and
              paired (the color compose runs on the card), early stop off
              and on, counted apart: the layouts agree, 256 sampled reads
              equal ColorEngine, kernels A-C equal their plain versions
              over all lanes and the whole table, timings and a warm
              breakdown;
              then a 24-genome pangenome (24 x 250,000 bases) whose
              compressed color table keeps 2^16 sets: the two-load form
              of kernel A, counted apart
  8. cli     the port's CLI on the card against an index that
              `movi_tpu.cli build --color` made: the PML and ZML
              --classify reports, the count .matches file, ZML --stdout,
              and --multi-classify (the CSV and .colors file, and
              --early-stop --report-all on stdout) equal --platform cpu

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
    "fused_count_scan": ("movi_tpu_torch/csrc/fused_search.cu",
                         "movi_tpu/engine/fused_search.py:263"),
    "fused_zml_scan": ("movi_tpu_torch/csrc/fused_search.cu",
                       "movi_tpu/engine/fused_search.py:300"),
    "compose_search2_records": ("movi_tpu_torch/csrc/compose_search2.cu",
                                "movi_tpu/engine/fused_search2.py:101"),
    "fused2_count_scan": ("movi_tpu_torch/csrc/fused_search2.cu",
                          "movi_tpu/engine/fused_search2.py:383"),
    "fused2_zml_scan": ("movi_tpu_torch/csrc/fused_search2.cu",
                        "movi_tpu/engine/fused_search2.py:442"),
    "fused_color_scan": ("movi_tpu_torch/csrc/fused_color.cu",
                         "movi_tpu/engine/fused_color.py:113"),
    "compose_paired_color_records": ("movi_tpu_torch/csrc/compose2.cu",
                                     "movi_tpu/engine/fused2.py:96"),
    "fused2_color_scan": ("movi_tpu_torch/csrc/fused2_color.cu",
                          "movi_tpu/engine/fused2.py:482"),
}
PML_KERNELS = ("fused_pml_scan", "compose_paired_records", "fused2_pml_scan")
SEARCH_KERNELS = ("fused_count_scan", "fused_zml_scan",
                  "compose_search2_records", "fused2_count_scan",
                  "fused2_zml_scan")
COLOR_KERNELS = ("fused_color_scan", "compose_paired_color_records",
                 "fused2_color_scan")
COLOR_GENOMES = 12        # the 12-genome pangenome of phase 7
COLOR_GENOME_LEN = 500_000
WIDE_GENOMES = 24         # its 24-genome, 2^16-set compressed twin
WIDE_GENOME_LEN = 250_000
EXACT_LEN = 70_000        # exact reads whose 5*csum passes 2^31


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


def require_search_equal(what, kernel_out, plain_out, errs, key):
    """A search scan's (state [6, lanes], out) from the kernel and the
    plain version must agree exactly."""
    (st_k, out_k), (st_p, out_p) = kernel_out, plain_out
    require_equal(f"{what} out", out_k, out_p, errs, key)
    require_equal(f"{what} state", st_k, st_p, errs, key)


def search_pair(kernel, plain, args, kw, what, errs, key, split=None):
    """Run a search scan kernel and its plain version on the same inputs
    (args, then the chars as args[-1]); with `split`, the kernel also
    runs in two pieces carried through its state, which must equal one
    pass.  Returns the plain version's milliseconds."""
    import torch

    got = kernel(*args, **kw)
    want, plain_ms = timed_ms(lambda: plain(*args, **kw))
    require_search_equal(what, got, want, errs, key)
    if split is not None:
        codes = args[-1]
        st, out1 = kernel(*args[:-1], codes[:split], **kw)
        st, out2 = kernel(*args[:-1], codes[split:], st)
        if got[1].dim() == 2:  # ml rows: the pieces concatenate
            require_equal(f"{what} split ml", torch.cat([out1, out2]),
                          got[1], errs, key)
        else:  # count: the last piece's count is the pass's
            require_equal(f"{what} split count", out2, got[1], errs, key)
        require_equal(f"{what} split state", st, got[0], errs, key)
    return plain_ms


def search_args(kind, s, batch, dev):
    """(kernel, plain, args, kw) of each search scan for one batch: the
    one-step index `s` for kind "count"/"zml", the paired one for
    "count2"/"zml2", with the codes its engine prepares."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2

    if kind == "count":
        codes = ts.FusedCountEngine(s, dev).prepare(batch)
        return (kernels.fused_count_scan, ts.fused_count_scan_plain,
                (s.rec_all, s.init_rec, s.all_p, s.r, s.sigma, codes), {})
    if kind == "zml":
        codes = ts.FusedZMLEngine(s, dev).prepare(batch)
        return (kernels.fused_zml_scan, ts.fused_zml_scan_plain,
                (s.rec_all, s.init_rec, s.r, s.sigma, codes), {})
    if kind == "count2":
        a0, pairs = ts2.Fused2CountEngine(s, dev).prepare(batch)
        return (kernels.fused2_count_scan, ts2.fused2_count_scan_plain,
                (s.rec_all, s.init_rec, s.all_p, s.r, s.sigma, pairs),
                {"a0": a0})
    codes = ts2.Fused2ZMLEngine(s, dev).prepare(batch)
    return (kernels.fused2_zml_scan, ts2.fused2_zml_scan_plain,
            (s.rec_all, s.init_rec, s.restart_rec, s.r, s.sigma, codes), {})


SCAN_OF = {"count": "fused_count_scan", "zml": "fused_zml_scan",
           "count2": "fused2_count_scan", "zml2": "fused2_zml_scan"}


def compose_inputs(ix, dev):
    """The paired search compose's inputs as int32 tensors on dev."""
    import torch

    nu, nd = ix.next_tables_search()
    return [torch.from_numpy(np.asarray(x).astype(np.int32)).to(dev)
            for x in (ix.id_arr, ix.offset_arr, ix.n_arr, nu, nd)]


def check_search_oracle(what, reads, count, zml, oracle):
    for (name, seq), (cn, c), (zn, z) in zip(reads, count, zml):
        if cn != name or c != oracle.query_count(seq):
            raise AssertionError(f"{what}: count of read {name} differs "
                                 f"from ScalarEngine")
        if zn != name or z != oracle.query_zml(seq):
            raise AssertionError(f"{what}: ZML of read {name} differs "
                                 f"from ScalarEngine")


def phase_small_search(dev, errs):
    from movi_tpu.cpu_ref.scalar import ScalarEngine
    from movi_tpu.io.fastx import make_batches
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.testing import length_reads, mixed_reads, small_index

    text, ix = small_index()
    reads = mixed_reads(text) + length_reads(text)
    oracle = ScalarEngine(ix)
    batch = next(make_batches(reads, lanes=len(reads)))
    si = ts.build_fused_search_index(ix).to(dev)

    comp = compose_inputs(ix, dev)
    table_k = kernels.compose_search2_records(*comp, ix.r, ix.sigma)
    table_p = ts2.compose_search2_plain(*comp, ix.r, ix.sigma)
    require_equal("small search compose table", table_k, table_p, errs,
                  "compose_search2_records")
    s2 = ts2.build_fused_search2_index(ix, dev)
    for kind in SCAN_OF:
        kern, plain, args, kw = search_args(kind, s2 if "2" in kind else si,
                                            batch, dev)
        # split at an odd step: one char past a pair boundary for the
        # one-step scans, an odd pair count for the paired ones
        search_pair(kern, plain, args, kw, f"small {kind}", errs,
                    SCAN_OF[kind], split=args[-1].shape[0] // 2 | 1)

    index = Index(ix)
    for paired in (False, True):
        check_search_oracle(
            f"small paired={paired}", reads,
            index.query_count(reads, paired=paired, device=dev),
            index.query_zml(reads, paired=paired, device=dev), oracle)
    say("small", f"r={ix.r}: kernels 4-6 equal plain (count, ml, state, a "
                 f"scan split in two, the compose table) on {len(reads)} "
                 f"reads; count and ZML in both layouts equal ScalarEngine")


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
    counts = {k: kernels.launches[k] for k in PML_KERNELS}
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
    return counts, dict(index=index, reads=reads, n_bases=n_bases,
                        pick=pick, oracle=oracle)


def phase_search(dev, card, errs, timings, ctx):
    """Count and ZML on phase 4's index and reads, counted apart."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.engine.fused import trim

    index, reads, n_bases = ctx["index"], ctx["reads"], ctx["n_bases"]
    ix = index.ix
    r, sigma = ix.r, ix.sigma
    say("search", f"r={r}: one-step search table {32 * sigma * r} B, "
                  f"paired search table {48 * sigma * sigma * r} B")
    torch.cuda.reset_peak_memory_stats(dev)

    # the count and ZML paths, counted: nothing else launches between
    # reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    res, walls = {}, {}
    for paired in (False, True):
        for kind, query in (("count", index.query_count),
                            ("zml", index.query_zml)):
            t0 = time.perf_counter()
            res[kind, paired] = query(reads, paired=paired, device=dev)
            torch.cuda.synchronize()
            walls[kind, paired] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in SEARCH_KERNELS}
    say("search", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"count/ZML path")
    for kind in ("count", "zml"):
        if res[kind, False] != res[kind, True]:
            raise AssertionError(f"{kind}: one-step and paired layouts "
                                 f"disagree")
    say("search", "cold end to end (host clock, " + str(n_bases)
        + " bases): " + "; ".join(
            f"{kind} {'paired incl. compose' if p else 'one-step'} "
            f"{w:.3f} s = {n_bases / w:.6e} bases/s"
            for (kind, p), w in walls.items()) + f"  ({card})")
    pick = ctx["pick"]
    check_search_oracle("full sample", [reads[i] for i in pick],
                        [res["count", False][i] for i in pick],
                        [res["zml", False][i] for i in pick], ctx["oracle"])
    say("search", f"{len(pick)} sampled reads equal ScalarEngine (count "
                  f"and ZML)")

    # every kernel against its plain version over all lanes of the
    # batches the main path ran, and the compose over the whole table
    si, s2 = index._search, index._paired_search
    comp = compose_inputs(ix, dev)
    table_p, compose_plain_ms = timed_ms(
        lambda: ts2.compose_search2_plain(*comp, r, sigma))
    require_equal("full search compose table", s2.rec_all, table_p, errs,
                  "compose_search2_records")
    del table_p
    batches = list(_as_batches(reads, QUERY_LANES))
    args = {k: [] for k in SCAN_OF}
    plain_ms = dict.fromkeys(SCAN_OF, 0.0)
    for batch in batches:
        for kind in SCAN_OF:
            kern, plain, a, kw = search_args(kind, s2 if "2" in kind else si,
                                             batch, dev)
            plain_ms[kind] += search_pair(kern, plain, a, kw, f"full {kind}",
                                          errs, SCAN_OF[kind])
            args[kind].append((kern, a, kw))
    say("search", "kernels 4-6 equal their plain versions over all lanes "
                  "and the whole table")

    shapes = [tuple(b.seqs.shape) for b in batches]
    for kind, name in SCAN_OF.items():
        runs = args[kind]
        k_ms = cuda_ms(lambda: [fn(*a, **kw) for fn, a, kw in runs], reps=5)
        timings[name] = (k_ms, plain_ms[kind])
        per = [cuda_ms(lambda: fn(*a, **kw), reps=5) for fn, a, kw in runs]
        per_s = ", ".join(f"{lanes_b} lanes x {w_b}: {ms:.6f} ms"
                          for (lanes_b, w_b), ms in zip(shapes, per))
        say("search", f"{name} over the main path's {len(batches)} batches "
                      f"({n_bases} bases): kernel {k_ms:.6f} ms = "
                      f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                      f"{plain_ms[kind]:.6f} ms = "
                      f"{n_bases / plain_ms[kind] * 1e3:.6e} bases/s; kernel "
                      f"per batch [{per_s}]  ({card})")
    k_ms = cuda_ms(lambda: kernels.compose_search2_records(*comp, r, sigma),
                   reps=3)
    timings["compose_search2_records"] = (k_ms, compose_plain_ms)
    say("search", f"search compose r={r}: kernel {k_ms / 1e3:.6f} s, plain "
                  f"{compose_plain_ms / 1e3:.6f} s  ({card})")
    del comp

    # where a warm query's time goes: host batching, prepare + scan (codes
    # to the card and the kernel), trim (results to the host, per-read
    # lists)
    for paired in (False, True):
        layout = "paired" if paired else "one-step"
        for kind in ("count", "zml"):
            query = index.query_count if kind == "count" else index.query_zml
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            query(reads, paired=paired, device=dev)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            eng = index.search_engine(kind, paired, dev)
            t0 = time.perf_counter()
            bs = list(_as_batches(reads, QUERY_LANES))
            t_batch = time.perf_counter() - t0
            t_scan = t_trim = 0.0
            for b in bs:
                t0 = time.perf_counter()
                out = eng.query_batch_device(b)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                if kind == "count":
                    ts.count_results(b, *out)
                else:
                    trim(out, b)
                t_scan += t1 - t0
                t_trim += time.perf_counter() - t1
            k_ms = timings[SCAN_OF[kind + ("2" if paired else "")]][0]
            busy = k_ms / 1e3 / wall
            say("search", f"warm query_{kind} {layout}: wall {wall:.6f} s = "
                          f"{n_bases / wall:.6e} bases/s; kernel "
                          f"{k_ms:.6f} ms, device busy share (kernel / "
                          f"wall) {busy:.6f}, idle share {1 - busy:.6f}; "
                          f"host stages: batching {t_batch:.6f} s, "
                          f"prepare+scan {t_scan:.6f} s, trim "
                          f"{t_trim:.6f} s  ({card})")
    say("search", f"peak device memory in this phase "
                  f"{torch.cuda.max_memory_allocated(dev)} B  ({card})")
    return counts


def require_color_equal(what, got, want, errs, key):
    """A color scan's (state, ml, cid) from the kernel and the plain
    version must agree exactly, the early-stop state included."""
    (st_k, ml_k, cid_k), (st_p, ml_p, cid_p) = got, want
    require_equal(f"{what} ml", ml_k, ml_p, errs, key)
    require_equal(f"{what} cid", cid_k, cid_p, errs, key)
    for i, (a, b) in enumerate(zip(st_k, st_p)):
        require_equal(f"{what} state[{i}]", a, b, errs, key)


def color_scan(eng, batch):
    """(kernel, plain, args, kw, rows per code) of a color engine's scan
    of one batch: args (records, slots, p_dollar, codes, state), kw the
    color ids of the two-load form and the early-stop lengths."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.engine import fused_color as tfc

    if isinstance(eng, tf2.Fused2ColorEngine):
        (rec, slots, pd, codes, st, lens), _ = eng.scan_args(batch)
        return (kernels.fused2_color_scan, tf2.fused2_color_scan_plain,
                (rec, slots, pd, codes, st), dict(lens=lens), 2)
    rec, slots, pd, codes, st, cids, lens = eng.scan_args(batch)
    return (kernels.fused_color_scan, tfc.fused_color_scan_plain,
            (rec, slots, pd, codes, st), dict(cids=cids, lens=lens), 1)


def color_pair(eng, batch, what, errs, key, split=False):
    """Run an engine's color scan kernel and plain version on one batch;
    with `split`, the kernel also runs in two pieces carried through its
    state and t0, which must equal one pass.  Returns (the kernel's
    output, the plain version's milliseconds, (fn, args, kw))."""
    import torch

    kern, plain, args, kw, rows = color_scan(eng, batch)
    got = kern(*args, **kw)
    want, plain_ms = timed_ms(lambda: plain(*args, **kw))
    require_color_equal(what, got, want, errs, key)
    if split:
        codes, st0 = args[3], args[4]
        cut = codes.shape[0] // 2 | 1
        st, ml1, c1 = kern(*args[:3], codes[:cut], st0, **kw)
        st, ml2, c2 = kern(*args[:3], codes[cut:], st, t0=rows * cut, **kw)
        require_color_equal(f"{what} split",
                            (st, torch.cat([ml1, ml2]), torch.cat([c1, c2])),
                            got, errs, key)
    return got, plain_ms, (kern, args, kw)


def check_color_oracle(what, reads, got, oracle):
    """got: [(name, (pmls, cell, colors))] against ColorEngine (built
    with report_colors)."""
    for (name, seq), (gname, res) in zip(reads, got):
        pmls, cell = oracle.query_pml_multiclass(seq)
        if gname != name or res != (pmls, cell, oracle.last_colors):
            raise AssertionError(f"{what}: read {name} differs from "
                                 f"ColorEngine")


def check_exact_reads(dev, exact_len):
    """Two reads copied from a two-document random text (100,000 bases
    each): their PML is about t+1 at step t, so csum reaches
    ~exact_len^2/2 and 5*csum passes 2^31 at the full length.  With early
    stop on, both scans keep a 64-bit csum and run to the reads' end, as
    the host rule says; the ml and color ids equal the scans without
    early stop."""
    from movi_tpu.io.fastx import make_batches
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.engine import fused_color as tfc
    from movi_tpu_torch.testing import colored_index, random_text

    docs = [random_text(100_000, 31), random_text(100_000, 32)]
    ix, ct = colored_index(docs, [1, 2])
    exact = [(f"e{i}", d[1000:1000 + exact_len].tobytes())
             for i, d in enumerate(docs)]
    batch = next(make_batches(exact, lanes=2, bucket_widths=False))
    index = Index(ix)
    floor = 0.9 * exact_len * (exact_len + 1) // 2
    for paired in (False, True):
        outs = {}
        for es in (False, True):
            eng = index.color_engine(ct, paired, dev, early_stop=es)
            kern, _, args, kw, _ = color_scan(eng, batch)
            outs[es] = kern(*args, **kw)
        (st, ml, cid), (_, ml0, cid0) = outs[True], outs[False]
        require_equal("exact reads ml", ml[:exact_len], ml0[:exact_len])
        require_equal("exact reads cid", cid[:exact_len], cid0[:exact_len])
        mls = ml.cpu().numpy()
        if (int(st[4].max()) != 0 or int(st[3].min()) < floor
                or any(tfc.early_stop_len(mls[:exact_len, j], exact_len)
                       != exact_len for j in range(2))):
            raise AssertionError(f"exact reads (paired={paired}): stop "
                                 f"{st[4].tolist()}, csum {st[3].tolist()}")
    csum = int(st[3].min())
    say("small color", f"two exact {exact_len}-base reads run to their end "
                       f"with early stop on, both layouts: csum {csum}, "
                       f"5*csum {5 * csum} (2^31 = {2**31})")


def phase_small_color(dev, errs, exact_len=EXACT_LEN):
    import torch

    from movi_tpu.color import ColorEngine
    from movi_tpu.io.fastx import make_batches
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.engine import fused_color as tfc
    from movi_tpu_torch.testing import early_stop_reads, small_color_index

    _, ix, ct, reads = small_color_index()
    reads = reads + early_stop_reads(reads, long_len=3000)
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    fi = tf.build_fused_index(ix).to(dev)
    ci = tfc.build_fused_color_index(ix, ct, fi).to(dev)
    ci_two = tfc.FusedColorIndex(fi=ci.fi, doc_set_inds=ci.doc_set_inds,
                                 num_colors=ci.num_colors, records3=None)
    slots = fi.sigma + 1

    cids = ci.doc_set_inds
    synth = torch.from_numpy(np.random.default_rng(8).integers(
        1 << 15, 0xFFFF, size=ix.r).astype(np.int32)).to(dev)
    for name, c in (("real", cids), ("ids past 2^15", synth)):
        table_k, b_k = kernels.compose_paired_color_records(
            fi.records, c, fi.r, slots, fi.p_dollar)
        table_p, b_p = tf2.compose_records_plain(fi.records, fi.r, slots,
                                                 fi.p_dollar, c)
        require_equal(f"small color compose ({name})", table_k, table_p,
                      errs, "compose_paired_color_records")
        if b_k != b_p:
            raise AssertionError(f"color compose B range {b_k} != {b_p}")
    ci2 = tf2.build_fused2_color_index(fi, ct)

    stopped = 0
    for es in (False, True):
        engs = {"3-word": tfc.FusedColorEngine(ci, ct, dev, early_stop=es),
                "two-load": tfc.FusedColorEngine(ci_two, ct, dev,
                                                 early_stop=es),
                "paired": tf2.Fused2ColorEngine(ci2, ct, dev, early_stop=es)}
        out = {}
        for layout, eng in engs.items():
            key = ("fused2_color_scan" if layout == "paired"
                   else "fused_color_scan")
            out[layout], _, _ = color_pair(
                eng, batch, f"small {layout} early_stop={es}", errs, key,
                split=True)
        require_color_equal(f"small two-load vs 3-word early_stop={es}",
                            out["two-load"], out["3-word"], errs,
                            "fused_color_scan")
        if es:
            stopped = int((out["3-word"][0][4] > 0).sum())
            if stopped == 0:
                raise AssertionError("no lane stopped early")
        oracle = ColorEngine(ix, ct, report_colors=True, early_stop=es)
        index = Index(ix)
        for paired in (False, True):
            check_color_oracle(
                f"small paired={paired} early_stop={es}", reads,
                index.query_multiclass(reads, ct, paired=paired, device=dev,
                                       early_stop=es), oracle)
        eng = engs["two-load"]
        got = [(n, r) for n, r in zip(batch.names, eng.query_batch(batch))]
        check_color_oracle(f"small two-load early_stop={es}", reads, got,
                           oracle)
    say("small color", f"r={ix.r}, C={ci.num_colors}: kernels A (3-word and "
                       f"two-load), B (real ids and ids past 2^15) and C "
                       f"equal plain, early stop off and on ({stopped} "
                       f"lanes stopped), split scans equal one pass; the "
                       f"one-step, two-load and paired engines equal "
                       f"ColorEngine on {len(reads)} reads")
    check_exact_reads(dev, exact_len)


def color_reads(genomes, lanes, long_reads):
    """The phase-7 reads: 150 bp from the genomes (1% substitutions,
    seed 42), 10 kb from the genomes (seed 43) and 10 kb random (seed
    44)."""
    from movi_tpu_torch.testing import ACGT, genome_reads

    short = genome_reads(genomes, lanes, READ_LEN, seed=42)
    longs = genome_reads(genomes, long_reads, LONG_LEN, seed=43)
    rand = np.random.default_rng(44).choice(ACGT,
                                            size=(long_reads, LONG_LEN))
    return ([(f"s{i}", s.tobytes()) for i, s in enumerate(short)]
            + [(f"g{i}", s.tobytes()) for i, s in enumerate(longs)]
            + [(f"x{i}", s.tobytes()) for i, s in enumerate(rand)])


def sample_picks(lanes, long_reads, n_short, n_long):
    """Read indices sampled for the oracle: n_short of the 150 bp reads
    and n_long of the 10 kb ones (at most as many as there are)."""
    rng = np.random.default_rng(7)
    return np.sort(np.concatenate([
        rng.choice(lanes, min(n_short, lanes), replace=False),
        lanes + rng.choice(2 * long_reads, min(n_long, 2 * long_reads),
                           replace=False)]))


def color_breakdown(index, ct, reads, paired, dev, k_ms, n_bases, card,
                    tag):
    """Where a warm query_multiclass's time goes: host batching, prepare
    + scan (codes to the card and the kernel), tally (results to the
    host, the per-read vote tally); the device's busy and idle shares."""
    import torch

    from movi_tpu_torch.api import _as_batches

    layout = "paired" if paired else "one-step"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.query_multiclass(reads, ct, paired=paired, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = index.color_engine(ct, paired, dev)
    t0 = time.perf_counter()
    bs = list(_as_batches(reads, QUERY_LANES))
    t_batch = time.perf_counter() - t0
    t_scan = t_tally = 0.0
    for b in bs:
        t0 = time.perf_counter()
        ml, color = eng.query_batch_device(b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        eng.host.results(ml, color, b)
        t_scan += t1 - t0
        t_tally += time.perf_counter() - t1
    busy = k_ms / 1e3 / wall
    say(tag, f"warm query_multiclass {layout}: wall {wall:.6f} s = "
             f"{n_bases / wall:.6e} bases/s; kernel {k_ms:.6f} ms, device "
             f"busy share (kernel / wall) {busy:.6f}, idle share "
             f"{1 - busy:.6f}; host stages: batching {t_batch:.6f} s, "
             f"prepare+scan {t_scan:.6f} s, tally {t_tally:.6f} s  ({card})")


def phase_color(dev, card, errs, timings, lanes=FULL_LANES,
                long_reads=LONG_READS, genomes=COLOR_GENOMES,
                genome_len=COLOR_GENOME_LEN):
    import torch

    from movi_tpu.color import ColorEngine
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.testing import colored_index, pangenome

    t0 = time.perf_counter()
    gen = pangenome(genomes, genome_len)
    ix, ct = colored_index(gen, [1000 + g for g in range(genomes)])
    t_build = time.perf_counter() - t0
    r, slots = ix.r, ix.sigma + 1
    C = len(ct.unique_doc_sets)
    say("color", f"{genomes} genomes x {genome_len} bases, r={r}, C={C} "
                 f"doc sets (widest {max(len(x) for x in ct.unique_doc_sets)}"
                 f"); one-step color table {12 * slots * r} B, paired color "
                 f"table {32 * slots**2 * r} B; host build (SA, index, "
                 f"colors) {t_build:.3f} s")
    reads = color_reads(gen, lanes, long_reads)
    n_bases = sum(len(s) for _, s in reads)
    index = Index(ix)
    torch.cuda.reset_peak_memory_stats(dev)

    # the color path, counted: nothing else launches between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    res, walls = {}, {}
    for paired in (False, True):
        for es in (False, True):
            t0 = time.perf_counter()
            res[paired, es] = index.query_multiclass(
                reads, ct, paired=paired, device=dev, early_stop=es)
            torch.cuda.synchronize()
            walls[paired, es] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in COLOR_KERNELS}
    say("color", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"color path")
    for es in (False, True):
        if res[False, es] != res[True, es]:
            raise AssertionError(f"color early_stop={es}: one-step and "
                                 f"paired layouts disagree")
    cells = index.multi_classify(reads, ct, paired=False, device=dev)
    if cells != [(n, c) for n, (_, c, _) in res[False, False]]:
        raise AssertionError("multi_classify cells differ from "
                             "query_multiclass")
    n_stop = sum(len(p) < len(s) for (_, s), (_, (p, _, _))
                 in zip(reads, res[False, True]))
    calls = {}
    for _, c, _ in (x for _, x in res[False, False]):
        calls[c] = calls.get(c, 0) + 1
    say("color", "end to end (host clock, " + str(n_bases) + " bases): "
        + "; ".join(f"{'paired' if p else 'one-step'} early_stop={es} "
                    f"{w:.3f} s = {n_bases / w:.6e} bases/s"
                    for (p, es), w in walls.items())
        + f"; {n_stop} reads stopped early; the most frequent calls "
        + str(sorted(calls.items(), key=lambda kv: -kv[1])[:4])
        + f"  ({card})")

    pick = sample_picks(lanes, long_reads, ORACLE_SAMPLE - 6, 6)
    for es in (False, True):
        oracle = ColorEngine(ix, ct, report_colors=True, early_stop=es)
        check_color_oracle(f"color sample early_stop={es}",
                           [reads[i] for i in pick],
                           [res[False, es][i] for i in pick], oracle)
    say("color", f"{len(pick)} sampled reads equal ColorEngine (pmls, "
                 f"cells, colors; early stop off and on)")

    # every kernel against its plain version over all lanes of the main
    # path's batches, and the compose over the whole table
    fi = index._fused
    ci2 = index._paired_color[1]
    cids = torch.from_numpy(np.minimum(ct.doc_set_inds, C)
                            .astype(np.int32)).to(dev)
    comp = (fi.records, cids, r, slots, fi.p_dollar)
    (table_p, _), compose_plain_ms = timed_ms(
        lambda: tf2.compose_records_plain(fi.records, r, slots, fi.p_dollar,
                                          cids))
    require_equal("full color compose table", ci2.f2.records, table_p, errs,
                  "compose_paired_color_records")
    del table_p
    batches = list(_as_batches(reads, QUERY_LANES))
    runs, plain_ms = {}, {}
    for paired in (False, True):
        for es in (False, True):
            eng = index.color_engine(ct, paired, dev, early_stop=es)
            key = "fused2_color_scan" if paired else "fused_color_scan"
            runs[key, es], plain_ms[key, es] = [], 0.0
            for b in batches:
                _, ms, run = color_pair(eng, b, f"full {key} early_stop={es}",
                                        errs, key)
                runs[key, es].append(run)
                plain_ms[key, es] += ms
    say("color", "kernels A-C equal their plain versions over all lanes "
                 "and the whole table")

    shapes = [tuple(b.seqs.shape) for b in batches]
    for (key, es), rs in runs.items():
        k_ms = cuda_ms(lambda: [f(*a, **kw) for f, a, kw in rs], reps=5)
        per = [cuda_ms(lambda: f(*a, **kw), reps=5) for f, a, kw in rs]
        if not es:
            timings[key] = (k_ms, plain_ms[key, es])
        timings[key, es] = k_ms
        per_s = ", ".join(f"{lb} lanes x {wb}: {ms:.6f} ms"
                          for (lb, wb), ms in zip(shapes, per))
        say("color", f"{key} early_stop={es} over the main path's "
                     f"{len(batches)} batches ({n_bases} bases): kernel "
                     f"{k_ms:.6f} ms = {n_bases / k_ms * 1e3:.6e} bases/s, "
                     f"plain {plain_ms[key, es]:.6f} ms = "
                     f"{n_bases / plain_ms[key, es] * 1e3:.6e} bases/s; "
                     f"kernel per batch [{per_s}]  ({card})")
    k_ms = cuda_ms(lambda: kernels.compose_paired_color_records(*comp),
                   reps=3)
    timings["compose_paired_color_records"] = (k_ms, compose_plain_ms)
    say("color", f"color compose r={r}: kernel {k_ms / 1e3:.6f} s, plain "
                 f"{compose_plain_ms / 1e3:.6f} s  ({card})")

    for paired in (False, True):
        key = "fused2_color_scan" if paired else "fused_color_scan"
        color_breakdown(index, ct, reads, paired, dev, timings[key][0],
                        n_bases, card, "color")
    for (paired, es), w in walls.items():
        if es:
            key = "fused2_color_scan" if paired else "fused_color_scan"
            busy = timings[key, True] / 1e3 / w
            say("color", f"warm query_multiclass "
                         f"{'paired' if paired else 'one-step'} early_stop"
                         f"=True: wall {w:.6f} s = {n_bases / w:.6e} "
                         f"bases/s; kernel {timings[key, True]:.6f} ms, "
                         f"device busy share {busy:.6f}, idle share "
                         f"{1 - busy:.6f}  ({card})")
    say("color", f"peak device memory in this phase "
                 f"{torch.cuda.max_memory_allocated(dev)} B  ({card})")
    return counts


def phase_color_two_load(dev, card, errs, timings, lanes=FULL_LANES,
                         long_reads=LONG_READS, genomes=WIDE_GENOMES,
                         genome_len=WIDE_GENOME_LEN):
    """A pangenome whose compressed color table keeps 2^16 sets: no
    3-word records, no paired color records; kernel A's two-load form."""
    import torch

    from movi_tpu.color import ColorEngine, compress_color_table
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.testing import colored_index, pangenome

    t0 = time.perf_counter()
    gen = pangenome(genomes, genome_len)
    ix, full = colored_index(gen, [1000 + g for g in range(genomes)])
    ct = compress_color_table(full)  # the top 2^16 sets
    t_build = time.perf_counter() - t0
    C = len(ct.unique_doc_sets)
    say("two-load", f"{genomes} genomes x {genome_len} bases, r={ix.r}, "
                    f"{len(full.unique_doc_sets)} doc sets compressed to "
                    f"C={C}; host build {t_build:.3f} s")
    reads = color_reads(gen, lanes, long_reads)
    n_bases = sum(len(s) for _, s in reads)
    index = Index(ix)
    torch.cuda.synchronize()
    kernels.reset_launches()
    res = {es: index.query_multiclass(reads, ct, device=dev, early_stop=es)
           for es in (False, True)}
    torch.cuda.synchronize()
    counts = {k: kernels.launches[k] for k in COLOR_KERNELS}
    eng = index.color_engine(ct, paired=True, device=dev)
    if (counts["fused_color_scan"] <= 0 or counts["fused2_color_scan"]
            or counts["compose_paired_color_records"]
            or eng.ci.records3 is not None):
        raise AssertionError(f"the two-load form did not run alone: "
                             f"{counts}, records3 "
                             f"{eng.ci.records3 is not None}")
    pick = sample_picks(lanes, long_reads, 60, 4)
    for es in (False, True):
        oracle = ColorEngine(ix, ct, report_colors=True, early_stop=es)
        check_color_oracle(f"two-load sample early_stop={es}",
                           [reads[i] for i in pick],
                           [res[es][i] for i in pick], oracle)
    batches = list(_as_batches(reads, QUERY_LANES))
    for es in (False, True):
        eng = index.color_engine(ct, device=dev, early_stop=es)
        rs, p_ms = [], 0.0
        for b in batches:
            _, ms, run = color_pair(eng, b, f"two-load early_stop={es}",
                                    errs, "fused_color_scan")
            rs.append(run)
            p_ms += ms
        k_ms = cuda_ms(lambda: [f(*a, **kw) for f, a, kw in rs], reps=5)
        timings["two-load", es] = (k_ms, p_ms)
        say("two-load", f"fused_color_scan (two-load form) early_stop={es} "
                        f"over {len(batches)} batches ({n_bases} bases): "
                        f"kernel {k_ms:.6f} ms = "
                        f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                        f"{p_ms:.6f} ms  ({card})")
    say("two-load", f"launches {counts}; {len(pick)} sampled reads equal "
                    f"ColorEngine; the kernel equals its plain version over "
                    f"all lanes")
    color_breakdown(index, ct, reads, False, dev,
                    timings["two-load", False][0], n_bases, card, "two-load")


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
                        "--fasta", fasta, "--index", idx, "--color"],
                       cwd=ROOT, check=True, capture_output=True,
                       timeout=600)
        reads = mixed_reads(refs[0], seed=5, count=30)
        rng = np.random.default_rng(4)
        for i in range(30):
            src = refs[1] if i % 2 else random_text(1000, 100 + i)
            s = int(rng.integers(0, len(src) - 600))
            reads.append((f"long{i}", src[s:s + 600].tobytes()))
        rpath = os.path.join(d, "reads.fa")
        with open(rpath, "w") as f:
            f.writelines(f">{n}\n{s.decode()}\n" for n, s in reads)
        mode = "regular-thresholds"
        # (query flags, the outputs compared: files, or stdout if none)
        runs = [(["--pml", "--classify"], [f"{rpath}.{mode}.pml.report"]),
                (["--zml", "--classify"], [f"{rpath}.{mode}.zml.report"]),
                (["--count"], ["{out}.count.matches"]),
                (["--zml", "--stdout"], []),
                (["--pml", "--multi-classify", "--report-colors"],
                 ["{out}", f"{rpath}.{mode}.colors"]),
                (["--pml", "--multi-classify", "--early-stop", "--report-all",
                  "--no-paired-records", "--stdout"], [])]
        n_found = {}
        for flags, outputs in runs:
            texts = {}
            for plat in (platform, "cpu"):
                out = os.path.join(d, plat)
                res = subprocess.run(
                    [sys.executable, "-m", "movi_tpu_torch.cli", "query",
                     "--index", idx, "--read", rpath, *flags, "--platform",
                     plat, "--out-file", out], cwd=ROOT, check=True,
                    capture_output=True, text=True, timeout=600)
                texts[plat] = "" if outputs else res.stdout
                for output in outputs:
                    path = output.format(out=out)
                    with open(path) as f:
                        texts[plat] += f.read()
                    os.unlink(path)
            what = " ".join(flags)
            if texts[platform] != texts["cpu"] or not texts["cpu"]:
                raise AssertionError(f"CLI query {what}: output differs "
                                     f"between --platform {platform} and "
                                     f"cpu, or is empty")
            if "--classify" in flags:
                n_found[what] = sum(ln.split()[1] == "FOUND"
                                    for ln in texts["cpu"].splitlines()[1:]
                                    if len(ln.split()) > 1)
    say("cli", f"query --pml --classify, --zml --classify, --count, --zml "
               f"--stdout, --pml --multi-classify --report-colors and "
               f"--multi-classify --early-stop --report-all --stdout on "
               f"--platform {platform} ({len(reads)} reads; found "
               f"{n_found}) equal --platform cpu")


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
    n_src = len({src for src, _ in CUDA_SOURCES.values()})
    say("build", f"nvcc sm_90a build of {n_src} kernel sources "
                 f"({len(CUDA_SOURCES)} launch counters): "
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
    phase_small_search(dev, errs)
    counts, ctx = phase_full(dev, card, errs, timings)
    counts.update(phase_search(dev, card, errs, timings, ctx))
    del ctx
    phase_small_color(dev, errs)
    counts.update(phase_color(dev, card, errs, timings))
    phase_color_two_load(dev, card, errs, timings)
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
