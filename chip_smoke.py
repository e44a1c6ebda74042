#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (movi_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from movi_tpu_torch/csrc (sixteen sources,
twenty-seven launch counters), checks each one against its plain PyTorch
version on the card, drives the PML, count, ZML, SA-entries, k-mer, MEM
and Movi Color paths (`Index.query_pml`, `query_count`, `query_zml`,
`FusedSAEngine.query`, `query_kmers`, `query_mems` (on the MEM v2
table and, past MEM2_MAX_N, on the v1 machines) and
`query_multiclass`/`multi_classify`, both record layouts each; the
compact engines of `Index.compact_engine`; and `movi_tpu_torch.cli build`
and `query`) at a real index size,
checks the answers against the scalar oracles, and prints timings with
the card's name and power limit.  Phases:

  1. device   the card, and its nvidia-smi name and power limit
  2. build    nvcc of the kernels; `make -C native` for the host SA-IS
  3. small    5,000-base index: each kernel equals its plain version on
              the card (ml or count, carried state, a scan split in two
              equal to one pass, the compose tables); every layout of PML,
              count and ZML equals ScalarEngine; kernel 3 on synthetic
              records whose run ids pass 2^24 (w0's sign bit)
     small compact  the 5,000-base text of phase 3 indexed with regular
              thresholds without NT splitting, as `regular`, and the
              separators index of tests/test_separators.py: kernels 12a
              (threshold and --rpml rules), 12b and 12c equal their plain
              versions (ml, counts, state, a scan split in two), the
              compact engines equal ScalarEngine on reads with N's and of
              lengths 1-2049; a reposition that finds no run raises from
              the kernel; the dependent-load latency with the tables in
              the cache (for the latency floors)
     small SA the 5,000-base index of tests/test_fused_sa.py with its
              sampled SA at rates 100, 37 and 1,000 (long walks), reads
              with N's and of lengths 1-4097: kernels 8a and 8b equal
              their plain versions (ml, pre-LF run and offset, carried
              state, a scan split in two equal to one pass, the SA values
              over every element, padding included); FusedSAEngine
              equals ScalarEngine.query_pml(collect_sa=True)
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
     compact  phase 4's text indexed without NT splitting (regular
              thresholds, and regular) and the same reads through the
              compact engines of Index.compact_engine (PML by threshold
              and by --rpml's rule, count, ZML; --rpml PML on the regular
              index), counted apart: threshold PML, count and ZML equal
              phases 4-5's answers over all reads, 256 sampled reads equal
              ScalarEngine, kernels 12a-12c equal their plain versions over
              the 150 bp batches and 8 long lanes cut to 1,500 bases, table
              bytes, timings, latency floors and warm breakdowns
     SA       the same index with its sampled SA at rate 100 and the same
              reads through FusedSAEngine.query, counted apart: kernels
              8a and 8b equal their plain versions over all lanes, 256
              sampled reads equal ScalarEngine(collect_sa=True), the
              walk's mean and longest steps per element, timings and a
              warm breakdown (batching, prepare, pre-scan, walk, D2H,
              tolist)
     small k-mer  the 2,500-base rc index (seed 9) and the forward-only
              index (seed 31) of tests/test_fused_kmer.py, probe-heavy
              reads with N's, shorter than k and past 512 bases: kernel 10a
              (fk 0, 4, 6) and 9a (fk 0, 4, 6; a run split in two equal to
              one pass) equal their plain versions, 9b and 7b too (k = 8,
              15, 31); the three k-mer engines equal AdvancedEngine
     k-mer    phase 4's index with ftab-10 anchor rows: 16,384 x 150 bp
              reads of bench.py's contamination-screening mix (half from
              the text with 1% substitutions, half random; seed 77) and
              phase 4's 64 x 10 kb reads through Index.query_kmers (k = 31)
              membership, then exact counts paired=False and paired=True,
              counted apart: the count layouts agree, membership's found
              k-mers equal the counts', 256 sampled reads equal
              AdvancedEngine, kernels 9a, 9b, 7b and 10a equal their plain
              versions over all lanes, timings, the longest lane's ticks
              and steps, and a warm breakdown of each query
     small MEM  the rc index of tests/test_fused_mem2.py (4,000 bases,
              seed 7), reads with N, '#', shorter than L and past 512
              bases: kernel 10b (fk 0, 6, 8; L 2, 8, 12) and 10c equal
              their plain versions (every register, the ends and counts,
              each lane's ticks and rows, a run split in two equal to one
              pass), on the first-run-longer-than-one index and on
              junction-spanning reads of a multi-document index too;
              kernels 11a and 11b (k 5, 11, 31; p 1 too) on the index of
              tests/test_fused_kmer2.py; the MEM and bidirectional count
              engines equal AdvancedEngine
     small MEM v1  the same index, reads with N, '#', shorter than L and
              past 512 bases, and the first-run-longer-than-one index
              (tests/test_torch_mem1.py): kernel 13a equals its plain
              version and np.repeat; 13b (L 2, 12) and 13c equal theirs
              (every register, ends, counts, ticks and bytes) with
              pos2rba and with the binary search over all_p; the v1
              engines equal AdvancedEngine; a lane past its tick budget
              raises
     MEM      bench.py's reverse-complement closed index (3,000,000
              bases from default_rng(1) and their reverse complement,
              built by the port): the MEM v2 table with ftab-10 rows,
              16,384 x 150 bp reads (1% substitutions, seed 78) and 64 x
              10 kb (seed 43) through Index.query_mems at L = 20 and L =
              0, then 16,384 screening reads (seed 77) and the 10 kb
              reads through query_kmers(counts=True) at k = 31, paired
              (the bidirectional engine) and one-step, counted apart:
              the count engines agree, 32 sampled reads equal
              AdvancedEngine (its run walks in numpy, held to the plain
              oracle in the small phase), kernels 10b/10c equal their
              plain versions
              over the 150 bp batches and 8 long lanes cut to 1,500
              bases, 11a/11b over every group, timings, bounds from the
              rows really loaded, latency floors and warm breakdowns
     MEM v1   phase MEM's index and reads through Index.query_mems (BML
              at L = 20, all-MEMs) with MEM2_MAX_N lowered below the
              index's length in this process (the route an index past
              2^28 positions takes), first with pos2rba (kernel 13a
              builds it) and then with POS2RUN_MAX_N at 0 (the binary
              search over all_p that the route past 2^28 always takes),
              counted apart: both equal phase MEM's v2 answers on every
              read, 256 sampled reads equal AdvancedEngine (numpy run
              walks), kernels 13a-13c equal their plain versions in both
              forms (13b/13c over the 150 bp batches and 8 long lanes cut
              to 1,500 bases), timings per form, bounds from the bytes
              really loaded, latency floors and warm breakdowns; then
              `query --mem` (L = 20 and all-MEMs) through the CLI in this
              process, counted apart again: it logs the v1 engine,
              launches only 13b or 13c, and its .mems file equals the v2
              answers' lines
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
  8. cli     the port's CLI (run in this process) on the card against an
              index that its own `build --color --sa-entries` made: the
              PML and ZML --classify reports, the count .matches file, ZML
              --stdout, --pml --rpml --stdout, the PML --classify report
              and the count file on a `build --type regular` index (the
              compact engines), --count --no-jax,
              --multi-classify (the CSV and .colors file, and
              --early-stop --report-all on stdout), --pml --sa-entries
              (both .bpf files), --kmer and --kmer-count
              --no-paired-records (the .kmers.15 file), --kmer-count
              --paired-records on a `build --fw` index (kernel 7b) and on
              a one-document index (reverse-complement closed: kernels
              11a and 11b), --mem --min-mem-length 12 and --mem (the .mems
              file), and --mem --min-mem-length 12 --ftab-k 6 --stdout
              equal --platform cpu byte for byte

Any failed check raises and the script exits nonzero.  The line before
the last is the kernels' JSON record: for each launch counter its
launches on its path, its largest difference from its plain version, its
time and the plain version's over the path's batches, and its bound (the
larger of the bytes it must move over the card's memory rate and its
integer operations over the card's scalar rate, from this run's inputs).
The last line is {"ok": true, "device": {...}}.  Without a card it exits
nonzero and prints no result.  It imports nothing of JAX and nothing of
the JAX package.
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
    "fused_sa_pre_scan": ("movi_tpu_torch/csrc/fused_sa.cu",
                          "movi_tpu/engine/fused_sa.py:83"),
    "sa_walk": ("movi_tpu_torch/csrc/fused_sa.cu",
                "movi_tpu/engine/fused_sa.py:119"),
    "kmer_member_scan": ("movi_tpu_torch/csrc/fused_kmer.cu",
                         "movi_tpu/engine/fused_kmer.py:52"),
    "kmer_count_scan": ("movi_tpu_torch/csrc/fused_kmer.cu",
                        "movi_tpu/engine/fused_kmer.py:245"),
    "fused2_kmer_count_scan": ("movi_tpu_torch/csrc/fused2_kmer_count.cu",
                               "movi_tpu/engine/fused_search2.py:478"),
    "prep_alc": ("movi_tpu_torch/csrc/fused_kmer.cu",
                 "movi_tpu/engine/fused_mem2.py:343"),
    "mem2_scan": ("movi_tpu_torch/csrc/fused_mem2.cu",
                  "movi_tpu/engine/fused_mem2.py:377"),
    "all_mem2_scan": ("movi_tpu_torch/csrc/fused_mem2.cu",
                      "movi_tpu/engine/fused_mem2.py:700"),
    "kmer2_right_scan": ("movi_tpu_torch/csrc/fused_kmer2.cu",
                         "movi_tpu/engine/fused_kmer2.py:55"),
    "kmer2_left_scan": ("movi_tpu_torch/csrc/fused_kmer2.cu",
                        "movi_tpu/engine/fused_kmer2.py:86"),
    "compact_pml_scan": ("movi_tpu_torch/csrc/compact_pml.cu",
                         "movi_tpu/engine/pml.py:107"),
    "compact_count_scan": ("movi_tpu_torch/csrc/compact_search.cu",
                           "movi_tpu/engine/search.py:84"),
    "compact_zml_scan": ("movi_tpu_torch/csrc/compact_search.cu",
                         "movi_tpu/engine/search.py:161"),
    "pos2rba_build": ("movi_tpu_torch/csrc/fused_mem.cu",
                      "movi_tpu/engine/fused_mem.py:73"),
    "mem1_scan": ("movi_tpu_torch/csrc/fused_mem.cu",
                  "movi_tpu/engine/fused_mem.py:146"),
    "all_mem1_scan": ("movi_tpu_torch/csrc/fused_mem.cu",
                      "movi_tpu/engine/fused_mem.py:337"),
}
PML_KERNELS = ("fused_pml_scan", "compose_paired_records", "fused2_pml_scan")
SA_KERNELS = ("fused_sa_pre_scan", "sa_walk")
SA_RATE = 100             # build --sa-sample-rate's default
SMALL_SA_RATES = (100, 37, 1000)
# the bound: NVIDIA's published H100 SXM peaks (HBM3, and float32 outside
# the tensor cores, the table's rate for scalar work), and an upper
# estimate of the integer operations of one record step or composed record
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
OPS_PER_ROW = 32
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
KMER_KERNELS = ("kmer_member_scan", "kmer_count_scan",
                "fused2_kmer_count_scan", "prep_alc")
KMER_K = 31               # query --k's default
KMER_LANES = 16384        # the screening reads of the k-mer phase
KMER_SEED = 77
MEM_KERNELS = ("mem2_scan", "all_mem2_scan", "kmer2_right_scan",
               "kmer2_left_scan")
MEM1_KERNELS = ("pos2rba_build", "mem1_scan", "all_mem1_scan")
MEM_RC_HALF = 3_000_000   # bench.py HBM_RC_HALF: half of the rc text
MEM_L = 20                # bench.py MEM_L
MEM_LANES = 16384         # bench.py MEM_LANES
MEM_SEED = 78             # bench.py's MEM reads
LONG_CUT = 1500           # long lanes held to the plain machines, cut
TICK_US = 0.9             # a dependent step's latency (PERF.md §2)
COMPACT_KERNELS = ("compact_pml_scan", "compact_count_scan",
                   "compact_zml_scan")
COMPACT_KINDS = {"pml": "compact_pml_scan", "rpml": "compact_pml_scan",
                 "count": "compact_count_scan", "zml": "compact_zml_scan"}


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


def add_work(work, key, nbytes, nops):
    """Add a launch's bytes moved and integer operations to work[key]."""
    b, o = work.get(key, (0, 0))
    work[key] = (b + int(nbytes), o + int(nops))


def scan_work(codes, row_bytes, out_bytes, state_bytes):
    """(bytes, ops) of a scan that gathers row_bytes per code of codes
    [steps, lanes] and writes out_bytes per code, with state_bytes per
    lane in and out."""
    n = codes.numel()
    return (n * (row_bytes + codes.element_size() + out_bytes)
            + 2 * state_bytes * codes.shape[1], n * OPS_PER_ROW)


def bound(nbytes, nops):
    """The least milliseconds the card could take: the larger of bytes
    over the memory rate and operations over the scalar rate, and which
    of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / SCALAR_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.io.fastx import make_batches
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
    pass.  Returns the plain version's milliseconds and the kernel's
    (state, out)."""
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
    return plain_ms, got


def count_steps(kind, state):
    """The steps of each lane of a count scan ending in state [6, lanes]:
    it loads rows only until its lane is done, so they come from the final
    (matched x, done y): x-1+y steps one-step ("count"), (x-1)//2+y pair
    steps paired ("count2"), none where the first char is illegal."""
    import torch

    x = state[4].to(torch.int64)
    y = state[5].to(torch.int64)
    return torch.where(x > 0, (x - 1) // 2 + y if "2" in kind else x - 1 + y,
                       0)


def search_work(kind, codes, state):
    """(bytes, ops) of one search scan over codes [steps, lanes] ending in
    state [6, lanes]: ZML gathers two rows a step (16 B one-step, 24 B
    paired) and writes every ml; count loads rows only for its steps
    (count_steps)."""
    paired = "2" in kind
    row = 2 * (24 if paired else 16)
    if kind.startswith("zml"):
        return scan_work(codes, row, 4 * (2 if paired else 1), 24)
    n = int(count_steps(kind, state).sum())
    lanes = codes.shape[1]
    # each step's rows and char; per lane the first char, the state out,
    # the count and its two run starts
    return n * (row + 1) + lanes * (1 + 24 + 4 + 8), n * OPS_PER_ROW


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
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.io.fastx import make_batches
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


def halvings(r):
    """The all_p loads of one fast-forward search over r runs:
    ceil(log2(r + 1)) halvings (csrc/compact.cuh)."""
    steps, n = 0, r + 1
    while n > 1:
        n -= n >> 1
        steps += 1
    return steps


def compact_run(kind, di, codes, state=None):
    """(kernel, args) of one compact scan: kind "pml"/"rpml" (state: the
    PML state), "count" or "zml" (state: None or the [6, lanes] one)."""
    from movi_tpu_torch import kernels

    if kind in ("pml", "rpml"):
        return kernels.compact_pml_scan, (
            di.n, di.lf_abs, di.all_p, di.c, di.thr_full, di.rep_up,
            di.rep_down, di.r, di.sigma, codes, state, kind == "rpml")
    fn = (kernels.compact_count_scan if kind == "count"
          else kernels.compact_zml_scan)
    return fn, (di.n, di.lf_abs, di.all_p, di.c_search, di.ch_up_s,
                di.ch_down_s, di.first_runs, di.first_offsets, di.last_runs,
                di.last_offsets, di.r, di.sigma, codes, state)


def compact_pair(kind, di, codes, state, what, errs, split=None):
    """A compact kernel against its plain version on the same inputs
    (every output and the state); with `split`, the kernel also runs in
    two pieces carried through its state, which must equal one pass.
    Returns (the kernel's (state, out), the plain version's ms, (kernel,
    args))."""
    import torch

    from movi_tpu_torch.engine import pml as tpml
    from movi_tpu_torch.engine import search as tsearch

    key = COMPACT_KINDS[kind]
    fn, args = compact_run(kind, di, codes, state)
    got = fn(*args)
    if kind in ("pml", "rpml"):
        want, plain_ms = timed_ms(lambda: tpml.compact_pml_scan_plain(
            di, codes, state, kind == "rpml"))
        require_equal(f"{what} ml", got[1], want[1], errs, key)
        require_state_equal(what, got[0], want[0], errs, key)
    else:
        plain = (tsearch.compact_count_scan_plain if kind == "count"
                 else tsearch.compact_zml_scan_plain)
        want, plain_ms = timed_ms(lambda: plain(di, codes, state))
        require_search_equal(what, got, want, errs, key)
    if split is not None:
        fn1, a1 = compact_run(kind, di, codes[:split], state)
        st, out1 = fn1(*a1)
        fn2, a2 = compact_run(kind, di, codes[split:], st)
        st, out2 = fn2(*a2)
        if kind != "count":
            require_equal(f"{what} split out", torch.cat([out1, out2]),
                          got[1], errs, key)
        else:
            require_equal(f"{what} split count", out2, got[1], errs, key)
        if kind in ("pml", "rpml"):
            require_state_equal(f"{what} split", st, got[0], errs, key)
        else:
            require_equal(f"{what} split state", st, got[0], errs, key)
    return got, plain_ms, (fn, args)


def compact_codes(kind, eng, batch):
    """The codes and start state a compact engine gives a batch."""
    from movi_tpu_torch.engine import pml as tpml

    codes = eng.prepare(batch)
    if kind in ("pml", "rpml"):
        return codes, tpml.initial_state(eng.di, codes.shape[1],
                                         codes.device)
    return codes, None


def compact_steps(kind, codes, out):
    """Per lane, the steps that loaded rows: every step for PML; for ZML
    every step after the first (its interval comes from the first/last run
    tables); for count, the chars matched before its lane was done (state
    rows 4-5, as count_steps), none past the read."""
    import torch

    if kind == "count":
        return count_steps("count", out[0])
    return torch.full((codes.shape[1],),
                      codes.shape[0] - (kind == "zml"), dtype=torch.int64,
                      device=codes.device)


def compact_tally(kind, di, codes, state):
    """The loads of one compact scan that depend on the data, counted by
    its plain version on the same inputs: PML, the mismatches that
    repositioned upward and those that tried the other direction; count
    and ZML, the steps whose start and whose end moved to a nearest run."""
    import torch

    from movi_tpu_torch.engine import pml as tpml
    from movi_tpu_torch.engine import search as tsearch

    tally = torch.zeros(2, dtype=torch.int64, device=codes.device)
    if kind in ("pml", "rpml"):
        tpml.compact_pml_scan_plain(di, codes, state, kind == "rpml", tally)
    elif kind == "count":
        tsearch.compact_count_scan_plain(di, codes, state, tally)
    else:
        tsearch.compact_zml_scan_plain(di, codes, state, tally)
    return [int(v) for v in tally]


def compact_work(kind, di, codes, got, tally):
    """(bytes, ops) of one compact scan from the rows it loads.  PML: per
    step its char, lf_abs and the S all_p rows of the fast-forward, the
    row's char where the char is legal and ml; per mismatch the threshold
    (or the length, --rpml) and the reposition row; the destination's
    length where it went up and the other reposition row where it tried
    the other direction (tally); the state in and out.  Count/ZML: per step
    (two ends) the char rows of c_search, lf_abs and S all_p rows each; the
    nearest-run row where an end moved, and the end's length (tally); the
    chars read, the first/last run tables once, the outputs and the state
    out (a scan from the first char reads none in); count also reads the
    two all_p rows of its last interval."""
    import torch

    S = halvings(di.r) + 1
    lanes = codes.shape[1]
    n = int(compact_steps(kind, codes, got).sum())
    if kind in ("pml", "rpml"):
        up, other = tally
        ml = got[1]
        legal = int((codes >= 0).sum())
        mism = int(((ml == 0) & (codes >= 0)).sum())
        nbytes = (n * (1 + 4 + 4 * S + 4) + legal + mism * 8
                  + (up + other) * 4 + 2 * 12 * lanes)
        return nbytes, n * (OPS_PER_ROW + 2 * S)
    moves_s, moves_e = tally
    nbytes = (n * 2 * (4 + 4 + 4 * S) + moves_s * 4 + moves_e * 8
              + (di.sigma + 1) * 16 + 24 * lanes)
    if kind == "zml":
        nbytes += codes.numel() * (1 + 4)
    else:
        x, y = got[0][4].to(torch.int64), got[0][5]
        chars = int(torch.where(y == 1, x + 1, codes.shape[0]).sum())
        nbytes += chars + lanes * (4 + 8)
    return nbytes, n * 2 * (OPS_PER_ROW + 2 * S)


def check_compact_oracle(what, reads, res, oracle, rr_pml=None):
    """res: {kind: [(name, answer)]} against ScalarEngine."""
    for kind, got in res.items():
        for (name, seq), (gname, ans) in zip(reads, got):
            if kind in ("pml", "rpml"):
                want = oracle.query_pml(seq,
                                        random_repositioning=kind == "rpml")
            elif kind == "count":
                want = oracle.query_count(seq)
            else:
                want = oracle.query_zml(seq)
            if gname != name or ans != want:
                raise AssertionError(f"{what}: {kind} of read {name} "
                                     f"differs from ScalarEngine")


def phase_small_compact(dev, errs):
    """The compact kernels against their plain versions, the engines
    against ScalarEngine, on an unsplit thresholds index, a regular index
    and a separators index; the not-found reposition raises from the
    kernel; and the latency of a dependent load whose tables sit in the
    cache (one long lane repeated), for the latency floors."""
    import dataclasses

    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.build.suffix import build_bwt_runs
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.index.structure import build_move_index
    from movi_tpu_torch.io.fastx import make_batches
    from movi_tpu_torch.testing import (length_reads, mixed_reads,
                                        random_text, separator_text)

    text = random_text(5000, 47)
    runs = build_bwt_runs(text)
    sep_text, doc = separator_text()
    cases = {"thr-unbounded": (build_move_index(runs, "regular-thresholds"),
                               text),
             "regular": (build_move_index(runs, "regular"), text),
             "separators": (build_move_index(
                 build_bwt_runs(sep_text), "regular-thresholds",
                 separators=True, bound_ff=1), doc)}
    for name, (ix, src) in cases.items():
        reads = mixed_reads(src) + length_reads(
            src, lengths=(1, 2, 3, 2047, 2049))
        if ix.separators:
            reads.append(("sep", src[:30].tobytes() + b"%"
                          + src[40:70].tobytes()))
        batch = next(make_batches(reads, lanes=len(reads),
                                  bucket_widths=False))
        index = Index(ix)
        oracle = ScalarEngine(ix)
        kinds = (["pml", "rpml"] if ix.thr is not None else ["rpml"]) + \
            ["count", "zml"]
        res = {}
        for kind in kinds:
            base = "pml" if kind == "rpml" else kind
            eng = index.compact_engine(base, kind == "rpml", dev)
            codes, st = compact_codes(kind, eng, batch)
            compact_pair(kind, eng.di, codes, st, f"small {name} {kind}",
                         errs, split=codes.shape[0] // 2 | 1)
            res[kind] = index._run(eng, reads, QUERY_LANES)
        check_compact_oracle(f"small {name}", reads, res, oracle)
        rules = ", ".join(k for k in kinds if "pml" in k)
        say("small compact", f"{name} r={ix.r}: kernels 12a ({rules}), "
                             f"12b, 12c equal plain (ml, counts, state, a "
                             f"scan split in two) on {len(reads)} reads; "
                             f"the engines equal ScalarEngine")

    # a reposition that finds no run in either direction raises the
    # oracle's message from the kernel
    ix, _ = cases["thr-unbounded"]
    di = Index(ix).compact_engine("pml", device=dev).di
    none = torch.full_like(di.rep_up, di.r)
    broken = dataclasses.replace(di, rep_up=none, rep_down=none)
    batch = next(make_batches([("r", random_text(60, 3).tobytes())], 1))
    for kind in ("pml", "rpml"):
        codes, st = compact_codes(kind, Index(ix).compact_engine(
            "pml", kind == "rpml", dev), batch)
        fn, args = compact_run(kind, broken, codes, st)
        try:
            fn(*args)
        except AssertionError as e:
            if str(e) != kernels.NOT_FOUND:
                raise
        else:
            raise AssertionError(f"{kind}: no error where no run is found")
    say("small compact", f"a reposition finding no run raises "
                         f"{kernels.NOT_FOUND!r} from kernel 12a (both "
                         f"rules)")

    # the dependent-load latency with the tables in the cache: one 2,049-
    # base read repeated over 128 lanes walks one chain per warp
    read = length_reads(text, lengths=(2049,))
    eng = Index(ix).compact_engine("pml", device=dev)
    codes, st = compact_codes("pml", eng, next(make_batches(
        read, 1, bucket_widths=False)))
    codes = codes.repeat(1, 128).contiguous()
    st = tuple(s.repeat(128) for s in st)
    fn, args = compact_run("pml", eng.di, codes, st)
    ms = cuda_ms(lambda: fn(*args), reps=10)
    ml = fn(*args)[1]
    S = halvings(ix.r) + 1
    mism = int(((ml[:, 0] == 0) & (codes[:, 0] >= 0)).sum())
    loads = codes.shape[0] * (S + 2) + 3 * mism
    lat_us = ms * 1e3 / loads
    say("small compact", f"dependent-load latency, tables in the cache "
                         f"(r={ix.r}, {codes.shape[0]} steps of {loads} "
                         f"chained loads, {S} all_p rows a step): "
                         f"{ms:.6f} ms = {lat_us * 1e3:.3f} ns a load")
    return lat_us


def phase_full(dev, card, errs, timings, work, text_len=FULL_TEXT,
               lanes=FULL_LANES, long_reads=LONG_READS, long_len=LONG_LEN):
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.testing import index_from_text, random_text, sim_reads

    t0 = time.perf_counter()
    text = random_text(text_len, 0)
    ix = index_from_text(text, sa_rate=SA_RATE)  # the SA phase's too
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
        add_work(work, "fused_pml_scan", *scan_work(a1[3], 8, 4, 12))
        add_work(work, "fused2_pml_scan", *scan_work(a12_t, 16, 8, 12))
    say("full", "each kernel equals its plain version over all lanes")
    # the compose reads the one-step table and writes the paired one
    add_work(work, "compose_paired_records", r * slots * (8 + 16 * slots),
             r * slots * slots * OPS_PER_ROW)

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
                        pick=pick, oracle=oracle, pmls=res_one, text=text)


def compact_breakdown(index, kind, reads, dev, k_ms, n_bases, card):
    """Where a warm compact query's time goes: host batching, prepare
    (codes to the card), the kernel (host clock), D2H and the per-read
    lists, with the card's busy and idle shares."""
    import torch

    from movi_tpu_torch.api import _as_batches

    eng = index.compact_engine("pml" if kind == "rpml" else kind,
                               kind == "rpml", dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index._run(eng, reads, QUERY_LANES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    t0 = time.perf_counter()
    bs = list(_as_batches(reads, QUERY_LANES))
    t = dict(batching=time.perf_counter() - t0, prepare=0.0, kernel=0.0,
             d2h=0.0, lists=0.0)
    for b in bs:
        t0 = time.perf_counter()
        codes, st = compact_codes(kind, eng, b)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn, args = compact_run(kind, eng.di, codes, st)
        out = fn(*args)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host = ([o.cpu().numpy() for o in (out[0][4], out[1])]
                if kind == "count" else out[1].cpu().numpy())
        t3 = time.perf_counter()
        if kind == "count":
            pos = b.lengths.astype(np.int64) - host[0]
            list(zip(pos.tolist(), host[1].tolist()))
        else:
            [host[:int(L), lane].tolist() for lane, L in enumerate(b.lengths)]
        t4 = time.perf_counter()
        t["prepare"] += t1 - t0
        t["kernel"] += t2 - t1
        t["d2h"] += t3 - t2
        t["lists"] += t4 - t3
    busy = k_ms / 1e3 / wall
    say("compact", f"warm compact {kind}: wall {wall:.6f} s = "
                   f"{n_bases / wall:.6e} bases/s; kernel {k_ms:.6f} ms, "
                   f"device busy share (kernel / wall) {busy:.6f}, idle "
                   f"share {1 - busy:.6f}; host stages: " + ", ".join(
                       f"{k} {v:.6f} s" for k, v in t.items())
        + f"  ({card})")


def phase_compact(dev, card, errs, timings, work, ctx, lat_us,
                  cut_lanes=8, cut_len=LONG_CUT):
    """Compact PML (threshold and --rpml rules), count and ZML on phase
    4's text indexed without NT splitting (the reference's runs), and
    --rpml PML on its regular (threshold-free) index, counted apart."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.build.suffix import build_bwt_runs
    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.engine import select
    from movi_tpu_torch.engine.device_index import PML_TABLES, SEARCH_TABLES
    from movi_tpu_torch.index.structure import build_move_index

    reads, n_bases, pick = ctx["reads"], ctx["n_bases"], ctx["pick"]
    t0 = time.perf_counter()
    runs = build_bwt_runs(ctx["text"])
    t_runs = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = Index(build_move_index(runs, "regular-thresholds"))
    regular = Index(build_move_index(runs, "regular"))
    t_ix = time.perf_counter() - t0
    del runs
    ix = index.ix
    t0 = time.perf_counter()
    engines = {k: index.compact_engine("pml" if k == "rpml" else k,
                                       k == "rpml", dev)
               for k in COMPACT_KINDS}
    reg_eng = regular.compact_engine("pml", True, dev)
    torch.cuda.synchronize()
    t_tab = time.perf_counter() - t0
    di = engines["pml"].di
    say("compact", f"text {len(ctx['text'])} bases without NT splitting: "
                   f"r={ix.r} (regular: r={regular.ix.r}); PML tables "
                   f"{di.hbm_bytes(PML_TABLES)} B (one-step records "
                   f"{select.one_step_pml_table_bytes(ix.r, ix.sigma)} B), "
                   f"count/ZML tables "
                   f"{engines['count'].di.hbm_bytes(SEARCH_TABLES)} B "
                   f"(one-step records "
                   f"{select.one_step_search_table_bytes(ix.r, ix.sigma)} "
                   f"B); host: BWT runs {t_runs:.3f} s, two move indexes "
                   f"{t_ix:.3f} s, compact tables built and moved "
                   f"{t_tab:.3f} s")

    # the compact paths, counted: nothing else launches between reset and
    # read
    torch.cuda.synchronize()
    kernels.reset_launches()
    res, walls = {}, {}
    for kind, eng in list(engines.items()) + [("regular rpml", reg_eng)]:
        t0 = time.perf_counter()
        res[kind] = (regular if kind.startswith("regular") else index)._run(
            eng, reads, QUERY_LANES)
        torch.cuda.synchronize()
        walls[kind] = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in COMPACT_KERNELS}
    say("compact", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"compact path")
    # threshold PMLs, counts and ZMLs do not depend on the run splitting
    for kind, key in (("pml", "pmls"), ("count", "count"), ("zml", "zml")):
        if res[kind] != ctx[key]:
            raise AssertionError(f"compact {kind} differs from the record "
                                 f"engines' on the split index")
    say("compact", "cold end to end (host clock, " + str(n_bases)
        + " bases): " + "; ".join(f"{k} {w:.3f} s = {n_bases / w:.6e} "
                                  f"bases/s" for k, w in walls.items())
        + f"; threshold PML, count and ZML equal phases 4-5's over all "
          f"reads  ({card})")
    t0 = time.perf_counter()
    sample = [reads[i] for i in pick]
    check_compact_oracle("full sample", sample,
                         {k: [res[k][i] for i in pick]
                          for k in COMPACT_KINDS}, ScalarEngine(ix))
    check_compact_oracle("full sample regular", sample[:64],
                         {"rpml": [res["regular rpml"][i]
                                   for i in pick[:64]]},
                         ScalarEngine(regular.ix))
    say("compact", f"{len(pick)} sampled reads equal ScalarEngine (PML both "
                   f"rules, count, ZML; 64 on the regular index) "
                   f"({time.perf_counter() - t0:.1f} s host)")
    del res

    # every kernel against its plain version: all lanes of the 150 bp
    # batches and the first `cut_lanes` long reads cut to `cut_len` bases
    batches = list(_as_batches(reads, QUERY_LANES))
    lanes = sum(b.lanes for b in batches if b.width <= READ_LEN)
    cut = next(_as_batches([(nm, sq[:cut_len]) for nm, sq in
                            reads[lanes:lanes + cut_lanes]], QUERY_LANES))
    runs_of = {k: [] for k in COMPACT_KINDS}
    plain_ms = dict.fromkeys(COMPACT_KINDS, 0.0)
    steps_of = {k: [] for k in COMPACT_KINDS}  # the longest lane a batch
    for kind, eng in engines.items():
        for b in batches + [cut]:
            codes, st = compact_codes(kind, eng, b)
            if b is cut or b.width <= READ_LEN:
                got, ms, run = compact_pair(kind, eng.di, codes, st,
                                            f"full {kind}", errs)
                plain_ms[kind] += ms
                if b is cut:
                    continue
            else:
                run = compact_run(kind, eng.di, codes, st)
                got = run[0](*run[1])
            runs_of[kind].append(run)
            steps_of[kind].append(int(compact_steps(kind, codes, got).max()))
            if kind != "rpml":
                add_work(work, COMPACT_KINDS[kind], *compact_work(
                    kind, eng.di, codes, got,
                    compact_tally(kind, eng.di, codes, st)))
    S = halvings(ix.r)
    longest = {k: max(v) for k, v in steps_of.items()}
    say("compact", f"kernels 12a (both rules), 12b and 12c equal their "
                   f"plain versions over all lanes of the 150 bp batches "
                   f"and {cut_lanes} long lanes cut to {cut_len} bases; "
                   f"the longest lane's steps: " + ", ".join(
                       f"{k} {v}" for k, v in longest.items())
        + f"; {S} halvings of all_p a fast-forward")
    shapes = [tuple(b.seqs.shape) for b in batches]
    for kind in COMPACT_KINDS:
        rs = runs_of[kind]
        k_ms = cuda_ms(lambda: [fn(*a) for fn, a in rs], reps=3)
        per = [cuda_ms(lambda: fn(*a), reps=3) for fn, a in rs]
        # the chain of one step: the row's char, lf_abs, the halvings and
        # the final all_p row, at the latency measured with the tables in
        # the cache (phase small compact)
        floor_ms = longest[kind] * (S + 3) * lat_us / 1e3
        timings[f"compact {kind}"] = (k_ms, plain_ms[kind], floor_ms)
        if kind != "rpml":
            timings[COMPACT_KINDS[kind]] = (k_ms, plain_ms[kind])
        say("compact", f"{kind} over the main path's {len(rs)} batches "
                       f"({n_bases} bases): kernel {k_ms:.6f} ms = "
                       f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                       f"{plain_ms[kind]:.6f} ms (over the inputs compared "
                       f"above), latency floor {floor_ms:.6f} ms "
                       f"({longest[kind]} steps x {S + 3} loads x "
                       f"{lat_us * 1e3:.3f} ns); the 10 kb batch "
                       f"{per[-1] / steps_of[kind][-1] * 1e3:.6f} us a step "
                       f"of its longest lane; kernel "
                       f"per batch [" + ", ".join(
                           f"{lb} lanes x {wb}: {ms:.6f} ms"
                           for (lb, wb), ms in zip(shapes, per))
            + f"]  ({card})")
    del runs_of
    for kind in COMPACT_KINDS:
        compact_breakdown(index, kind, reads, dev,
                          timings[f"compact {kind}"][0], n_bases, card)
    say("compact", f"peak device memory {torch.cuda.max_memory_allocated(dev)}"
                   f" B  ({card})")
    return counts


def phase_search(dev, card, errs, timings, work, ctx):
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
    ctx["count"], ctx["zml"] = res["count", False], res["zml", False]

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
    longest = {"count": [], "count2": []}
    for batch in batches:
        for kind in SCAN_OF:
            kern, plain, a, kw = search_args(kind, s2 if "2" in kind else si,
                                             batch, dev)
            ms, (st, _) = search_pair(kern, plain, a, kw, f"full {kind}",
                                      errs, SCAN_OF[kind])
            plain_ms[kind] += ms
            args[kind].append((kern, a, kw))
            add_work(work, SCAN_OF[kind], *search_work(kind, a[-1], st))
            if kind in longest:
                longest[kind].append(int(count_steps(kind, st).max()))
    say("search", "kernels 4-6 equal their plain versions over all lanes "
                  "and the whole table")
    say("search", "the longest count lane's dependent steps per batch "
                  "(latency floor): " + "; ".join(
                      f"{SCAN_OF[kind]} {steps} (max {max(steps)})"
                      for kind, steps in longest.items()))
    # the compose reads the run arrays and next-run tables, writes the table
    add_work(work, "compose_search2_records",
             4 * r * (3 + 2 * sigma) + 24 * 2 * r * sigma * sigma,
             2 * r * sigma * sigma * OPS_PER_ROW)

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


def require_sa_scan_equal(what, got, want, errs):
    """Kernel 8a's (state, ml, pre_idx, pre_off) against the plain
    version's, exactly."""
    for name, a, b in zip(("ml", "pre_idx", "pre_off"), got[1:], want[1:]):
        require_equal(f"{what} {name}", a, b, errs, "fused_sa_pre_scan")
    require_state_equal(what, got[0], want[0], errs, "fused_sa_pre_scan")


def sa_scan_pair(sx, codes, state, what, errs):
    """Kernel 8a and its plain version on the same inputs.  Returns the
    kernel's (state, ml, pre_idx, pre_off), the plain version's
    milliseconds and the kernel's arguments."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_sa as tsa

    fi = sx.fi
    args = (fi.records, sx.pre_tab, fi.sigma + 1, fi.p_dollar, codes, state)
    got = kernels.fused_sa_pre_scan(*args)
    want, plain_ms = timed_ms(lambda: tsa.pml_pre_state_scan_plain(*args))
    require_sa_scan_equal(what, got, want, errs)
    return got, plain_ms, args


def sa_walk_pair(sx, pre_idx, pre_off, what, errs):
    """Kernel 8b and the plain walk over the same flat elements, every one
    of the [W, lanes] batch (padding included): the SA values agree
    exactly and no walk is cut at max_steps.  Returns the plain walk's
    steps per element, its milliseconds and the kernel's arguments."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_sa as tsa

    fi = sx.fi
    args = (fi.records, fi.sigma + 1, sx.all_p, sx.sampled, sx.rate, sx.n,
            pre_idx.reshape(-1), pre_off.reshape(-1))
    got = kernels.sa_walk(*args)
    (want, steps), plain_ms = timed_ms(lambda: tsa.sa_walk_steps_plain(*args))
    require_equal(f"{what} SA values", got, want, errs, "sa_walk")
    if bool((got < 0).any()):
        raise AssertionError(f"{what}: a walk passed max_steps")
    return steps, plain_ms, args


def check_sa_oracle(what, reads, got, oracle):
    for (name, seq), (gname, res) in zip(reads, got):
        if gname != name or res != oracle.query_pml(seq, collect_sa=True):
            raise AssertionError(f"{what}: read {name} differs from "
                                 f"ScalarEngine(collect_sa=True)")


def phase_small_sa(dev, errs):
    import torch

    from movi_tpu_torch.cpu_ref.scalar import ScalarEngine
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused_sa as tsa
    from movi_tpu_torch.io.fastx import make_batches
    from movi_tpu_torch.testing import length_reads, small_sa_index

    for rate in SMALL_SA_RATES:
        text, ix, reads = small_sa_index(rate)
        reads = reads + length_reads(text)
        eng = tsa.FusedSAEngine(tf.build_fused_index(ix), ix, dev)
        sx = eng.sx
        batch = next(make_batches(reads, lanes=len(reads),
                                  bucket_widths=False))
        codes = eng.pml.prepare(batch)
        st0 = tf.initial_state(sx.fi, codes.shape[1], dev)
        what = f"small SA rate {rate}"
        whole, _, _ = sa_scan_pair(sx, codes, st0, what, errs)
        cut = codes.shape[0] // 2 | 1
        first, _, _ = sa_scan_pair(sx, codes[:cut], st0, f"{what} piece 1",
                                   errs)
        second, _, _ = sa_scan_pair(sx, codes[cut:], first[0],
                                    f"{what} piece 2", errs)
        joined = [torch.cat([a, b]) for a, b in zip(first[1:], second[1:])]
        require_sa_scan_equal(f"{what} split", (second[0], *joined), whole,
                              errs)
        steps, _, _ = sa_walk_pair(sx, whole[2], whole[3], what, errs)
        check_sa_oracle(what, reads, eng.query(reads, lanes=16),
                        ScalarEngine(ix))
        say("small SA", f"rate {rate}, r={ix.r}, n={sx.n}: kernels 8a and "
                        f"8b equal plain on {len(reads)} reads (lengths "
                        f"1-4097, with N; a scan split in two, "
                        f"{steps.numel()} walks, mean "
                        f"{float(steps.double().mean()):.3f} and at most "
                        f"{int(steps.max())} steps); FusedSAEngine equals "
                        f"ScalarEngine(collect_sa=True)")


def phase_sa(dev, card, errs, timings, work, ctx):
    """SA entries on phase 4's index (its sampled SA at rate 100) and
    reads, counted apart."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused_sa as tsa
    from movi_tpu_torch.io.fastx import make_batches

    index, reads, n_bases = ctx["index"], ctx["reads"], ctx["n_bases"]
    ix = index.ix
    t0 = time.perf_counter()
    eng = tsa.FusedSAEngine(index._fused, ix, dev)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    sx = eng.sx
    fi = sx.fi
    say("SA", f"r={ix.r}, n={sx.n}, rate {sx.rate}: one-step records "
              f"{fi.records.numel() * 4} B, pre_tab {sx.pre_tab.numel() * 4} "
              f"B, all_p {sx.all_p.numel() * 8} B, sampled SA "
              f"{sx.sampled.numel()} entries ({sx.sampled.numel() * 8} B); "
              f"side tables built and moved to the card in {t_build:.3f} s "
              f"(host CPU)")
    torch.cuda.reset_peak_memory_stats(dev)

    # the SA path, counted: nothing else launches between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    res = eng.query(reads, lanes=QUERY_LANES)
    torch.cuda.synchronize()
    wall_cold = time.perf_counter() - t0
    counts = {k: kernels.launches[k] for k in SA_KERNELS}
    say("SA", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the SA "
                                 f"path")
    if [(n, p) for n, (p, _) in res] != ctx["pmls"]:
        raise AssertionError("SA path PMLs differ from query_pml's")
    pick = ctx["pick"]
    check_sa_oracle("full SA sample", [reads[i] for i in pick],
                    [res[i] for i in pick], ctx["oracle"])
    say("SA", f"first query (host clock, {n_bases} bases): "
              f"{wall_cold:.3f} s = {n_bases / wall_cold:.6e} bases/s; PMLs "
              f"equal query_pml's; {len(pick)} sampled reads equal "
              f"ScalarEngine(collect_sa=True)  ({card})")
    del res

    # both kernels against their plain versions over all lanes of the main
    # path's batches; the plain versions are timed in this pass
    batches = list(make_batches(list(reads), lanes=QUERY_LANES,
                                bucket_widths=False))
    scans, walks, steps_all = [], [], []
    plain_ms = dict.fromkeys(SA_KERNELS, 0.0)
    for b in batches:
        codes = eng.pml.prepare(b)
        got, ms, a = sa_scan_pair(sx, codes, tf.initial_state(
            fi, codes.shape[1], dev), "full SA", errs)
        plain_ms["fused_sa_pre_scan"] += ms
        scans.append(a)
        # a record and a pre_tab row per code; ml, pre_idx, pre_off out
        add_work(work, "fused_sa_pre_scan", *scan_work(codes, 20, 12, 12))
        steps, ms, a = sa_walk_pair(sx, got[2], got[3], "full SA", errs)
        plain_ms["sa_walk"] += ms
        walks.append(a)
        # each step: the run's start and its record (8 B each); each
        # element: its (run, offset) in, the last start, the sample, out
        s = int(steps.sum())
        add_work(work, "sa_walk", 16 * s + 24 * steps.numel(),
                 s * OPS_PER_ROW)
        steps_all.append(steps)
    steps = torch.cat(steps_all)
    say("SA", f"kernels 8a and 8b equal their plain versions over all "
              f"lanes ({steps.numel()} walks, padding included): walk steps "
              f"per element mean {float(steps.double().mean()):.6f}, max "
              f"{int(steps.max())}, total {int(steps.sum())}; per batch "
              f"max {[int(s.max()) for s in steps_all]}")

    shapes = [tuple(b.seqs.shape) for b in batches]
    for name, fn, runs, reps in (
            ("fused_sa_pre_scan", kernels.fused_sa_pre_scan, scans, 5),
            ("sa_walk", kernels.sa_walk, walks, 3)):
        k_ms = cuda_ms(lambda: [fn(*a) for a in runs], reps=reps)
        timings[name] = (k_ms, plain_ms[name])
        per = ", ".join(f"{lb} lanes x {wb}: "
                        f"{cuda_ms(lambda: fn(*a), reps=reps):.6f} ms"
                        for (lb, wb), a in zip(shapes, runs))
        say("SA", f"{name} over the main path's {len(batches)} batches "
                  f"({n_bases} bases): kernel {k_ms:.6f} ms = "
                  f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                  f"{plain_ms[name]:.6f} ms; kernel per batch [{per}]  "
                  f"({card})")
    del scans, walks

    # where a warm query's time goes: host batching, prepare (codes to the
    # card), the two kernels, D2H of ml and SA values, per-read lists
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.query(reads, lanes=QUERY_LANES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stage = dict.fromkeys(("batching", "prepare", "pre-scan", "walk", "D2H",
                           "tolist"), 0.0)
    t0 = time.perf_counter()
    bs = list(make_batches(list(reads), lanes=QUERY_LANES,
                           bucket_widths=False))
    stage["batching"] = time.perf_counter() - t0
    for b in bs:
        marks = [time.perf_counter()]
        codes = eng.pml.prepare(b)
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        _, ml, pre_idx, pre_off = tsa.pml_pre_state_scan(
            fi.records, sx.pre_tab, fi.sigma + 1, fi.p_dollar, codes,
            tf.initial_state(fi, codes.shape[1], dev))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        sa = tsa.sa_walk(fi.records, fi.sigma + 1, sx.all_p, sx.sampled,
                         sx.rate, sx.n, pre_idx.reshape(-1),
                         pre_off.reshape(-1))
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        ml_h, sa_h = ml.cpu().numpy(), sa.reshape(ml.shape).cpu().numpy()
        marks.append(time.perf_counter())
        [(ml_h[:int(L), j].tolist(), sa_h[:int(L), j].tolist())
         for j, L in enumerate(b.lengths)]
        marks.append(time.perf_counter())
        for key, t_a, t_b in zip(("prepare", "pre-scan", "walk", "D2H",
                                  "tolist"), marks, marks[1:]):
            stage[key] += t_b - t_a
    k_ms = timings["fused_sa_pre_scan"][0] + timings["sa_walk"][0]
    busy = k_ms / 1e3 / wall
    say("SA", f"warm FusedSAEngine.query: wall {wall:.6f} s = "
              f"{n_bases / wall:.6e} bases/s; kernels {k_ms:.6f} ms, device "
              f"busy share (kernels / wall) {busy:.6f}, idle share "
              f"{1 - busy:.6f}; host stages: "
              + ", ".join(f"{k} {v:.6f} s" for k, v in stage.items())
              + f"  ({card})")
    say("SA", f"peak device memory in this phase "
              f"{torch.cuda.max_memory_allocated(dev)} B  ({card})")
    return counts


def require_kmer_equal(what, got, want, errs, key):
    """The membership kernel's (state, work) against the plain version's:
    every register, the emissions, and each lane's ticks and rows."""
    (st_k, work_k), (st_p, work_p) = got, want
    for name in st_p:
        require_equal(f"{what} {name}", st_k[name], st_p[name], errs, key)
    require_equal(f"{what} ticks and rows", work_k, work_p, errs, key)


def kmer_member_args(si, alc, state, k, ticks):
    """Kernel 9a's arguments (the rows with ftab codes when alc is [lanes,
    2W])."""
    use_ftab = alc.shape[1] == 2 * state["out"].shape[1]
    return (si.rec_all, si.init_rec, si.r, si.sigma, si.ftab_k, alc, state,
            k, ticks, use_ftab)


def kmer_member_pair(si, alc, state, k, ticks, what, errs, split=None):
    """Kernel 9a and its plain version on the same inputs; with `split`,
    the kernel also runs `split` ticks and then the rest from that state,
    which must equal one pass.  Returns the kernel's (state, work), the
    plain version's milliseconds and the kernel's arguments."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_kmer as tk

    args = kmer_member_args(si, alc, state, k, ticks)
    use_ftab = args[-1]
    got = kernels.kmer_member_scan(*args)
    want, plain_ms = timed_ms(
        lambda: tk.kmer_scan_plain(si, alc, state, k, ticks, use_ftab))
    require_kmer_equal(what, got, want, errs, "kmer_member_scan")
    if split is not None:
        half = kernels.kmer_member_scan(*args[:8], split, use_ftab)
        rest = kernels.kmer_member_scan(*args[:6], half[0], k, ticks,
                                        use_ftab)
        require_kmer_equal(f"{what} split", (rest[0], half[1] + rest[1]),
                           got, errs, "kmer_member_scan")
    return got, plain_ms, args


def prep_pair(al8, fk, what, errs):
    """Kernel 10a and its plain version; returns the kernel's output and
    the plain version's milliseconds."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_mem2 as tm2

    got = kernels.prep_alc(al8, fk)
    want, plain_ms = timed_ms(lambda: tm2.prep_alc_plain(al8, fk))
    require_equal(f"{what} prep fk={fk}", got, want, errs, "prep_alc")
    return got, plain_ms


def kmer_count_pair(paired, idx, slots, lane, start, k, what, errs):
    """Kernel 9b (one-step index) or 7b (paired) and the plain version
    over the [k, nk] windows of the same k-mers.  Returns the kernel's
    (found, count), the plain version's milliseconds, the windows and the
    kernel's (counter, fn, args)."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_search2 as ts2

    tabs = (idx.rec_all, idx.init_rec, idx.all_p, idx.r, idx.sigma)
    if paired:
        kern, plain = (kernels.fused2_kmer_count_scan,
                       ts2.fused2_kmer_count_scan_plain)
        key = "fused2_kmer_count_scan"
    else:
        kern, plain, key = (kernels.kmer_count_scan,
                            tk.kmer_count_scan_plain, "kmer_count_scan")
    args = (*tabs, slots, lane, start, k)
    got = kern(*args)
    win = tk.kmer_windows(slots, lane, start, k)
    want, plain_ms = timed_ms(lambda: plain(*tabs, win, k))
    for name, a, b in zip(("found", "count"), got, want):
        require_equal(f"{what} {key} {name}", a, b, errs, key)
    return got, plain_ms, win, (key, kern, args)


def kmer_count_steps(si, win, k):
    """The backward-search steps kernel 9b takes for each k-mer of win
    [k, nk] (up to its first empty step; none with an illegal char).  A
    k-mer's pair steps in kernel 7b are (steps - 1) // 2 + 1, none for
    none."""
    import torch

    from movi_tpu_torch.engine import fused_search as ts

    dead = ~(win >= 0).all(dim=0)
    rs, os_, re, oe = ts.init_interval(si.init_rec, win[k - 1])
    steps = torch.zeros(win.shape[1], dtype=torch.int64, device=win.device)
    for j in range(k - 2, -1, -1):
        steps += (~dead).to(torch.int64)
        nrs, nos, nre, noe, empty = ts.fused_bs_step(si.rec_all, si.r,
                                                     si.sigma, rs, os_, re,
                                                     oe, win[j])
        ok = ~dead & ~empty
        rs, os_, re, oe = (torch.where(ok, n, c) for n, c in
                           zip((nrs, nos, nre, noe), (rs, os_, re, oe)))
        dead = dead | empty
    return steps


def kmer_batch_inputs(batch, amap, k, dev):
    """(int8 read-order slots, lane int32, start int32) of every k-mer
    window of the batch, on dev."""
    import torch

    from movi_tpu_torch.engine import fused_kmer as tk

    al, own, pos = tk.kmer_starts(batch, amap, k)
    return [torch.from_numpy(x.astype(d)).to(dev)
            for x, d in ((al, np.int8), (own, np.int32), (pos, np.int32))]


def check_kmer_oracle(what, reads, got, oracle, k, counts):
    for (name, seq), (gname, res) in zip(reads, got):
        want = (oracle.count_kmers_bidirectional(seq, k) if counts
                else oracle.query_all_kmers(seq, k))
        if gname != name or res != want:
            raise AssertionError(f"{what}: read {name} differs from "
                                 f"AdvancedEngine")


def phase_small_kmer(dev, errs):
    import torch

    from movi_tpu_torch.build.prepare_ref import revcomp
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_search as ts
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.io.fastx import left_aligned_slots, make_batches
    from movi_tpu_torch.testing import ACGT, index_from_text, kmer_reads

    fw = np.random.default_rng(9).choice(ACGT, size=2500).astype(np.uint8)
    text = np.concatenate([fw, revcomp(fw)])
    ix = index_from_text(text)
    reads = kmer_reads(text, seed=3)
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    amap = ts.search_alphamap(ix)
    al8 = torch.from_numpy(left_aligned_slots(batch, amap, fill=-1)
                           .astype(np.int8)).to(dev)
    lengths = torch.from_numpy(batch.lengths).to(dev)
    oracle = AdvancedEngine(ix, ftab_k=0)
    k = 15
    ticks = []
    for fk in (0, 4, 6):
        si = ts.build_fused_search_index(ix, fk).to(dev)
        alc, _ = prep_pair(al8, fk, "small", errs)
        state = tk.make_kmer_state(batch.lanes, batch.width, lengths, k)
        (_, work_k), _, _ = kmer_member_pair(
            si, alc, state, k, tk.tick_cap(k, batch.width),
            f"small fk={fk}", errs, split=53)
        ticks.append(int(work_k[0].max()))
        check_kmer_oracle(f"small membership fk={fk}", reads,
                          list(zip(batch.names, tk.FusedKmerEngine(
                              si, k, dev).query_batch(batch))), oracle, k,
                          False)
    si0 = ts.build_fused_search_index(ix).to(dev)
    s2 = ts2.build_fused_search2_index(ix, dev)
    for kc in (8, 15, 31):
        slots, lane, start = kmer_batch_inputs(batch, amap, kc, dev)
        for paired, idx in ((False, si0), (True, s2)):
            kmer_count_pair(paired, idx, slots, lane, start, kc,
                            f"small k={kc}", errs)
        for eng in (tk.FusedKmerCountEngine(si0, kc, dev),
                    ts2.Fused2KmerCountEngine(s2, kc, dev)):
            check_kmer_oracle(f"small counts k={kc}", reads,
                              list(zip(batch.names, eng.query_batch(batch))),
                              oracle, kc, True)
    # the forward-only index: ftab-6 anchors keep fw-only validity
    rng = np.random.default_rng(31)
    fwo = rng.choice(ACGT, size=2500)
    fix = index_from_text(fwo)
    freads = [(f"f{i}", fwo[s:s + 60].tobytes())
              for i, s in enumerate(rng.integers(0, len(fwo) - 60, size=12))]
    got = tk.FusedKmerEngine(ts.build_fused_search_index(fix, 6), 11,
                             dev).query_batch(next(make_batches(
                                 freads, lanes=12)))
    if not all(got):
        raise AssertionError("forward-only ftab membership found nothing")
    check_kmer_oracle("small forward-only", freads,
                      list(zip([n for n, _ in freads], got)),
                      AdvancedEngine(fix), 11, False)
    say("small k-mer", f"r={ix.r}: kernels 10a and 9a (fk 0, 4, 6; split "
                       f"runs equal one pass; longest lane {ticks} ticks), "
                       f"9b and 7b (k 8, 15, 31) equal plain on "
                       f"{len(reads)} reads (width {batch.width}, with N, "
                       f"shorter than k); membership and both count engines "
                       f"equal AdvancedEngine, the forward-only ftab-6 "
                       f"index too")


def kmer_breakdown(index, reads, k, kw, dev, k_ms, n_windows, card):
    """Where a warm query_kmers's time goes: host batching, prep (slots or
    windows to the card, and kernel 10a for membership), the scan kernel,
    D2H (and the per-read sums for counts), result lists; the device's
    busy and idle shares."""
    import torch

    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_search2 as ts2

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index.query_kmers(reads, k=k, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    eng = index.kmer_engine(k, device=dev, **kw)
    stage = dict.fromkeys(("batching", "prep", "kernel", "D2H", "lists"), 0.0)
    t0 = time.perf_counter()
    bs = list(_as_batches(reads, QUERY_LANES))
    stage["batching"] = time.perf_counter() - t0
    counts = kw.get("counts", False)
    for b in bs:
        marks = [time.perf_counter()]
        if counts:
            if isinstance(eng, tk.FusedKmerCountEngine):
                idx, scan = eng.si, tk.kmer_count_scan
            else:
                idx, scan = eng.s2, ts2.fused2_kmer_count_scan
            slots, lane, start = kmer_batch_inputs(b, idx.alphamap_query, k,
                                                   dev)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            hit, cnt = scan(idx, slots, lane, start, k)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            sums = torch.zeros((2, b.lanes), dtype=torch.int64, device=dev)
            sums[0].index_add_(0, lane, hit.to(torch.int64))
            sums[1].index_add_(0, lane, cnt.to(torch.int64))
            f, t = sums.tolist()
            marks.append(time.perf_counter())
            list(zip(f, t))
        else:
            alc, state = eng.prepare(b)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            st, _ = tk.kmer_scan(eng.si, alc, state, k,
                                 tk.tick_cap(k, b.width), eng.use_ftab)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            out = st["out"].cpu().numpy()
            marks.append(time.perf_counter())
            tk.kmer_spans(out)
        marks.append(time.perf_counter())
        for key, t_a, t_b in zip(("prep", "kernel", "D2H", "lists"), marks,
                                 marks[1:]):
            stage[key] += t_b - t_a
    busy = k_ms / 1e3 / wall
    what = ("counts " + ("paired" if kw.get("paired") else "one-step")
            if counts else "membership")
    say("k-mer", f"warm query_kmers {what}: wall {wall:.6f} s = "
                 f"{n_windows / wall:.6e} k-mers/s; kernels {k_ms:.6f} ms, "
                 f"device busy share (kernels / wall) {busy:.6f}, idle share "
                 f"{1 - busy:.6f}; host stages: "
                 + ", ".join(f"{key} {v:.6f} s" for key, v in stage.items())
                 + f"  ({card})")


def phase_kmer(dev, card, errs, timings, work, ctx, lanes=KMER_LANES,
               long_sample=2, cut_lanes=8, cut_len=LONG_CUT):
    """k-mer membership and exact counts on phase 4's index (ftab-10
    anchor rows), counted apart."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.io.fastx import left_aligned_slots
    from movi_tpu_torch.testing import screening_reads

    index, ix, k = ctx["index"], ctx["index"].ix, KMER_K
    short = screening_reads(ctx["text"], lanes, READ_LEN, seed=KMER_SEED)
    longs = [rd for rd in ctx["reads"] if rd[0].startswith("l")]
    reads = [(f"m{i}", s.tobytes()) for i, s in enumerate(short)] + longs
    n_windows = sum(max(len(s) - k + 1, 0) for _, s in reads)
    t0 = time.perf_counter()
    eng = index.kmer_engine(k, device=dev)  # the ftab-10 table, on the card
    torch.cuda.synchronize()
    si = eng.si
    say("k-mer", f"r={ix.r}, fk={si.ftab_k}: membership table "
                 f"{si.rec_all.numel() * 4} B (4^{si.ftab_k} anchor rows "
                 f"{4 ** si.ftab_k * 16} B), built and moved in "
                 f"{time.perf_counter() - t0:.3f} s (host CPU); "
                 f"{len(reads)} reads, {n_windows} windows of k={k}")
    torch.cuda.reset_peak_memory_stats(dev)

    # the k-mer paths, counted: nothing else launches between reset and
    # read
    runs_kw = {"member": {}, "count": dict(counts=True, paired=False),
               "count2": dict(counts=True, paired=True)}
    torch.cuda.synchronize()
    kernels.reset_launches()
    res, walls = {}, {}
    for key, kw in runs_kw.items():
        t0 = time.perf_counter()
        res[key] = index.query_kmers(reads, k=k, device=dev, **kw)
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
    counts = {name: kernels.launches[name] for name in KMER_KERNELS}
    say("k-mer", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"k-mer path")
    if res["count"] != res["count2"]:
        raise AssertionError("k-mer counts: one-step and paired disagree")
    for (name, spans), (_, (found, _)) in zip(res["member"], res["count"]):
        if sum(c for _, c in spans) != found:
            raise AssertionError(f"read {name}: membership and counts find "
                                 f"different k-mers")
    n_found = sum(f for _, (f, _) in res["count"])
    say("k-mer", "cold end to end (host clock, " + str(n_windows)
        + " windows): " + "; ".join(f"{key} {w:.3f} s = "
                                    f"{n_windows / w:.6e} k-mers/s"
                                    for key, w in walls.items())
        + f"; {n_found} windows found; the layouts agree and membership "
          f"finds the counts' k-mers  ({card})")
    rng = np.random.default_rng(7)
    pick = np.sort(np.concatenate([
        rng.choice(lanes, ORACLE_SAMPLE - long_sample, replace=False),
        lanes + rng.choice(len(longs), long_sample, replace=False)]))
    oracle = AdvancedEngine(ix, ftab_k=0)
    t0 = time.perf_counter()
    for key in ("member", "count"):
        check_kmer_oracle(f"full sample {key}", [reads[i] for i in pick],
                          [res[key][i] for i in pick], oracle, k,
                          key == "count")
    say("k-mer", f"{len(pick)} sampled reads equal AdvancedEngine "
                 f"(membership and counts; {time.perf_counter() - t0:.1f} s "
                 f"host)")
    del res

    # every kernel against its plain version over all lanes of the main
    # path's batches (9a: the 150 bp batches, and the first `cut_lanes`
    # long reads cut to `cut_len` bases, since the plain machine takes
    # milliseconds per lockstep tick on the card; the 10 kb batch through
    # the kernel only); the plain versions are timed in this pass
    si0, s2 = index._search, index._paired_search
    batches = list(_as_batches(reads, QUERY_LANES))
    cut = next(_as_batches([(nm, sq[:cut_len]) for nm, sq in
                            longs[:cut_lanes]], QUERY_LANES))
    runs = {name: [] for name in KMER_KERNELS}
    plain_ms = dict.fromkeys(KMER_KERNELS, 0.0)
    longest, n_ticks, n_steps = [], 0, 0
    for b in batches + [cut]:
        al8 = torch.from_numpy(left_aligned_slots(b, si.alphamap_query,
                                                  fill=-1)
                               .astype(np.int8)).to(dev)
        alc, ms = prep_pair(al8, si.ftab_k, "full", errs)
        state = tk.make_kmer_state(b.lanes, b.width,
                                   torch.from_numpy(b.lengths).to(dev), k)
        ticks_cap = tk.tick_cap(k, b.width)
        if b is cut:
            _, ms, _ = kmer_member_pair(si, alc, state, k, ticks_cap,
                                        "full cut", errs)
            plain_ms["kmer_member_scan"] += ms
            continue
        plain_ms["prep_alc"] += ms
        runs["prep_alc"].append((kernels.prep_alc, (al8, si.ftab_k)))
        add_work(work, "prep_alc", al8.numel() * (1 + 8),
                 al8.numel() * 3 * si.ftab_k)
        if b.width <= READ_LEN:
            (_, kw_), ms, args = kmer_member_pair(si, alc, state, k,
                                                  ticks_cap, "full", errs)
            plain_ms["kmer_member_scan"] += ms
        else:
            args = kmer_member_args(si, alc, state, k, ticks_cap)
            kw_ = kernels.kmer_member_scan(*args)[1]
        runs["kmer_member_scan"].append((kernels.kmer_member_scan, args))
        ticks, rows = (int(x) for x in kw_.to(torch.int64).sum(dim=1))
        longest.append(int(kw_[0].max()))
        n_ticks += ticks
        # the slots and fk-mer codes and the state read once, the rows each
        # tick loads, the emissions written once
        add_work(work, "kmer_member_scan",
                 alc.numel() * 4 + 16 * rows + 2 * 40 * b.lanes
                 + 4 * b.lanes * b.width, ticks * 2 * OPS_PER_ROW)
        slots, lane, start = kmer_batch_inputs(b, si.alphamap_query, k, dev)
        steps = None
        for paired, idx in ((False, si0), (True, s2)):
            _, ms, win, (name, fn, a) = kmer_count_pair(
                paired, idx, slots, lane, start, k, "full", errs)
            plain_ms[name] += ms
            runs[name].append((fn, a))
            if steps is None:
                steps = kmer_count_steps(si0, win, k)
                n_steps += int(steps.sum())
            n = int(torch.where(steps > 0, (steps - 1) // 2 + 1, 0).sum()
                    if paired else steps.sum())
            # the slots read once; per k-mer its (lane, start), the count's
            # two run starts and (found, count); per step its two rows
            add_work(work, name, slots.numel() + lane.numel() * (8 + 8 + 5)
                     + n * 2 * (24 if paired else 16), n * OPS_PER_ROW)
    say("k-mer", f"kernels 9a, 9b, 7b and 10a equal their plain versions "
                 f"over all lanes (9a: the 150 bp batches and {cut_lanes} "
                 f"long lanes cut to {cut_len} bases); membership: "
                 f"{n_ticks} ticks, {n_ticks / n_windows:.6f} per window, "
                 f"the longest lane "
                 f"per batch {longest} ticks (latency floor); counts: "
                 f"{n_steps} one-step steps, the longest k-mer {k - 1} steps "
                 f"one-step, {(k - 2) // 2 + 1} pair steps paired")
    shapes = [tuple(b.seqs.shape) for b in batches]
    for name in KMER_KERNELS:
        rs = runs[name]
        k_ms = cuda_ms(lambda: [fn(*a) for fn, a in rs], reps=5)
        timings[name] = (k_ms, plain_ms[name])
        per = ", ".join(f"{lb} lanes x {wb}: "
                        f"{cuda_ms(lambda: fn(*a), reps=5):.6f} ms"
                        for (lb, wb), (fn, a) in zip(shapes, rs))
        say("k-mer", f"{name} over the main path's {len(batches)} batches "
                     f"({n_windows} windows): kernel {k_ms:.6f} ms = "
                     f"{n_windows / k_ms * 1e3:.6e} k-mers/s, plain "
                     f"{plain_ms[name]:.6f} ms; kernel per batch [{per}]  "
                     f"({card})")
    del runs

    kmer_breakdown(index, reads, k, {}, dev,
                   timings["prep_alc"][0] + timings["kmer_member_scan"][0],
                   n_windows, card)
    kmer_breakdown(index, reads, k, dict(counts=True, paired=False), dev,
                   timings["kmer_count_scan"][0], n_windows, card)
    kmer_breakdown(index, reads, k, dict(counts=True, paired=True), dev,
                   timings["fused2_kmer_count_scan"][0], n_windows, card)
    say("k-mer", f"peak device memory in this phase "
                 f"{torch.cuda.max_memory_allocated(dev)} B  ({card})")
    return counts


def require_machine_equal(what, got, want, errs, key):
    """A MEM machine's (state, work) from the kernel and the plain
    version: every register, the ends and counts, and each lane's ticks
    and rows."""
    (st_k, work_k), (st_p, work_p) = got, want
    for name in st_p:
        require_equal(f"{what} {name}", st_k[name], st_p[name], errs, key)
    require_equal(f"{what} ticks and rows", work_k, work_p, errs, key)


def mem_kernel_run(m2, alc, state, ticks, L=0, use_ftab=False):
    """(fn, args) of kernel 10b (L >= 2, BML) or 10c (L = 0, all-MEMs) on
    these inputs."""
    from movi_tpu_torch import kernels

    tabs = (m2.rec_all, m2.init_rec6, m2.r, m2.sigma, m2.n, m2.ftab_k)
    if L:
        return kernels.mem2_scan, (*tabs, alc, state, L, ticks, use_ftab)
    return kernels.all_mem2_scan, (*tabs, m2.p1, alc, state, ticks)


def mem_machine_pair(m2, alc, state, ticks, what, errs, L=0, use_ftab=False,
                     split=None):
    """Kernel 10b or 10c and its plain version on the same inputs; with
    `split`, the kernel also runs `split` ticks and then the rest from
    that state, which must equal one pass.  Returns the kernel's (state,
    work), the plain version's milliseconds and the kernel's (fn,
    args)."""
    from movi_tpu_torch.engine import fused_mem2 as tm2

    fn, args = mem_kernel_run(m2, alc, state, ticks, L, use_ftab)
    got = fn(*args)
    if L:
        want, plain_ms = timed_ms(lambda: tm2.mem2_scan_plain(
            m2, alc, state, L, ticks, use_ftab))
    else:
        want, plain_ms = timed_ms(lambda: tm2.all_mem2_scan_plain(
            m2, alc, state, ticks))
    require_machine_equal(what, got, want, errs, fn.__name__)
    if split is not None:
        half = fn(*mem_kernel_run(m2, alc, state, split, L, use_ftab)[1])
        rest = fn(*mem_kernel_run(m2, alc, half[0], ticks, L, use_ftab)[1])
        require_machine_equal(f"{what} split", (rest[0], half[1] + rest[1]),
                              got, errs, fn.__name__)
    return got, plain_ms, (fn, args)


def kmer2_left_steps(m2, s2, alive, fs, fe, slots, own, anchor, k, p):
    """The paired steps kernel 11b takes for each live (depth, group)
    partial (up to its death; the pad second char of an odd depth's last
    pair takes its step), and the live partials' count."""
    import torch

    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.engine.fused_mem2 import mem2_resolve

    G = own.shape[0]
    dev = own.device
    d = torch.arange(p, device=dev)[:, None].expand(p, G)
    live = alive.flip(0)[:p] & (d <= anchor[None, :].to(torch.int64))
    dl, gl = torch.nonzero(live, as_tuple=True)
    row = (k - 2 - dl) * G + gl
    rs, os_ = mem2_resolve(m2, fs.reshape(-1)[row])
    re, oe = mem2_resolve(m2, fe.reshape(-1)[row])
    W = slots.shape[1]
    base = own[gl].to(torch.int64) * W
    anc = anchor[gl].to(torch.int64)
    dead = torch.zeros_like(dl, dtype=torch.bool)
    steps = torch.zeros_like(dl)
    for j in range(0, p - 1, 2):
        act = ~dead & (j < dl)
        a1 = slots.reshape(-1)[base + (anc - 1 - j).clamp(min=0)].to(
            torch.int32)
        a2 = torch.where(j + 1 < dl,
                         slots.reshape(-1)[base + (anc - 2 - j).clamp(min=0)]
                         .to(torch.int32), -2)
        legal1 = a1 >= 0
        steps += (act & legal1).to(steps.dtype)
        mid, fin, e1, e2 = ts2.fused2_bs_step(
            s2.rec_all, s2.r, s2.sigma, rs, os_, re, oe,
            a1.clamp(min=0) * s2.sigma + a2.clamp(min=0), legal1, a2 >= 0)
        die = act & (~legal1 | e1 | (a2 == -1) | ((a2 >= 0) & e2))
        keep = act & ~die
        rs, os_, re, oe = (torch.where(keep & (a2 >= 0), f,
                                       torch.where(keep, mv, cv))
                           for cv, mv, f in zip((rs, os_, re, oe), mid, fin))
        dead |= die
    return steps, int(live.sum())


def kmer2_pair(m2, s2, slots, own, anchor, k, p, what, errs):
    """Kernels 11a and 11b and their plain versions on the same groups:
    alive, fw_abs_s and fw_abs_e [k-1, G], then found and count [p, G].
    Returns the kernels' outputs, the plain versions' milliseconds and
    the kernels' (fn, args)."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_kmer2 as tk2

    r_args = (m2.rec_all, m2.init_rec6, m2.r, m2.sigma, m2.n, m2.ftab_k,
              slots, own, anchor, k)
    right = kernels.kmer2_right_scan(*r_args)
    want, r_ms = timed_ms(lambda: tk2.kmer2_right_scan_plain(
        m2, tk.kmer_windows(slots, own, anchor, k), k))
    for name, a, b in zip(("alive", "fw_abs_s", "fw_abs_e"), right, want):
        require_equal(f"{what} k={k} 11a {name}", a, b, errs,
                      "kmer2_right_scan")
    l_args = (m2.rec_all, m2.r, m2.sigma, m2.n, m2.ftab_k, s2.rec_all,
              s2.all_p, slots, own, anchor, *right, k, p)
    left = kernels.kmer2_left_scan(*l_args)
    want, l_ms = timed_ms(lambda: tk2.kmer2_left_scan_plain(
        m2, s2, *right, slots, own, anchor, k, p))
    for name, a, b in zip(("found", "count"), left, want):
        require_equal(f"{what} k={k} 11b {name}", a, b, errs,
                      "kmer2_left_scan")
    return right, left, (r_ms, l_ms), (
        (kernels.kmer2_right_scan, r_args), (kernels.kmer2_left_scan, l_args))


def check_mem_oracle(what, reads, got, oracle, L):
    for (name, seq), (gname, res) in zip(reads, got):
        want = (oracle.query_mems(seq, L) if L >= 2
                else oracle.query_all_mems(seq))
        if gname != name or res != want:
            raise AssertionError(f"{what}: read {name} differs from "
                                 f"AdvancedEngine")


def fast_oracle(ix):
    """AdvancedEngine whose extend_bidirectional does its two run walks in
    numpy: the skip is the same masked sum of run lengths over the pre-step
    interval, and the rc interval moves by the same row counts through
    all_p (not through the device's skip tables).  The Python walks cost
    seconds per step on a 5 M-run index; the small MEM phase holds this
    oracle to AdvancedEngine read for read."""
    from movi_tpu_torch.constants import complement_char
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine, _is_empty

    n_arr = ix.n_arr.astype(np.int64)
    all_p = ix.all_p.astype(np.int64)
    # each run's complement char; the '$' run always counts
    key = np.array([complement_char(int(ch)) for ch in ix.alphabet],
                   dtype=np.int64)[ix.c_arr]
    key[ix.end_bwt_idx] = -1

    def walk(run, off, rows):
        a = all_p[run] + off + rows
        run2 = int(np.searchsorted(all_p, a, side="right")) - 1
        return run2, int(a - all_p[run2])

    class FastOracle(AdvancedEngine):
        def extend_bidirectional(self, c, fw, rc):
            c_comp = complement_char(c)
            new_fw = self.backward_search_step(c, *fw)
            if _is_empty(new_fw):
                return False, fw, rc
            rs, os_, re, oe = fw
            if rs == re:
                skip = oe - os_ + 1 if key[rs] < c_comp else 0
            elif rs > re:
                skip = 0
            else:
                w = n_arr[rs:re + 1].copy()
                w[0] -= os_
                w[-1] = oe + 1
                skip = int(w[key[rs:re + 1] < c_comp].sum())
            rrs, ros = walk(rc[0], rc[1], skip)
            rre, roe = walk(rrs, ros, self.interval_count(*new_fw) - 1)
            return True, new_fw, (rrs, ros, rre, roe)

    return FastOracle(ix, ftab_k=0)


def phase_small_mem2(dev, errs):
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
    from movi_tpu_torch.engine import fused_mem2 as tm2
    from movi_tpu_torch.engine import fused_search2 as ts2
    from movi_tpu_torch.engine.fused_kmer2 import FusedKmer2CountEngine
    from movi_tpu_torch.io.fastx import make_batches
    from movi_tpu_torch.testing import (junction_index, junction_reads,
                                        kmer_reads, mem_reads, rc_index,
                                        with_revcomp)

    # BML and all-MEMs on the index of tests/test_fused_mem2.py
    fw, ix = rc_index(4000, 7)
    oracle = AdvancedEngine(ix, ftab_k=0)
    rng = np.random.default_rng(11)
    reads = (mem_reads(rng, fw, 40, with_n=True)
             + mem_reads(rng, fw, 4, err=0.03, prefix="L",
                         lengths=(530, 700))
             + [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12),
                ("hash", fw[:30].tobytes() + b"#" + fw[40:60].tobytes())])
    batch = next(make_batches(reads, lanes=len(reads), bucket_widths=False))
    fast = fast_oracle(ix)
    for name, seq in reads:
        if (fast.query_mems(seq, 12) != oracle.query_mems(seq, 12)
                or fast.query_all_mems(seq) != oracle.query_all_mems(seq)
                or fast.count_kmers_bidirectional(seq, 11)
                != oracle.count_kmers_bidirectional(seq, 11)):
            raise AssertionError(f"the numpy-walk oracle differs from "
                                 f"AdvancedEngine on read {name}")
    ticks = {}
    for fk, L in ((0, 12), (6, 12), (8, 8), (0, 2), (0, 0)):
        m2 = tm2.build_fused_mem2_index(ix, fk).to(dev)
        eng = (tm2.FusedMem2Engine(m2, L, dev) if L
               else tm2.FusedAllMem2Engine(m2, dev))
        alc, state, cap = eng.prepare(batch)
        (_, work_k), _, _ = mem_machine_pair(
            m2, alc, state, cap, f"small fk={fk} L={L}", errs, L=L,
            use_ftab=bool(L) and eng.use_ftab, split=53)
        ticks[fk, L] = int(work_k[0].max())
        check_mem_oracle(f"small fk={fk} L={L}", reads,
                         list(zip(batch.names, eng.query_batch(batch))),
                         oracle, L)
    # the first-run-longer-than-one index (the empty-fw count clamp)
    fw50, ix50 = rc_index(50, 13)
    reads50 = [("n", b"N"), ("nn", b"NN"), ("mix", b"N" + fw50[:9].tobytes()),
               ("tail", fw50[5:20].tobytes() + b"N")]
    b50 = next(make_batches(reads50, lanes=4, bucket_widths=False))
    m50 = tm2.build_fused_mem2_index(ix50).to(dev)
    o50 = AdvancedEngine(ix50)
    for L in (0, 3):
        eng = (tm2.FusedMem2Engine(m50, L, dev) if L
               else tm2.FusedAllMem2Engine(m50, dev))
        alc, state, cap = eng.prepare(b50)
        mem_machine_pair(m50, alc, state, cap, f"small first-run L={L}",
                         errs, L=L)
        check_mem_oracle(f"small first-run L={L}", reads50,
                         list(zip(b50.names, eng.query_batch(b50))), o50, L)
    # ROADMAP §3.1: junction-spanning reads on a multi-document reference
    text, junctions, jix = junction_index()
    jreads = junction_reads(text, junctions, 15)
    jb = next(make_batches(jreads, lanes=15, bucket_widths=False))
    jm2 = tm2.build_fused_mem2_index(jix, 6).to(dev)
    joracle = AdvancedEngine(jix, ftab_k=0)
    for L in (8, 12):
        eng = tm2.FusedMem2Engine(jm2, L, dev)
        alc, state, cap = eng.prepare(jb)
        mem_machine_pair(jm2, alc, state, cap, f"small junction L={L}", errs,
                         L=L, use_ftab=True)
        check_mem_oracle(f"small junction L={L}", jreads,
                         list(zip(jb.names, eng.query_batch(jb))), joracle, L)

    # bidirectional k-mer counts on the index of tests/test_fused_kmer2.py
    fw21, kix = rc_index(3000, 21)
    ktext = with_revcomp(fw21)
    kreads = kmer_reads(ktext, seed=3)
    kb = next(make_batches(kreads, lanes=len(kreads), bucket_widths=False))
    km2 = tm2.build_fused_mem2_index(kix).to(dev)
    ks2 = ts2.build_fused_search2_index(kix, dev)
    koracle = AdvancedEngine(kix)
    for k, p in ((5, 2), (11, 5), (11, 1), (31, 15)):
        eng = FusedKmer2CountEngine(km2, ks2, k, p=p, device=dev)
        kmer2_pair(km2, ks2, *eng.prepare(kb), k, p, "small", errs)
        got = eng.query_batch(kb)
        want = [koracle.count_kmers_bidirectional(s, k) for _, s in kreads]
        if got != want or got != ts2.Fused2KmerCountEngine(
                ks2, k, dev).query_batch(kb):
            raise AssertionError(f"small bidirectional counts k={k} p={p} "
                                 f"differ from AdvancedEngine or the paired "
                                 f"engine")
    say("small MEM", f"r={ix.r}: kernels 10b (fk 0, 6, 8; L 2, 8, 12) and "
                     f"10c equal plain on {len(reads)} reads (width "
                     f"{batch.width}, with N, '#', shorter than L), split "
                     f"runs equal one pass, longest lane {ticks} ticks; the "
                     f"first-run-longer-than-one and junction indexes too; "
                     f"kernels 11a and 11b (k 5, 11, 31) equal plain on "
                     f"{len(kreads)} reads; the MEM and bidirectional count "
                     f"engines equal AdvancedEngine (junction reads at fk=6 "
                     f"included), and so does AdvancedEngine with numpy run "
                     f"walks (the full phase's oracle)")


def mem_breakdown(index, reads, kw, dev, k_ms, n_bases, card, what,
                  phase="MEM"):
    """Where a warm query's time goes (MEMs, or bidirectional counts with
    kw["k"]): host batching, prep (slots to the card, kernel 10a and the
    state before entry; or the groups), kernels, D2H, result lists; the
    device's busy and idle shares."""
    import torch

    from movi_tpu_torch.api import _as_batches
    from movi_tpu_torch.engine import fused_mem2 as tm2
    from movi_tpu_torch.engine import fused_kmer2 as tk2

    counts = "k" in kw
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if counts:
        index.query_kmers(reads, k=kw["k"], counts=True, paired=True,
                          device=dev)
        eng = index.kmer_engine(kw["k"], True, True, dev)
    else:
        index.query_mems(reads, kw["L"], device=dev)
        eng = index.mem_engine(kw["L"], dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    stage = dict.fromkeys(("batching", "prep", "kernels", "D2H", "lists"),
                          0.0)
    t0 = time.perf_counter()
    bs = list(_as_batches(reads, QUERY_LANES))
    stage["batching"] = time.perf_counter() - t0
    for b in bs:
        marks = [time.perf_counter()]
        if counts:
            prep = eng.prepare(b)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            right = tk2.kmer2_right_scan(eng.m2, *prep, eng.k)
            found, cnt = tk2.kmer2_left_scan(eng.m2, eng.s2, *right, *prep,
                                             eng.k, eng.p)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            sums = torch.zeros((2, b.lanes), dtype=torch.int64, device=dev)
            lane = prep[1].repeat(eng.p)
            sums[0].index_add_(0, lane, found.reshape(-1).to(torch.int64))
            sums[1].index_add_(0, lane, cnt.reshape(-1).to(torch.int64))
            f, t = sums.tolist()
            marks.append(time.perf_counter())
            list(zip(f, t))
        else:
            prep = eng.prepare(b)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            st, _ = eng.scan(*prep)
            torch.cuda.synchronize()
            marks.append(time.perf_counter())
            ends, cnts = st["ends"].cpu().numpy(), st["counts"].cpu().numpy()
            marks.append(time.perf_counter())
            tm2.mem_lists(ends, cnts)
        marks.append(time.perf_counter())
        for key, t_a, t_b in zip(("prep", "kernels", "D2H", "lists"), marks,
                                 marks[1:]):
            stage[key] += t_b - t_a
    busy = k_ms / 1e3 / wall
    say(phase, f"warm {what}: wall {wall:.6f} s = {n_bases / wall:.6e} "
               f"bases/s; kernels {k_ms:.6f} ms, device busy share (kernels "
               f"/ wall) {busy:.6f}, idle share {1 - busy:.6f}; host stages: "
               + ", ".join(f"{key} {v:.6f} s" for key, v in stage.items())
               + f"  ({card})")


def phase_mem(dev, card, errs, timings, work, half_len=MEM_RC_HALF,
              lanes=MEM_LANES, long_reads=LONG_READS, long_len=LONG_LEN,
              long_sample=1, cut_lanes=8, cut_len=LONG_CUT):
    """MEMs (BML at L = 20 with ftab-10 anchors, all-MEMs) and the
    bidirectional exact k-mer counts on bench.py's reverse-complement
    closed index, counted apart."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused_kmer as tk
    from movi_tpu_torch.engine import fused_mem2 as tm2
    from movi_tpu_torch.engine.fused_kmer2 import FusedKmer2CountEngine
    from movi_tpu_torch.testing import (index_from_text, random_text,
                                        screening_reads, sim_reads,
                                        with_revcomp)

    t0 = time.perf_counter()
    half = random_text(half_len, 1)
    ix = index_from_text(with_revcomp(half))
    t_ix = time.perf_counter() - t0
    index = Index(ix)
    t0 = time.perf_counter()
    eng = index.mem_engine(MEM_L, dev)  # the ftab-10 table, on the card
    torch.cuda.synchronize()
    m2 = eng.m2
    say("MEM", f"rc text {2 * half_len} bases, r={ix.r}, n={m2.n}: MEM v2 "
               f"table {m2.rec_all.numel() * 4} B (4^{m2.ftab_k} anchor "
               f"rows {4 ** m2.ftab_k * 32} B); host index build "
               f"{t_ix:.3f} s, table built and moved in "
               f"{time.perf_counter() - t0:.3f} s (host CPU)")
    short = sim_reads(half, lanes, READ_LEN, seed=MEM_SEED)
    longs = sim_reads(half, long_reads, long_len, seed=43)
    reads = ([(f"m{i}", s.tobytes()) for i, s in enumerate(short)]
             + [(f"l{i}", s.tobytes()) for i, s in enumerate(longs)])
    kshort = screening_reads(half, lanes, READ_LEN, seed=KMER_SEED)
    kreads = ([(f"k{i}", s.tobytes()) for i, s in enumerate(kshort)]
              + reads[lanes:])
    n_bases = lanes * READ_LEN + long_reads * long_len
    n_windows = sum(max(len(s) - KMER_K + 1, 0) for _, s in kreads)
    torch.cuda.reset_peak_memory_stats(dev)

    # the MEM and bidirectional count paths, counted: nothing else
    # launches between reset and read
    torch.cuda.synchronize()
    kernels.reset_launches()
    res, walls = {}, {}
    for key, fn in (
            ("bml", lambda: index.query_mems(reads, MEM_L, device=dev)),
            ("all", lambda: index.query_mems(reads, 0, device=dev)),
            ("count2", lambda: index.query_kmers(
                kreads, k=KMER_K, counts=True, paired=True, device=dev))):
        t0 = time.perf_counter()
        res[key] = fn()
        torch.cuda.synchronize()
        walls[key] = time.perf_counter() - t0
    counts = {name: kernels.launches[name] for name in MEM_KERNELS}
    say("MEM", f"main-path launches {counts}")
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} never launched on the "
                                 f"MEM path")
    keng = index.kmer_engine(KMER_K, True, True, dev)
    if not isinstance(keng, FusedKmer2CountEngine):
        raise AssertionError("the rc index's paired counts did not take the "
                             "bidirectional engine")
    t0 = time.perf_counter()
    res["count"] = index.query_kmers(kreads, k=KMER_K, counts=True,
                                     paired=False, device=dev)
    torch.cuda.synchronize()
    walls["count one-step"] = time.perf_counter() - t0
    if res["count"] != res["count2"]:
        raise AssertionError("bidirectional and one-step counts disagree")
    n_mems = {key: sum(len(m) for _, m in res[key]) for key in ("bml", "all")}
    say("MEM", "cold end to end (host clock): " + "; ".join(
        f"{key} {w:.3f} s" for key, w in walls.items())
        + f"; MEMs ({n_bases} bases): BML L={MEM_L} {n_mems['bml']}, "
          f"all-MEMs {n_mems['all']}; counts ({n_windows} windows of "
          f"k={KMER_K}): {sum(f for _, (f, _) in res['count'])} found, the "
          f"bidirectional and one-step engines agree  ({card})")
    rng = np.random.default_rng(7)
    pick = np.sort(np.concatenate([
        rng.choice(lanes, ORACLE_SAMPLE // 8 - long_sample, replace=False),
        lanes + rng.choice(long_reads, long_sample, replace=False)]))
    oracle = fast_oracle(ix)
    t0 = time.perf_counter()
    for key, L in (("bml", MEM_L), ("all", 0)):
        check_mem_oracle(f"full sample {key}", [reads[i] for i in pick],
                         [res[key][i] for i in pick], oracle, L)
    check_kmer_oracle("full sample bidirectional counts",
                      [kreads[i] for i in pick],
                      [res["count2"][i] for i in pick], oracle, KMER_K, True)
    say("MEM", f"{len(pick)} sampled reads equal AdvancedEngine with numpy "
               f"run walks (BML, all-MEMs, counts; "
               f"{time.perf_counter() - t0:.1f} s host)")
    # what the MEM v1 phase reuses: the index, the reads and these answers
    ctx = dict(ix=ix, reads=reads, lanes=lanes, oracle=oracle,
               v2={"bml": res["bml"], "all": res["all"]})
    del res

    # every kernel against its plain version: all lanes of the 150 bp
    # batches, and the first `cut_lanes` long reads cut to `cut_len` bases
    # (the plain machines take milliseconds per lockstep tick on the card)
    batches = list(_as_batches(reads, QUERY_LANES))
    kbatches = list(_as_batches(kreads, QUERY_LANES))
    cut = next(_as_batches([(n, s[:cut_len]) for n, s in
                            reads[lanes:lanes + cut_lanes]], QUERY_LANES))
    runs = {name: [] for name in MEM_KERNELS}
    plain_ms = dict.fromkeys(MEM_KERNELS, 0.0)
    longest = {name: [] for name in MEM_KERNELS}
    rows_of = {}
    for L in (MEM_L, 0):
        e = index.mem_engine(L, dev)
        name = "mem2_scan" if L else "all_mem2_scan"
        for b in batches + [cut]:
            alc, state, cap = e.prepare(b)
            use_ftab = bool(L) and e.use_ftab
            if b is cut or b.width <= READ_LEN:
                (_, w), ms, run = mem_machine_pair(
                    e.m2, alc, state, cap, f"full {name}", errs, L=L,
                    use_ftab=use_ftab)
                plain_ms[name] += ms
                if b is cut:
                    continue
            else:
                run = mem_kernel_run(e.m2, alc, state, cap, L, use_ftab)
                w = run[0](*run[1])[1]
            runs[name].append(run)
            ticks, rows = (int(x) for x in w.to(torch.int64).sum(dim=1))
            longest[name].append(int(w[0].max()))
            rows_of[name] = rows_of.get(name, 0) + rows
            # slots (and codes) and the state read once, the rows each
            # tick loads, ends and counts written once
            add_work(work, name, alc.numel() * 4 + 32 * rows
                     + 2 * 64 * b.lanes + 8 * b.lanes * b.width,
                     ticks * 2 * OPS_PER_ROW)
    s2 = index._paired_search
    p = KMER_K // 2
    steps_r = steps_l = 0
    for b in kbatches:
        slots, own, anchor = keng.prepare(b)
        right, left, (r_ms, l_ms), (r_run, l_run) = kmer2_pair(
            m2, s2, slots, own, anchor, KMER_K, p, "full", errs)
        plain_ms["kmer2_right_scan"] += r_ms
        plain_ms["kmer2_left_scan"] += l_ms
        runs["kmer2_right_scan"].append(r_run)
        runs["kmer2_left_scan"].append(l_run)
        G = own.shape[0]
        # 11a: a step loads two rows where the chain was alive and the
        # char legal
        win = tk.kmer_windows(slots, own, anchor, KMER_K) >= 0
        before = torch.cat([win[:1], right[0][:-1]])
        n_r = int((before & win[1:]).sum())
        steps_r += n_r
        add_work(work, "kmer2_right_scan",
                 slots.numel() + 8 * G + 64 * n_r + 9 * (KMER_K - 1) * G,
                 n_r * OPS_PER_ROW)
        # 11b: per live partial its two pos2rba rows (32 B sectors), its
        # abs ends, then its pair steps; per (depth, group) the alive flag
        # and (found, count)
        n_l, live = kmer2_left_steps(m2, s2, *right, slots, own, anchor,
                                     KMER_K, p)
        n_l = int(n_l.sum())
        steps_l += n_l
        add_work(work, "kmer2_left_scan",
                 slots.numel() + 8 * G + live * (64 + 8) + 48 * n_l
                 + p * G * (1 + 5), (n_l + live) * OPS_PER_ROW)
    longest["kmer2_right_scan"] = [KMER_K - 1]
    longest["kmer2_left_scan"] = [1 + (p - 1 + 1) // 2]
    say("MEM", f"kernels 10b, 10c, 11a and 11b equal their plain versions "
               f"(10b/10c over all lanes of the 150 bp batches and "
               f"{cut_lanes} long lanes cut to {cut_len} bases; 11a/11b over "
               f"every group); the longest lane per batch (latency floor, "
               f"x {TICK_US} us): 10b {longest['mem2_scan']} ticks, 10c "
               f"{longest['all_mem2_scan']} ticks; 11a {KMER_K - 1} steps, "
               f"11b 1 resolve + {p // 2} pair steps; rows: 10b "
               f"{rows_of['mem2_scan']}, 10c {rows_of['all_mem2_scan']}; "
               f"steps: 11a {steps_r}, 11b {steps_l}")
    shapes = {"mem": [tuple(b.seqs.shape) for b in batches],
              "kmer": [tuple(b.seqs.shape) for b in kbatches]}
    for name in MEM_KERNELS:
        rs = runs[name]
        k_ms = cuda_ms(lambda: [fn(*a) for fn, a in rs], reps=3)
        timings[name] = (k_ms, plain_ms[name])
        timings[name + ".floor"] = max(longest[name]) * TICK_US / 1e3
        sh = shapes["kmer" if "kmer2" in name else "mem"]
        per = ", ".join(f"{lb} lanes x {wb}: "
                        f"{cuda_ms(lambda: fn(*a), reps=3):.6f} ms"
                        for (lb, wb), (fn, a) in zip(sh, rs))
        say("MEM", f"{name} over the main path's {len(rs)} batches: kernel "
                   f"{k_ms:.6f} ms, plain {plain_ms[name]:.6f} ms (over the "
                   f"inputs compared above), latency floor "
                   f"{timings[name + '.floor']:.6f} ms; kernel per batch "
                   f"[{per}]  ({card})")
    del runs

    mem_breakdown(index, reads, {"L": MEM_L}, dev, timings["mem2_scan"][0],
                  n_bases, card, f"query_mems BML L={MEM_L}")
    mem_breakdown(index, reads, {"L": 0}, dev, timings["all_mem2_scan"][0],
                  n_bases, card, "query_mems all-MEMs")
    mem_breakdown(index, kreads, {"k": KMER_K}, dev,
                  timings["kmer2_right_scan"][0]
                  + timings["kmer2_left_scan"][0],
                  sum(len(s) for _, s in kreads), card,
                  f"query_kmers bidirectional counts k={KMER_K}")
    say("MEM", f"peak device memory in this phase "
               f"{torch.cuda.max_memory_allocated(dev)} B  ({card})")
    return counts, ctx


def mem1_kernel_run(mi, al, state, ticks, L=0):
    """(fn, args) of kernel 13b (L >= 2, BML) or 13c (L = 0, all-MEMs) on
    these inputs."""
    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine.fused_mem import kernel_tables

    if L:
        return kernels.mem1_scan, (*kernel_tables(mi), al, state, L, ticks)
    return kernels.all_mem1_scan, (*kernel_tables(mi), al, state, ticks)


def mem1_machine_pair(mi, al, state, ticks, what, errs, L=0):
    """Kernel 13b or 13c and its plain version on the same inputs, each
    run to convergence: every register, the ends and counts, each lane's
    ticks and table bytes.  Returns the kernel's (state, work), the plain
    version's milliseconds and the kernel's (fn, args)."""
    from movi_tpu_torch.engine import fused_mem as tm1

    fn, args = mem1_kernel_run(mi, al, state, ticks, L)
    got = fn(*args)
    if L:
        want, plain_ms = timed_ms(lambda: tm1.mem_scan_plain(
            mi, al, state, L, ticks))
    else:
        want, plain_ms = timed_ms(lambda: tm1.all_mem_scan_plain(
            mi, al, state, ticks))
    require_machine_equal(what, got, want, errs, fn.__name__)
    return got, plain_ms, (fn, args)


def mem1_tables(ix, dev):
    """The MEM v1 table of ix on dev in both reposition forms: with
    pos2rba, and with POS2RUN_MAX_N at 0 (the binary search)."""
    from movi_tpu_torch.engine import fused_mem as tm1

    saved = tm1.POS2RUN_MAX_N
    try:
        out = {"pos2rba": tm1.build_fused_mem_index(ix, dev)}
        tm1.POS2RUN_MAX_N = 0
        out["search"] = tm1.build_fused_mem_index(ix, dev)
    finally:
        tm1.POS2RUN_MAX_N = saved
    return out


def pos2rba_pair(ix, mi, what, errs):
    """Kernel 13a against its plain version, np.repeat and one PyTorch
    call (repeat_interleave of the runs' (run, all_p[run]) rows), byte for
    byte, on the table mi holds.  Returns (the kernel's (fn, args), the
    plain version's milliseconds, the library call's milliseconds)."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.engine import fused_mem as tm1

    dev = mi.all_p64.device
    n_arr = torch.from_numpy(ix.n_arr.astype(np.int32)).to(dev)
    args = (n_arr, mi.all_p64, mi.n)
    got = kernels.pos2rba_build(*args)
    want, plain_ms = timed_ms(lambda: tm1.pos2rba_plain(*args))
    require_equal(f"{what} pos2rba", got, want, errs, "pos2rba_build")
    # the library call's inputs, made before it is timed: the r pairs and
    # the run lengths as int64
    pairs = torch.stack((torch.arange(ix.r, dtype=torch.int32, device=dev),
                         mi.all_p64[:-1]), 1)
    reps64 = n_arr.to(torch.int64)

    def library():
        return torch.repeat_interleave(pairs, reps64, dim=0,
                                       output_size=mi.n)

    lib = library()
    lib_ms = cuda_ms(library, reps=3)
    runs = np.repeat(np.arange(ix.r), ix.n_arr)
    ref = np.stack([runs, ix.all_p[:-1][runs]], axis=1).astype(np.int32)
    for t, who in ((got, "kernel 13a"), (mi.pos2rba, "the table's pos2rba"),
                   (lib, "repeat_interleave")):
        if t.cpu().numpy().tobytes() != ref.tobytes():
            raise AssertionError(f"{what}: {who} differs from np.repeat")
    return (kernels.pos2rba_build, args), plain_ms, lib_ms


def phase_small_mem1(dev, errs):
    """The MEM v1 kernels on the index of tests/test_fused_mem.py: 13a
    equals its plain version and np.repeat; 13b (L 2, 12) and 13c equal
    theirs in both reposition forms on reads with N, '#', shorter than L
    and past 512 bases, and on the first-run-longer-than-one index; the
    engines equal AdvancedEngine; a lane past its tick budget raises."""
    from movi_tpu_torch.cpu_ref.advanced import AdvancedEngine
    from movi_tpu_torch.engine import fused_mem as tm1
    from movi_tpu_torch.io.fastx import make_batches
    from movi_tpu_torch.testing import mem_reads, rc_index

    fw, ix = rc_index(4000, 7)
    fw50, ix50 = rc_index(50, 13)
    rng = np.random.default_rng(21)
    hashes = []
    for name, seq in mem_reads(rng, fw, 12, prefix="h"):
        a = np.frombuffer(seq, np.uint8).copy()
        a[rng.integers(0, len(a), size=1 + len(hashes) % 2)] = ord("#")
        hashes.append((name, a.tobytes()))
    cases = [(ix, mem_reads(rng, fw, 40, with_n=True)
              + mem_reads(rng, fw, 4, err=0.03, prefix="L",
                          lengths=(530, 700))
              + hashes
              + [("short", b"ACG"), ("one", b"A"), ("allN", b"N" * 12),
                 ("edge", b"##" + fw[:20].tobytes() + b"#")]),
             (ix50, [("n", b"N"), ("nn", b"NN"),
                     ("mix", b"N" + fw50[:9].tobytes()),
                     ("tail", fw50[5:20].tobytes() + b"N")])]
    ticks = {}
    for cix, reads in cases:
        oracle = AdvancedEngine(cix, ftab_k=0)
        batch = next(make_batches(reads, lanes=len(reads),
                                  bucket_widths=False))
        for form, mi in mem1_tables(cix, dev).items():
            if form == "pos2rba":
                pos2rba_pair(cix, mi, f"small r={cix.r}", errs)
            for L in (12, 2, 0):
                eng = (tm1.FusedMemEngine(mi, L, dev) if L
                       else tm1.FusedAllMemEngine(mi, dev))
                al, state, cap = eng.prepare(batch)
                what = f"small r={cix.r} {form} L={L}"
                (_, work), _, _ = mem1_machine_pair(mi, al, state, cap,
                                                    what, errs, L)
                ticks[cix.r, form, L] = int(work[0].max())
                check_mem_oracle(what, reads,
                                 list(zip(batch.names,
                                          eng.query_batch(batch))),
                                 oracle, L)
                # a lane still running past its budget raises from the
                # wrapper
                fn, args = mem1_kernel_run(mi, al, state, 3, L)
                try:
                    fn(*args)
                except RuntimeError as e:
                    if "did not converge" not in str(e):
                        raise
                else:
                    raise AssertionError(f"{what}: no error past the tick "
                                         f"budget")
    say("small MEM v1", f"kernel 13a equals plain and np.repeat; kernels "
                        f"13b (L 2, 12) and 13c equal plain (every "
                        f"register, ends, counts, ticks and bytes) with "
                        f"pos2rba and with the binary search, on "
                        f"{len(cases[0][1])} reads (width {batch.width} "
                        f"last, with N, '#', shorter than L, past 512 "
                        f"bases) and on the first-run-longer-than-one "
                        f"index; the engines equal AdvancedEngine ('#' "
                        f"reads and a lone N included); a lane past its "
                        f"budget raises; longest lanes {ticks} ticks")


def phase_mem1(dev, card, errs, timings, work, ctx, lat_us, cut_lanes=8,
               cut_len=LONG_CUT):
    """MEMs on the v1 machines: phase MEM's index and reads through
    Index.query_mems (BML at L = 20, all-MEMs) with MEM2_MAX_N lowered
    below the index's length, as on an index past 2^28 positions; first
    with pos2rba, then with POS2RUN_MAX_N at 0 (the binary search that
    the route past 2^28 always takes), counted apart; then `query --mem`
    through the CLI, counted apart again."""
    import torch

    from movi_tpu_torch import cli as tcli
    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.engine import fused_mem as tm1
    from movi_tpu_torch.engine import fused_mem2 as tm2
    from movi_tpu_torch.io.outputs import mem_lines
    from movi_tpu_torch.testing import run_cli

    ix, reads, lanes = ctx["ix"], ctx["reads"], ctx["lanes"]
    n = int(ix.all_p[-1])
    n_bases = sum(len(s) for _, s in reads)
    forms = {"pos2rba": tm1.POS2RUN_MAX_N, "search": 0}
    saved = (tm2.MEM2_MAX_N, tm1.POS2RUN_MAX_N)
    tm2.MEM2_MAX_N = n - 1  # the route past the cap, in this process
    try:
        # the main path, counted: nothing else launches between reset and
        # read; each form builds its own table (kernel 13a with pos2rba)
        torch.cuda.synchronize()
        kernels.reset_launches()
        indexes, res, walls = {}, {}, {}
        for form, cap in forms.items():
            tm1.POS2RUN_MAX_N = cap
            indexes[form] = Index(ix)
            for key, L in (("bml", MEM_L), ("all", 0)):
                t0 = time.perf_counter()
                res[form, key] = indexes[form].query_mems(reads, L,
                                                          device=dev)
                torch.cuda.synchronize()
                walls[form, key] = time.perf_counter() - t0
        counts = {name: kernels.launches[name] for name in MEM1_KERNELS}
        others = {k: v for k, v in kernels.launches.items()
                  if v and k not in MEM1_KERNELS}
        say("MEM v1", f"main-path launches {counts}")
        for name, c in counts.items():
            if c <= 0:
                raise AssertionError(f"kernel {name} never launched on the "
                                     f"MEM v1 path")
        if others:
            raise AssertionError(f"the MEM v1 path launched {others}")
        for form in forms:
            mi = indexes[form]._mem1
            if (mi is None or indexes[form]._mem2 is not None
                    or (mi.pos2rba is None) != (form == "search")):
                raise AssertionError(f"{form}: Index.query_mems did not "
                                     f"take the v1 machines in this form")
        say("MEM v1", f"rc text n={n}, r={ix.r}, MEM2_MAX_N lowered to "
                      f"{n - 1}: v1 table {mem1_table_bytes(mi)} B without "
                      f"pos2rba, + {8 * n} B of pos2rba; cold end to end "
                      f"(host clock, the table build included): "
                      + "; ".join(f"{f} {k} {w:.3f} s"
                                  for (f, k), w in walls.items())
                      + f"  ({card})")
        for key in ("bml", "all"):
            for form in forms:
                if res[form, key] != ctx["v2"][key]:
                    bad = sum(a != b for a, b in zip(res[form, key],
                                                     ctx["v2"][key]))
                    raise AssertionError(f"MEM v1 {form} {key}: {bad} reads "
                                         f"differ from the v2 answers")
        rng = np.random.default_rng(8)
        pick = np.sort(np.concatenate([
            rng.choice(lanes, ORACLE_SAMPLE - 1, replace=False),
            lanes + rng.choice(len(reads) - lanes, 1, replace=False)]))
        t0 = time.perf_counter()
        for key, L in (("bml", MEM_L), ("all", 0)):
            check_mem_oracle(f"MEM v1 sample {key}", [reads[i] for i in pick],
                             [res["search", key][i] for i in pick],
                             ctx["oracle"], L)
        n_mems = {key: sum(len(m) for _, m in res["search", key])
                  for key in ("bml", "all")}
        say("MEM v1", f"both forms equal phase MEM's v2 answers on all "
                      f"{len(reads)} reads (BML L={MEM_L} {n_mems['bml']} "
                      f"MEMs, all-MEMs {n_mems['all']}), and {len(pick)} "
                      f"sampled reads equal AdvancedEngine with numpy run "
                      f"walks ({time.perf_counter() - t0:.1f} s host)")
        v2_lines = {key: "".join(ln + "\n" for name, r in res["search", key]
                                 for ln in mem_lines(name, r))
                    for key in ("bml", "all")}
        del res

        # every kernel against its plain version, in both forms: all lanes
        # of the 150 bp batches, and the first `cut_lanes` long reads cut
        # to `cut_len` bases; the 10 kb batch through the kernels only
        batches = list(_as_batches(reads, QUERY_LANES))
        cut = next(_as_batches([(nm, sq[:cut_len]) for nm, sq in
                                reads[lanes:lanes + cut_lanes]],
                               QUERY_LANES))
        runs = {(name, form): [] for name in MEM1_KERNELS for form in forms}
        plain_ms = {key: 0.0 for key in runs}
        longest = {key: [] for key in runs}
        works = {key: [] for key in runs}
        nbytes = dict.fromkeys(runs, 0)
        for form in forms:
            mi = indexes[form]._mem1
            if form == "pos2rba":
                run, ms, timings["pos2rba_build.library"] = pos2rba_pair(
                    ix, mi, "MEM v1", errs)
                runs["pos2rba_build", form].append(run)
                plain_ms["pos2rba_build", form] += ms
                add_work(work, "pos2rba_build", 4 * (2 * ix.r + 1) + 8 * n,
                         0)
            for L in (MEM_L, 0):
                e = indexes[form].mem_engine(L, dev)
                name = "mem1_scan" if L else "all_mem1_scan"
                for b in batches + [cut]:
                    al, state, tcap = e.prepare(b)
                    if b is cut or b.width <= READ_LEN:
                        (_, w), ms, run = mem1_machine_pair(
                            mi, al, state, tcap, f"MEM v1 {form} {name}",
                            errs, L)
                        plain_ms[name, form] += ms
                        if b is cut:
                            continue
                    else:
                        run = mem1_kernel_run(mi, al, state, tcap, L)
                        w = run[0](*run[1])[1]
                    runs[name, form].append(run)
                    works[name, form].append(w)
                    ticks_sum, table = (int(x) for x in
                                        w.to(torch.int64).sum(dim=1))
                    longest[name, form].append(int(w[0].max()))
                    nbytes[name, form] += table
                    # slots and the state read once, the table bytes each
                    # tick loads, ends and counts written once
                    add_work(work, name, al.numel() + table
                             + 2 * 48 * b.lanes + 8 * b.lanes * b.width,
                             ticks_sum * 2 * OPS_PER_ROW)
        say("MEM v1", f"kernels 13a, 13b and 13c equal their plain versions "
                      f"in both forms (13a and np.repeat byte for byte; "
                      f"13b/13c over all lanes of the 150 bp batches and "
                      f"{cut_lanes} long lanes cut to {cut_len} bases: every "
                      f"register, ends, counts, ticks and bytes); the "
                      f"longest lane per batch: "
                      + "; ".join(f"{nm} {f} {longest[nm, f]} ticks"
                                  for nm, f in runs if longest[nm, f])
                      + "; table bytes loaded: "
                      + "; ".join(f"{nm} {f} {nbytes[nm, f]}"
                                  for nm, f in runs if nbytes[nm, f]))
        shapes = [tuple(b.seqs.shape) for b in batches]
        floors = mem1_floors(works, tm1.find_run_loads(ix.r), lat_us)
        for name in MEM1_KERNELS:
            both = [run for form in forms for run in runs[name, form]]
            k_ms = cuda_ms(lambda: [fn(*a) for fn, a in both], reps=3)
            timings[name] = (k_ms, sum(plain_ms[name, f] for f in forms))
            per = []
            for form in forms:
                rs = runs[name, form]
                if not rs:
                    continue
                f_ms = cuda_ms(lambda: [fn(*a) for fn, a in rs], reps=3)
                timings[f"{name}.{form}"] = f_ms
                per.append(f"{form} {f_ms:.6f} ms"
                           + ("" if name == "pos2rba_build" else " [" + ", ".join(
                               f"{lb} lanes x {wb}: "
                               f"{cuda_ms(lambda: fn(*a), reps=3):.6f} ms"
                               for (lb, wb), (fn, a) in zip(shapes, rs))
                               + "]"))
            if name == "pos2rba_build":
                tail = (f"library (one repeat_interleave) "
                        f"{timings[name + '.library']:.6f} ms; no chain")
            else:
                tail = "latency floors " + "; ".join(
                    f"{form} {ms:.6f} ms ({t} ticks x {TICK_US} us + {x} "
                    f"extensions x {k} loads x {lat_us * 1e3:.3f} ns)"
                    for form, (ms, t, x, k) in floors[name].items())
            say("MEM v1", f"{name} over the main path's {len(both)} "
                          f"launches: kernel {k_ms:.6f} ms ("
                          + "; ".join(per)
                          + f"), plain {timings[name][1]:.6f} ms (over the "
                          f"inputs compared above), {tail}  ({card})")
        del runs

        for form, index in indexes.items():
            mem_breakdown(index, reads, {"L": MEM_L}, dev,
                          timings[f"mem1_scan.{form}"], n_bases, card,
                          f"query_mems BML L={MEM_L}, {form}", "MEM v1")
            mem_breakdown(index, reads, {"L": 0}, dev,
                          timings[f"all_mem1_scan.{form}"], n_bases, card,
                          f"query_mems all-MEMs, {form}", "MEM v1")
        del indexes

        # `query --mem` through the CLI (in this process) past the cap, on
        # the route past 2^28 (no pos2rba), counted apart
        tm1.POS2RUN_MAX_N = 0
        with tempfile.TemporaryDirectory() as d:
            idx = os.path.join(d, "idx")
            os.makedirs(idx)
            ix.save(os.path.join(idx, "index.npz"))
            rpath = os.path.join(d, "reads.fa")
            with open(rpath, "w") as f:
                f.writelines(f">{nm}\n{sq.decode()}\n" for nm, sq in reads)
            out = f"{rpath}.{ix.mode}.mems"
            for key, flags in (("bml", ["--min-mem-length", str(MEM_L)]),
                               ("all", [])):
                torch.cuda.synchronize()
                kernels.reset_launches()
                t0 = time.perf_counter()
                rc, _, err = run_cli(tcli.main, [
                    "query", "--index", idx, "--read", rpath, "--mem",
                    *flags, "--platform", "gpu"])
                wall = time.perf_counter() - t0
                if rc != 0:
                    raise AssertionError(f"CLI query --mem {key}: rc {rc}"
                                         f"\n{err[-2000:]}")
                name = "mem1_scan" if key == "bml" else "all_mem1_scan"
                used = {k: v for k, v in kernels.launches.items() if v}
                if ("using the fused MEM engine (v1, large-n)" not in err
                        or set(used) != {name}):
                    raise AssertionError(f"CLI query --mem {key} did not "
                                         f"take the v1 route: launches "
                                         f"{used}")
                with open(out) as f:
                    if f.read() != v2_lines[key]:
                        raise AssertionError(f"CLI query --mem {key}: the "
                                             f".mems file differs from the "
                                             f"v2 route's lines")
                say("MEM v1", f"CLI query --mem {' '.join(flags)} past the "
                              f"cap: logged the v1 engine, launches "
                              f"{used}, .mems equal to the v2 route's "
                              f"lines ({wall:.3f} s host, index load and "
                              f"table build included)")
    finally:
        tm2.MEM2_MAX_N, tm1.POS2RUN_MAX_N = saved
    return counts


def mem1_floors(works, find_loads, lat_us):
    """Kernels 13b and 13c's latency floors in each reposition form: the
    most, over every lane of every batch, of the lane's ticks x TICK_US
    and its successful extensions x the reposition's dependent loads x
    lat_us (one pos2rba row; find_loads for the binary search).  Both
    forms run the same ticks on the same reads, and a search extension
    loads 8 * find_loads - 16 bytes more than a pos2rba one, so a lane's
    extensions are its byte difference over that.  works[name, form]:
    the kernel's work per batch.  Returns {name: {form: (ms, ticks,
    extensions, loads)}} of each form's longest chain."""
    import torch

    extra = 8 * find_loads - 16
    loads = {"pos2rba": 1, "search": find_loads}
    out = {}
    for name in ("mem1_scan", "all_mem1_scan"):
        out[name] = dict.fromkeys(loads, (0.0, 0, 0, 0))
        for wp, ws in zip(works[name, "pos2rba"], works[name, "search"],
                          strict=True):
            diff = (ws[1] - wp[1]).to(torch.int64)
            if not torch.equal(wp[0], ws[0]) or bool((diff % extra).any()):
                raise AssertionError(f"{name}: the reposition forms differ "
                                     f"in more than their repositions")
            ext = diff // extra
            for form, k in loads.items():
                chain = (wp[0].to(torch.float64) * TICK_US
                         + ext.to(torch.float64) * (k * lat_us))
                i = int(chain.argmax())
                if float(chain[i]) / 1e3 > out[name][form][0]:
                    out[name][form] = (float(chain[i]) / 1e3, int(wp[0][i]),
                                       int(ext[i]), k)
    return out


def mem1_table_bytes(mi):
    """The v1 table's bytes on the card without pos2rba: the search
    records and init rows, all_p and the skip rows."""
    return sum(t.numel() * t.element_size() for t in
               (mi.si.rec_all, mi.si.init_rec, mi.all_p64, mi.skip_rec))


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


def color_cut(reads, lanes, cut_lanes, cut_len):
    """The long lanes the color scans' plain versions are held on: the
    first cut_lanes / 2 genome reads and the last cut_lanes / 2 random
    ones (color_reads), cut to `cut_len` bases, as one batch."""
    from movi_tpu_torch.api import _as_batches

    longs = reads[lanes:]
    half = cut_lanes // 2
    return next(_as_batches([(nm, sq[:cut_len]) for nm, sq in
                             longs[:half] + longs[-half:]], QUERY_LANES))


def color_pairs(eng, batches, cut, what, errs, key):
    """An engine's color scan kernel against its plain version on every
    150 bp batch and on `cut` (long reads cut short: the plain version
    takes milliseconds per lockstep step on the card); the long batches
    through the kernel only.  Returns the main path's runs (fn, args, kw)
    and the plain version's milliseconds."""
    runs, plain_ms = [], 0.0
    for b in batches + [cut]:
        if b is cut or b.width <= READ_LEN:
            _, ms, run = color_pair(eng, b, what, errs, key)
            plain_ms += ms
            if b is cut:
                continue
        else:
            kern, _, args, kw, _ = color_scan(eng, b)
            kern(*args, **kw)
            run = (kern, args, kw)
        runs.append(run)
    return runs, plain_ms


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
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.engine import fused_color as tfc
    from movi_tpu_torch.io.fastx import make_batches
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

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index
    from movi_tpu_torch.color import ColorEngine
    from movi_tpu_torch.engine import fused as tf
    from movi_tpu_torch.engine import fused2 as tf2
    from movi_tpu_torch.engine import fused_color as tfc
    from movi_tpu_torch.io.fastx import make_batches
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


def phase_color(dev, card, errs, timings, work, lanes=FULL_LANES,
                long_reads=LONG_READS, genomes=COLOR_GENOMES,
                genome_len=COLOR_GENOME_LEN, cut_lanes=8, cut_len=LONG_CUT):
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.color import ColorEngine
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
    # path's 150 bp batches and `cut_lanes` long reads cut to `cut_len`
    # bases (color_cut), and the compose over the whole table
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
    cut = color_cut(reads, lanes, cut_lanes, cut_len)
    runs, plain_ms = {}, {}
    for paired in (False, True):
        for es in (False, True):
            eng = index.color_engine(ct, paired, dev, early_stop=es)
            key = "fused2_color_scan" if paired else "fused_color_scan"
            runs[key, es], plain_ms[key, es] = color_pairs(
                eng, batches, cut, f"full {key} early_stop={es}", errs, key)
            for run in runs[key, es]:
                if not es:  # a record row (and a color id) per code
                    _, (rec, _, _, codes, _), kw = run
                    row = 4 * rec.shape[1] + (4 if kw.get("cids") is not None
                                              else 0)
                    add_work(work, key, *scan_work(
                        codes, row, 8 * (2 if paired else 1), 12))
    say("color", f"kernels A-C equal their plain versions over all lanes "
                 f"of the 150 bp batches and {cut_lanes} long lanes cut to "
                 f"{cut_len} bases, and over the whole table")
    # the compose reads the one-step table and the color ids, writes the
    # paired color table
    add_work(work, "compose_paired_color_records",
             r * (4 + slots * (8 + 32 * slots)),
             r * slots * slots * OPS_PER_ROW)

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
                         genome_len=WIDE_GENOME_LEN, cut_lanes=8,
                         cut_len=LONG_CUT):
    """A pangenome whose compressed color table keeps 2^16 sets: no
    3-word records, no paired color records; kernel A's two-load form."""
    import torch

    from movi_tpu_torch import kernels
    from movi_tpu_torch.api import Index, _as_batches
    from movi_tpu_torch.color import ColorEngine, compress_color_table
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
    cut = color_cut(reads, lanes, cut_lanes, cut_len)
    for es in (False, True):
        eng = index.color_engine(ct, device=dev, early_stop=es)
        rs, p_ms = color_pairs(eng, batches, cut, f"two-load early_stop={es}",
                               errs, "fused_color_scan")
        k_ms = cuda_ms(lambda: [f(*a, **kw) for f, a, kw in rs], reps=5)
        timings["two-load", es] = (k_ms, p_ms)
        say("two-load", f"fused_color_scan (two-load form) early_stop={es} "
                        f"over {len(batches)} batches ({n_bases} bases): "
                        f"kernel {k_ms:.6f} ms = "
                        f"{n_bases / k_ms * 1e3:.6e} bases/s, plain "
                        f"{p_ms:.6f} ms  ({card})")
    say("two-load", f"launches {counts}; {len(pick)} sampled reads equal "
                    f"ColorEngine; the kernel equals its plain version over "
                    f"all lanes of the 150 bp batches and {cut_lanes} long "
                    f"lanes cut to {cut_len} bases")
    color_breakdown(index, ct, reads, False, dev,
                    timings["two-load", False][0], n_bases, card, "two-load")


def phase_cli(platform):
    """The port's CLI, run in this process (movi_tpu_torch.cli.main), on
    `platform` against --platform cpu, byte for byte."""
    from movi_tpu_torch import cli as tcli
    from movi_tpu_torch.testing import mixed_reads, random_text, run_cli

    def cli(*argv):
        rc, out, err = run_cli(tcli.main, argv)
        if rc != 0:
            raise AssertionError(f"movi_tpu_torch.cli {' '.join(argv)}: rc "
                                 f"{rc}\n{err[-2000:]}")
        return out

    with tempfile.TemporaryDirectory() as d:
        refs = [random_text(20000, 11), random_text(15000, 12)]
        fasta = os.path.join(d, "ref.fa")
        with open(fasta, "w") as f:
            for i, t in enumerate(refs):
                f.write(f">doc{i}\n{t.tobytes().decode()}\n")
        idx = os.path.join(d, "idx")
        cli("build", "--fasta", fasta, "--index", idx, "--color",
            "--sa-entries")
        reads = mixed_reads(refs[0], seed=5, count=30)
        rng = np.random.default_rng(4)
        for i in range(30):
            src = refs[1] if i % 2 else random_text(1000, 100 + i)
            s = int(rng.integers(0, len(src) - 600))
            reads.append((f"long{i}", src[s:s + 600].tobytes()))
        rpath = os.path.join(d, "reads.fa")
        with open(rpath, "w") as f:
            f.writelines(f">{n}\n{s.decode()}\n" for n, s in reads)
        fw_idx = os.path.join(d, "idx_fw")
        cli("build", "--fasta", fasta, "--index", fw_idx, "--fw",
            "--skip-null")
        # one document and its reverse complement: reverse-complement
        # closed (the two-document index is not, at its junctions)
        one = os.path.join(d, "one.fa")
        with open(one, "w") as f:
            f.write(f">doc0\n{refs[0].tobytes().decode()}\n")
        rc_idx = os.path.join(d, "idx_rc")
        cli("build", "--fasta", one, "--index", rc_idx, "--skip-null")
        # no thresholds and no NT splitting: the compact engines
        reg_idx = os.path.join(d, "idx_reg")
        cli("build", "--fasta", fasta, "--index", reg_idx, "--type",
            "regular")
        mode = "regular-thresholds"
        kmers = f"{rpath}.{mode}.kmers.15"
        mems = f"{rpath}.{mode}.mems"
        # (query flags, the outputs compared: files, or stdout if none[,
        # the index when it is not the default one])
        runs = [(["--pml", "--classify"], [f"{rpath}.{mode}.pml.report"]),
                (["--zml", "--classify"], [f"{rpath}.{mode}.zml.report"]),
                (["--count"], ["{out}.count.matches"]),
                (["--zml", "--stdout"], []),
                (["--pml", "--rpml", "--stdout"], []),
                (["--pml", "--classify"], [f"{rpath}.regular.pml.report"],
                 reg_idx),
                (["--count"], ["{out}.count.matches"], reg_idx),
                (["--count", "--no-jax"], ["{out}.count.matches"]),
                (["--pml", "--multi-classify", "--report-colors"],
                 ["{out}", f"{rpath}.{mode}.colors"]),
                (["--pml", "--multi-classify", "--early-stop", "--report-all",
                  "--no-paired-records", "--stdout"], []),
                (["--pml", "--sa-entries"],
                 ["{out}.pml.sa_entries.bpf", "{out}.pml.bpf"]),
                (["--kmer", "--k", "15"], [kmers]),
                (["--kmer-count", "--k", "15", "--no-paired-records"],
                 [kmers]),
                (["--kmer-count", "--k", "15", "--paired-records",
                  "--stdout"], [], fw_idx),
                (["--kmer-count", "--k", "15", "--paired-records",
                  "--stdout"], [], rc_idx),
                (["--mem", "--min-mem-length", "12"], [mems]),
                (["--mem"], [mems]),
                (["--mem", "--min-mem-length", "12", "--ftab-k", "6",
                  "--stdout"], [])]
        n_found = {}
        for flags, outputs, *where in runs:
            texts = {}
            for plat in (platform, "cpu"):
                out = os.path.join(d, plat)
                stdout = cli("query", "--index", where[0] if where else idx,
                             "--read", rpath, *flags, "--platform", plat,
                             "--out-file", out)
                texts[plat] = b"" if outputs else stdout.encode()
                for output in outputs:
                    path = output.format(out=out)
                    with open(path, "rb") as f:
                        texts[plat] += f.read()
                    os.unlink(path)
            what = " ".join(flags) + (" (regular index)"
                                      if where == [reg_idx] else "")
            if texts[platform] != texts["cpu"] or not texts["cpu"]:
                raise AssertionError(f"CLI query {what}: output differs "
                                     f"between --platform {platform} and "
                                     f"cpu, or is empty")
            if "--classify" in flags:
                n_found[what] = sum(ln.split()[1] == "FOUND"
                                    for ln in texts["cpu"].decode()
                                    .splitlines()[1:]
                                    if len(ln.split()) > 1)
        # the one-document index is closed under reverse complements, so
        # its paired exact counts took the bidirectional engine
        from movi_tpu_torch.engine.fused_mem2 import looks_rc_closed
        from movi_tpu_torch.index.structure import MoveIndex

        if not looks_rc_closed(MoveIndex.load(os.path.join(rc_idx,
                                                           "index.npz"))):
            raise AssertionError("the one-document CLI index is not "
                                 "reverse-complement closed")
    say("cli", f"query --pml --classify, --zml --classify, --count, --zml "
               f"--stdout, --pml --rpml --stdout, --pml --classify and "
               f"--count on a build --type regular index (the compact "
               f"engines), --count --no-jax, --pml --multi-classify "
               f"--report-colors, --multi-classify --early-stop "
               f"--report-all --stdout, --pml --sa-entries (both .bpf "
               f"files), --kmer --k 15, --kmer-count --k 15 "
               f"--no-paired-records (the .kmers.15 file), --kmer-count "
               f"--paired-records on a build --fw index (kernel 7b) and on "
               f"a one-document reverse-complement closed index (kernels "
               f"11a and 11b), --mem --min-mem-length 12 and --mem (the "
               f".mems file), --mem --min-mem-length 12 --ftab-k 6 --stdout "
               f"on --platform {platform} ({len(reads)} reads; found "
               f"{n_found}; indexes by movi_tpu_torch.cli build, run in this "
               f"process) equal --platform cpu byte for byte")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the smoke "
              "needs one CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from movi_tpu_torch import kernels
    from movi_tpu_torch.build.suffix import _load_native
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

    errs, timings, work = {}, {}, {}
    t_start = time.perf_counter()

    def lap(name):
        say("time", f"{name} done at {time.perf_counter() - t_start:.1f} s")

    phase_small(dev, errs)
    phase_small_search(dev, errs)
    lat_us = phase_small_compact(dev, errs)
    phase_small_sa(dev, errs)
    phase_small_kmer(dev, errs)
    lap("small phases")
    counts, ctx = phase_full(dev, card, errs, timings, work)
    counts.update(phase_search(dev, card, errs, timings, work, ctx))
    lap("phases 4-5")
    counts.update(phase_compact(dev, card, errs, timings, work, ctx, lat_us))
    lap("compact")
    counts.update(phase_sa(dev, card, errs, timings, work, ctx))
    counts.update(phase_kmer(dev, card, errs, timings, work, ctx))
    del ctx
    lap("SA, k-mer")
    phase_small_mem2(dev, errs)
    lap("small MEM")
    phase_small_mem1(dev, errs)
    lap("small MEM v1")
    mem_counts, mem_ctx = phase_mem(dev, card, errs, timings, work)
    counts.update(mem_counts)
    lap("MEM")
    counts.update(phase_mem1(dev, card, errs, timings, work, mem_ctx,
                             lat_us))
    del mem_ctx
    lap("MEM v1")
    phase_small_color(dev, errs)
    counts.update(phase_color(dev, card, errs, timings, work))
    phase_color_two_load(dev, card, errs, timings)
    lap("color phases")
    phase_cli("gpu")
    lap("cli")

    rows = []
    for name, (src, rep) in CUDA_SOURCES.items():
        ms, plain_ms = timings[name]
        nbytes, nops = work[name]
        bound_ms, bound_by = bound(nbytes, nops)
        say("bound", f"{name}: {nbytes} B and {nops} integer ops on the "
                     f"path's inputs -> bound {bound_ms:.6f} ms "
                     f"({bound_by}); kernel {ms:.6f} ms, "
                     f"{bound_ms / ms:.6f} of the bound  ({card})")
        # one PyTorch call computes 13a (repeat_interleave); none
        # computes any of the scans or composes
        rows.append(dict(name=name, route="cuda", source=src, replaces=rep,
                         launches=counts[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         bound_by=bound_by,
                         library_ms=timings.get(name + ".library")))
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
