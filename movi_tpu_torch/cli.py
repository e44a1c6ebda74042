"""movi_tpu_torch command-line interface: `build`, and `query --pml`,
`--zml`, `--count`, `--kmer`, `--kmer-count`, `--mem`, `--pml
--sa-entries` and `--multi-classify` on the port.

    python -m movi_tpu_torch.cli build --fasta REF.fa --index IDX \\
        [--color] [--sa-entries [--sa-sample-rate 100]] [--skip-null]
    python -m movi_tpu_torch.cli query --index IDX --read READS \\
        (--pml [--rpml] | --zml | --count) [--classify | --filter
        [--invert]] [--stdout] [--no-output] [--no-resplit] [--platform cpu]
    python -m movi_tpu_torch.cli query --index IDX --read READS \\
        (--pml | --zml | --count) --no-jax [--logs] [--sa-entries]
    python -m movi_tpu_torch.cli query --index IDX --read READS \\
        (--kmer [--ftab-k FK [--multi-ftab]] | --kmer-count) [--k 31] \\
        [--stdout] [--no-output] [--platform cpu]
    python -m movi_tpu_torch.cli query --index IDX --read READS --mem \\
        [--min-mem-length L [--ftab-k FK]] [--stdout] [--platform cpu]
    python -m movi_tpu_torch.cli query --index IDX --read READS --pml \\
        --sa-entries [--platform cpu]
    python -m movi_tpu_torch.cli query --index IDX --read READS --pml \\
        --multi-classify [--early-stop] [--report-colors] [--report-all] \\
        [--lca-tree nodes.dmp] [--stdout] [--platform cpu]

Mirrors `build` and the query branches of movi_tpu/cli.py (index and
color-table loading, the routes, the classifier, the stdout/BPF/.matches/
report/.kmers/.mems/.multiclass.csv/.colors/log writers, LCA
post-processing) with the port's own copies of its host modules; the
record caches and the layout choice are `api.Index`'s.  A query takes the
route movi_tpu takes for the same index and flags: the record engines, the
compact engines (an index without thresholds or not built with bound_ff=1,
--rpml, or tables past the card's budget), or the scalar oracles
(--no-jax, --logs, SA entries without a device route, k-mers and MEMs on
an index the device engines cannot run); MEMs past MEM2_MAX_N positions
take the v1 machines, as in movi_tpu.  The files `build` writes
(index.npz, colors.npz, the null databases) load in either package.  The
other build outputs (index.movi, index.mmap, record caches, ftab) are not
yet ported: asking for them is an error, never a fallback to another
engine.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .commons import error, info, success, timing

_QUERIES = ("pml", "zml", "count")
_KMER_QUERIES = ("kmer", "kmer_count")
# build flags of movi_tpu/cli.py whose outputs the port does not write
_BUILD_NOT_PORTED = ("movi_format", "mmap", "fused_cache", "paired_cache",
                     "ftab_k", "bwt_file", "resume", "verify", "keep",
                     "legacy_header", "no_header", "checkpoint")


class NotPortedError(NotImplementedError):
    pass


def cmd_build(args):
    """FASTA -> index directory, as movi_tpu/cli.py cmd_build on its FASTA
    path: prepare-ref, suffix array and BWT runs, the move index (NT
    splitting by default for threshold modes), the sampled SA, document
    offsets, the Movi Color tables, index.npz and the null statistics."""
    from .build.prepare_ref import iter_fasta, prepare_ref
    from .build.suffix import build_bwt_runs
    from .classify import build_nulldb_pml
    from .constants import MODE_INFO
    from .cpu_ref.scalar import ScalarEngine
    from .index.structure import build_move_index

    asked = [f for f in _BUILD_NOT_PORTED
             if getattr(args, f) not in (None, "0")]
    if asked:
        raise NotPortedError(
            f"build --{asked[0].replace('_', '-')} is not yet ported to "
            f"movi_tpu_torch")
    fasta_paths = args.fasta
    if not fasta_paths:
        raise SystemExit("build requires --fasta")
    os.makedirs(args.index, exist_ok=True)
    t0 = time.time()
    ref = prepare_ref(fasta_paths, rc=not args.fw,
                      separators=args.separators, is_list=args.list,
                      out_fasta=os.path.join(args.index, "ref.fa")
                      if args.keep_ref else None)
    info(f"prepared reference: {len(ref.text)} bases "
         f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    runs = build_bwt_runs(ref.text)
    info(f"BWT: n={len(runs.bwt)} original_r={len(runs.starts)} "
         f"({time.time()-t0:.1f}s)")

    t0 = time.time()
    bound_ff = args.bound_ff
    if bound_ff is None and MODE_INFO[args.type][2]:
        # NT splitting enables the fused one-step engine
        bound_ff = 1
    ix = build_move_index(runs, args.type, separators=args.separators,
                          bound_ff=bound_ff)
    info(f"move index: r={ix.r} mode={args.type} ({time.time()-t0:.1f}s)")
    eng = ScalarEngine(ix)

    if args.sa_entries:
        if runs.sa is not None:
            ix.sampled_SA = runs.sampled_sa(args.sa_sample_rate)
        else:
            from .index.sweeps import lf_sweep

            ix.sampled_SA, _ = lf_sweep(ix, sa_sample_rate=args.sa_sample_rate)
        ix.sa_sample_rate = args.sa_sample_rate
        info(f"sampled SA: {len(ix.sampled_SA)} entries "
             f"(rate {args.sa_sample_rate})")

    # document metadata (always written; needed by color / multi-classify)
    with open(os.path.join(args.index, "ref.fa.doc_offsets"), "w") as f:
        for off in ref.doc_offsets:
            f.write(f"{off}\n")

    if args.color:
        from .color import (DocumentInfo, build_color_table,
                            build_color_table_from_index,
                            compress_color_table)

        di = DocumentInfo.create(ref.doc_offsets)
        if runs.sa is not None:
            ct = build_color_table(ix, runs.sa, di)
        else:
            ct = build_color_table_from_index(ix, di)
        if args.compress_colors:
            ct = compress_color_table(ct)
        if args.tree_compress_colors:
            from .lca import tree_compress_color_table

            ct = tree_compress_color_table(ct, ix.r)
        ct.save(os.path.join(args.index, "colors.npz"))
        ct.save_reference(args.index,
                          compressed=(args.compress_colors
                                      or args.tree_compress_colors),
                          flat=True)
        info(f"colors: {len(ct.unique_doc_sets)} unique doc sets over "
             f"{di.num_docs} documents")

    ix.save(os.path.join(args.index, "index.npz"))
    success(f"The index is built and stored in {args.index}")

    if not args.skip_null:
        # PML and ZML null statistics, like the reference build
        records = []
        for p in fasta_paths:
            records.extend(iter_fasta(p))
        random_rep = ix.thr is None
        db = build_nulldb_pml(
            ix, lambda s: eng.query_pml(s, random_repositioning=random_rep),
            records, seed=args.seed,
            null_reads_path=os.path.join(args.index, "null_reads.fasta"))
        db.save(os.path.join(args.index, "movi.pml.nulldb"))
        info(f"pml null statistics: percentile={db.percentile_value}")
        dbz = build_nulldb_pml(ix, eng.query_zml, records, seed=args.seed)
        dbz.save(os.path.join(args.index, "movi.zml.nulldb"))
        info(f"zml null statistics: percentile={dbz.percentile_value}")
    info("build done")


def _load_index(index_dir, resplit=True):
    """Load index.npz, or a reference-built index.movi, NT re-split for
    the fused engines unless resplit is False (query --no-resplit: the
    original rows, for the compact engines); movi_tpu/cli.py _load_index
    without --mmap."""
    from .index.structure import MoveIndex

    npz = os.path.join(index_dir, "index.npz")
    movi = os.path.join(index_dir, "index.movi")
    if os.path.exists(npz):
        return MoveIndex.load(npz)
    if os.path.exists(movi):
        from .index.movi_format import read_movi

        ix = read_movi(movi)
        if resplit and not ix.separators:
            from .index.resplit import needs_resplit, resplit_index

            if needs_resplit(ix):
                r_old = ix.r
                ix = resplit_index(ix)
                info(f"re-split reference-format index for the fused "
                     f"engines (r {r_old} -> {ix.r}); --no-resplit to "
                     f"keep the original rows")
        return ix
    raise SystemExit(f"no index found in {index_dir}")


def _apply_ignore_illegal(ix, reads, mode, seed=0):
    """Host-side --ignore-illegal-chars substitution: mode 1 maps illegal
    chars to 'A', mode 2 to a seeded-random base, drawn per read right to
    left (the scalar engine's order), so every engine gives the output
    ScalarEngine(ignore_illegal_chars=mode, seed=seed) would."""
    from .constants import SEPARATOR

    rng = np.random.default_rng(seed)
    keep = np.zeros(256, dtype=bool)
    keep[ix.alphabet] = True
    if ix.separators:
        keep[SEPARATOR] = True  # separators pass through unsubstituted
    out = []
    for name, seq in reads:
        arr = np.frombuffer(seq, np.uint8).copy()
        bad = np.flatnonzero(~keep[arr])
        if len(bad):
            if mode == 1:
                arr[bad] = ord("A")
            else:
                for p in bad[::-1]:
                    arr[p] = ix.alphabet[rng.integers(0, ix.sigma)]
        out.append((name, arr.tobytes()))
    return out


def _load_color_table(index_dir, ix):
    """The Movi Color tables: colors.npz; else the colored rows of
    index_colored.movi plus a doc_sets binary; else the reference doc_sets
    binaries with per-run indices."""
    from .color import ColorTable, load_document_info

    npz = os.path.join(index_dir, "colors.npz")
    if os.path.exists(npz):
        return ColorTable.load(npz)
    di = load_document_info(index_dir)
    colored = os.path.join(index_dir, "index_colored.movi")
    if os.path.exists(colored):
        from .index.movi_format import read_doc_sets_bin, read_movi_colored

        _, color_ids = read_movi_colored(colored)
        for name in ("doc_sets.bin", "compress_doc_sets.bin",
                     "tree_doc_sets.bin"):
            p = os.path.join(index_dir, name)
            if os.path.exists(p):
                # the per-run indices live in the colored rows
                sets, _ = read_doc_sets_bin(p, ix.r, with_inds=False)
                return ColorTable(doc_pats=None, doc_set_inds=color_ids,
                                  unique_doc_sets=sets, doc_info=di)
    return ColorTable.load_reference(index_dir, ix.r, di, length=ix.length)


def _paired_force(args):
    """--paired-records forces the paired engines, --no-paired-records the
    one-step ones; None picks by capacity (engine/select.py)."""
    if args.paired_records:
        return True
    if args.no_paired_records:
        return False
    return None


def cmd_query(args):
    """`query`, routed by the index and the flags as movi_tpu/cli.py
    cmd_query routes it: the record engines where the index allows them,
    the compact engines past the card's budget or on an index they cannot
    hold, the scalar oracles with --no-jax (--logs, --sa-entries without a
    device route) and for k-mers and MEMs on an index the device engines
    cannot run."""
    from .io.fastx import iter_fastx
    from .io.outputs import BPFWriter, count_line, pml_stdout_lines

    from .api import Index
    from .device import resolve_device
    from .engine.fused import is_bounded

    qt = next((q for q in _QUERIES if getattr(args, q)), None)
    if qt is None and args.mem:
        qt = "mems"
    if qt is None and any(getattr(args, q) for q in _KMER_QUERIES):
        qt = "kmers"
    if qt is None:
        raise SystemExit("specify one of --pml/--zml/--count/--mem/--kmer/"
                         "--kmer-count")
    # every route, the scalar ones too, runs where --platform says
    device = resolve_device("cuda" if args.platform == "gpu" else "cpu")

    ix = _load_index(args.index, resplit=not args.no_resplit)
    reads = list(iter_fastx(args.read))
    if args.reverse:
        reads = [(n, s[::-1]) for n, s in reads]
    if args.ignore_illegal_chars:
        # host-side substitution before batching, drawn in the scalar
        # engine's order so the output equals ScalarEngine's
        reads = _apply_ignore_illegal(ix, reads, args.ignore_illegal_chars)

    if args.logs:
        args.no_jax = True  # per-base cost tracing runs on the scalar path
    if args.sa_entries and qt == "pml" and not args.no_jax:
        if is_bounded(ix) and ix.thr is not None \
                and ix.sampled_SA is not None:
            sa_entries(args, ix, reads, device)
            return
        args.no_jax = True  # the scalar SA path
    elif args.sa_entries:
        args.no_jax = True
    index = Index.load(args.index, ix=ix)
    if args.multi_classify:
        multi_classify(args, ix, index, reads, device)
        return
    if qt in ("kmers", "mems"):
        on_device = not args.no_jax and index._on_device(qt)
        if not on_device:
            scalar_ftab(args, index)
        (kmers if qt == "kmers" else mems)(args, ix, index, reads, device,
                                           on_device)
        return
    if args.no_jax:
        results = scalar_query(args, ix, qt, reads)
    else:
        results = index._run(device_engine(args, ix, index, qt, device),
                             reads, args.lanes)

    classifier = None
    report_lines = []
    found_list = []  # positional, aligned with reads/results
    if args.classify:
        from .classify import (Classifier, EmpNullDatabase,
                               format_report_header)

        db = EmpNullDatabase.load(os.path.join(args.index,
                                               f"movi.{qt}.nulldb"))
        classifier = Classifier(db, bin_width=args.bin_width)
        report_lines.append(format_report_header(classifier.max_value_thr))

    out_prefix = (args.out_file if args.out_file
                  else f"{args.read}.{ix.mode}") + f".{qt}"
    lines_out = []
    # results are aligned with reads: a count line takes its read's length
    for (name, res), (_, seq) in zip(results, reads):
        if qt == "count":
            pos, cnt = res
            lines_out.append(count_line(name, len(seq), pos, cnt))
            continue
        if classifier:
            from .classify import format_report_line

            found, avg, above, below = classifier.classify(res)
            found_list.append(found)
            report_lines.append(
                format_report_line(name, found, avg, above, below))
        if args.stdout:
            lines_out.extend(pml_stdout_lines(name, res))

    if args.filter and classifier:
        for (name, seq), f in zip(reads, found_list):
            if f != args.invert:
                print(f">{name}")
                print(seq.decode())
    elif args.stdout:
        for ln in lines_out:
            print(ln)
    elif args.no_output:
        pass
    elif qt == "count":
        with open(out_prefix + ".matches", "w") as f:
            for ln in lines_out:
                f.write(ln + "\n")
        info(f"wrote {out_prefix}.matches")
    else:
        with BPFWriter(out_prefix + ".bpf") as w:
            for name, res in results:
                w.write_read(name, res)
        info(f"wrote {out_prefix}.bpf")

    if classifier and not args.filter:
        if args.stdout:
            for ln in report_lines:
                print(ln)
        elif not args.no_output:
            rpath = f"{args.read}.{ix.mode}.{qt}.report"
            with open(rpath, "w") as f:
                for ln in report_lines:
                    f.write(ln + "\n")
            info(f"wrote {rpath}")


def device_engine(args, ix, index, qt, device):
    """The device engine of a PML, ZML or count query: --rpml takes the
    compact PML engine, anything else the engine Index.engine or
    search_engine picks (movi_tpu/cli.py's routes: the records where the
    index allows them and they fit, else the compact engine)."""
    from .commons import warning
    from .engine.pml import PMLEngine
    from .engine.search import CountEngine, ZMLEngine
    from .engine.select import pick_backend

    paired = _paired_force(args)
    if pick_backend(ix.r, ix.sigma, "pml" if qt == "pml" else "search",
                    force_paired=paired, device=device) == "compact":
        warning(f"index (r={ix.r}) exceeds the device's record-table "
                f"budget; falling back to the compact engine.  A model-"
                f"sharded mesh runs the record layout "
                f"(parallel/sharded_index.py; engine/select.pick_backend)")
    if qt == "pml" and args.rpml:
        eng = index.compact_engine("pml", True, device)
    elif qt == "pml":
        eng = index.engine(paired, device)
    else:
        eng = index.search_engine(qt, paired, device)
    name = type(eng).__name__
    if getattr(eng, "random_repositioning", False):
        name += ", random repositioning"
    compact = isinstance(eng, (PMLEngine, CountEngine, ZMLEngine))
    info(f"using the {'compact' if compact else 'record'} {qt} engine "
         f"({name})")
    return eng


def scalar_query(args, ix, qt, reads):
    """--no-jax: ScalarEngine per read (LoggingScalarEngine with --logs
    for PML, writing .costs/.scans/.fastforwards); with --sa-entries on
    PML, also {prefix}.pml.sa_entries.bpf."""
    from .commons import read_progress
    from .cpu_ref.scalar import ScalarEngine
    from .io.outputs import BPFWriter

    results = []
    rand_rep = args.rpml or ix.thr is None
    if args.logs and qt == "pml":
        from .logs import LoggingScalarEngine, write_log_files

        leng = LoggingScalarEngine(ix)
        log_entries = []
        for name, seq in reads:
            pmls, qlogs = leng.query_pml_logged(seq)
            results.append((name, pmls))
            log_entries.append((name, qlogs))
        write_log_files(f"{args.read}.{ix.mode}.{qt}", log_entries)
        info(f"wrote {args.read}.{ix.mode}.{qt}.{{costs,scans,fastforwards}}")
        return results
    eng = ScalarEngine(ix, ignore_illegal_chars=args.ignore_illegal_chars)
    sa_results = []
    for read_i, (name, seq) in enumerate(reads):
        read_progress(read_i)
        if qt == "pml" and args.sa_entries:
            pmls, sas = eng.query_pml(seq, random_repositioning=rand_rep,
                                      collect_sa=True)
            results.append((name, pmls))
            sa_results.append((name, sas))
        elif qt == "pml":
            results.append((name, eng.query_pml(
                seq, random_repositioning=rand_rep)))
        elif qt == "zml":
            results.append((name, eng.query_zml(seq)))
        else:
            results.append((name, eng.query_count(seq)))
    if sa_results and not args.no_output:
        out_sa = (args.out_file or f"{args.read}.{ix.mode}") + \
            f".{qt}.sa_entries.bpf"
        with BPFWriter(out_sa, entry_size=64) as w:
            for name, sas in sa_results:
                w.write_read(name, sas)
        info(f"wrote {out_sa}")
    return results


def scalar_ftab(args, index):
    """The scalar AdvancedEngine's ftab for --ftab-k > 1: from ftab.{k}.npy
    or .bin in the index directory, else built (with --multi-ftab, every
    width from 2 to k)."""
    fk = args.ftab_k
    info("using the scalar AdvancedEngine")
    if fk <= 1 or args.multi_ftab:
        if fk > 1:
            index.use_scalar_ftab(fk, multi_ftab=True)
        return
    npy = os.path.join(args.index, f"ftab.{fk}.npy")
    bin_path = os.path.join(args.index, f"ftab.{fk}.bin")
    if os.path.exists(npy):
        index.use_scalar_ftab(fk, ftab=np.load(npy))
    elif os.path.exists(bin_path):
        from .index.movi_format import read_ftab_bin

        index.use_scalar_ftab(fk, ftab=read_ftab_bin(bin_path)[1])
    else:
        index.use_scalar_ftab(fk)


def sa_entries(args, ix, reads, device):
    """The --pml --sa-entries branch on an index with thresholds,
    bound_ff=1 and a sampled SA: per-base PMLs and SA entries on the fused
    SA engine; <prefix>.pml.sa_entries.bpf (64-bit entries) and
    <prefix>.pml.bpf, or with --no-output the PML lines on --stdout."""
    from .engine.fused import build_fused_index
    from .engine.fused_sa import FusedSAEngine
    from .io.outputs import BPFWriter, pml_stdout_lines

    info("using the fused SA-entries engine")
    eng = FusedSAEngine(build_fused_index(ix), ix, device)
    out = eng.query(reads, lanes=args.lanes)
    results = [(name, pmls) for name, (pmls, _) in out]
    sa_results = [(name, sas) for name, (_, sas) in out]
    prefix = args.out_file or f"{args.read}.{ix.mode}"
    if not args.no_output:
        out_sa = prefix + ".pml.sa_entries.bpf"
        with BPFWriter(out_sa, entry_size=64) as w:
            for name, sas in sa_results:
                w.write_read(name, sas)
        info(f"wrote {out_sa}")
        with BPFWriter(prefix + ".pml.bpf") as w:
            for name, pmls in results:
                w.write_read(name, pmls)
        info(f"wrote {prefix}.pml.bpf")
    elif args.stdout:
        for name, pmls in results:
            for ln in pml_stdout_lines(name, pmls):
                print(ln)


def kmers(args, ix, index, reads, device, on_device):
    """The --kmer and --kmer-count branches, on the device engines or the
    scalar oracle (its k-mer statistics go to the log): per read
    `name<TAB>found/(L-k+1)<TAB>spans` (membership: `start:count ` per
    stretch) or `...<TAB>total` (exact counts), to {read}.{mode}.kmers.{k}
    or --stdout."""
    k = args.k
    results = index.query_kmers(reads, k=k, counts=args.kmer_count,
                                lanes=args.lanes, paired=_paired_force(args),
                                device=device, ftab_k=args.ftab_k or 10,
                                jax=on_device)
    lines = []
    for (name, res), (_, seq) in zip(results, reads):
        if args.kmer_count:
            found, tail = res[0], res[1]
        else:
            found = sum(c for _, c in res)
            tail = " ".join(f"{p}:{c}" for p, c in res) + (" " if res else "")
        lines.append(f"{name}\t{found}/{len(seq) - k + 1}\t{tail}")
    if args.stdout:
        for ln in lines:
            print(ln)
    elif not args.no_output:
        out = f"{args.read}.{ix.mode}.kmers.{k}"
        with open(out, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
        info(f"wrote {out}")
    if not on_device:
        for ln in index.scalar.kmer_stats.summary().splitlines():
            info(ln)


def mems(args, ix, index, reads, device, on_device):
    """The --mem branch: `name<TAB>pos<TAB>end<TAB>count` per MEM (BML with
    --min-mem-length >= 2, on the device table with fk = min(--ftab-k or
    10, L) anchor rows, past MEM2_MAX_N positions on the v1 machines, or
    on the scalar oracle with its ftab; all-MEMs otherwise), to
    {read}.{mode}.mems or --stdout."""
    from .engine.fused_mem import FusedAllMemEngine, FusedMemEngine
    from .io.outputs import mem_lines

    L = args.min_mem_length
    if on_device:
        fk = min(args.ftab_k or 10, L) if L >= 2 else 0
        eng = index.mem_engine(L, device, table_ftab_k=fk)
        if isinstance(eng, (FusedMemEngine, FusedAllMemEngine)):
            # past the v2 table's cap: the v1 machines (--ftab-k unused)
            info("using the fused MEM engine (v1, large-n)")
        results = index._run(eng, reads, args.lanes)
    else:
        results = index.query_mems(reads, L, ftab_k=args.ftab_k,
                                   device=device, jax=False)
    lines = [ln for name, res in results for ln in mem_lines(name, res)]
    if args.stdout:
        for ln in lines:
            print(ln)
    elif not args.no_output:
        out = f"{args.read}.{ix.mode}.mems"
        with open(out, "w") as f:
            for ln in lines:
                f.write(ln + "\n")
        info(f"wrote {out}")


def multi_classify(args, ix, index, reads, device):
    """The --multi-classify branch: the CSV of per-read calls (or stdout),
    the .colors file with --report-colors, LCA post-processing.  The color
    engines need thresholds and bound_ff=1; other indexes, and --no-jax,
    take the scalar ColorEngine."""
    ct = _load_color_table(args.index, ix)
    report_colors = args.report_colors or args.report_color_ids
    color_kw = dict(min_match_len=args.min_match_len,
                    pvalue_scoring=args.pvalue_scoring,
                    report_all=args.report_all,
                    min_diff_frac=args.min_diff_frac,
                    min_score_frac=args.min_score_frac,
                    early_stop=args.early_stop)
    if not args.no_jax and index._has_fused_pml():
        results = [(name, cell, cols) for name, (_, cell, cols) in
                   index.query_multiclass(reads, ct, lanes=args.lanes,
                                          paired=_paired_force(args),
                                          device=device, **color_kw)]
    else:
        from .api import _color_needs_thresholds
        from .color import ColorEngine

        _color_needs_thresholds(ix)
        info("using the scalar ColorEngine")
        eng = ColorEngine(ix, ct, report_colors=report_colors, **color_kw)
        results = []
        for name, seq in reads:
            _, cell = eng.query_pml_multiclass(seq)
            results.append((name, cell, list(eng.last_colors)))
    lines = [f"{name},{cell}" for name, cell, _ in results]
    if report_colors and not args.no_output:
        cpath = f"{args.read}.{ix.mode}.colors"
        with open(cpath, "w") as f:
            for name, _, cols in results:
                f.write(f">{name}\n" + " ".join(map(str, reversed(cols)))
                        + "\n")
        info(f"wrote {cpath}")
    if args.lca_tree:
        from .lca import lca_postprocess, load_nodes_dmp

        lines = lca_postprocess(lines, load_nodes_dmp(args.lca_tree))
    if args.stdout:
        for ln in lines:
            print(ln)
        return
    if args.no_output:
        return
    out_path = args.out_file or f"{args.read}.{ix.mode}.multiclass.csv"
    with open(out_path, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    info(f"wrote {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="movi-tpu-torch",
        description="PyTorch/CUDA port of movi_tpu (index build; PML, SA "
                    "entries, ZML, count, k-mer, MEM and Movi Color "
                    "queries)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build")
    b.add_argument("--fasta", "-f", nargs="+", default=None)
    b.add_argument("--index", "-i", required=True)
    b.add_argument("--type", default="regular-thresholds")
    b.add_argument("--fw", action="store_true",
                   help="do not add reverse complements")
    b.add_argument("--separators", action="store_true")
    b.add_argument("--list", action="store_true")
    b.add_argument("--keep-ref", action="store_true")
    b.add_argument("--skip-null", action="store_true")
    b.add_argument("--bound-ff", type=int, default=None)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--sa-entries", action="store_true",
                   help="store the sampled suffix array (query --pml "
                        "--sa-entries)")
    b.add_argument("--sa-sample-rate", type=int, default=100)
    b.add_argument("--color", action="store_true")
    b.add_argument("--compress-colors", action="store_true")
    b.add_argument("--tree-compress-colors", action="store_true")
    # accepted so that asking for them says they are not yet ported
    for flag in _BUILD_NOT_PORTED:
        b.add_argument("--" + flag.replace("_", "-"), default=None,
                       nargs="?", const=True, help=argparse.SUPPRESS)
    b.set_defaults(func=cmd_build)

    q = sub.add_parser("query")
    q.add_argument("--index", "-i", required=True)
    q.add_argument("--read", "-r", required=True)
    for flag in _QUERIES + _KMER_QUERIES:
        q.add_argument("--" + flag.replace("_", "-"), action="store_true")
    q.add_argument("--k", type=int, default=31,
                   help="k-mer length (--kmer, --kmer-count)")
    q.add_argument("--ftab-k", type=int, default=0,
                   help="ftab anchor width for --kmer (0: 10, capped at "
                        "k - k/3) and --mem (0: 10, capped at L)")
    q.add_argument("--multi-ftab", action="store_true",
                   help="fall back to smaller-k ftabs when the largest "
                        "k-mer lookup fails (the scalar k-mer path)")
    q.add_argument("--mem", action="store_true",
                   help="maximal exact matches: BML with --min-mem-length "
                        ">= 2, all MEMs otherwise")
    q.add_argument("--min-mem-length", type=int, default=0)
    q.add_argument("--classify", action="store_true")
    q.add_argument("--sa-entries", action="store_true",
                   help="per-base SA entries (with --pml; the index needs "
                        "build --sa-entries)")
    q.add_argument("--multi-classify", action="store_true",
                   help="Movi Color multi-class classification (with "
                        "--pml)")
    q.add_argument("--min-match-len", "--min-len", type=int, default=0)
    q.add_argument("--pvalue-scoring", action="store_true")
    q.add_argument("--lca-tree", default="",
                   help="nodes.dmp for LCA post-processing of multi-class "
                        "calls")
    q.add_argument("--early-stop", action="store_true",
                   help="abort unclassified reads early (multi-classify)")
    q.add_argument("--report-all", action="store_true",
                   help="report every document within min-diff-frac / "
                        "min-score-frac of the best")
    q.add_argument("--min-diff-frac", type=float, default=0.05)
    q.add_argument("--min-score-frac", type=float, default=0.0)
    q.add_argument("--report-colors", action="store_true",
                   help="write per-base color ids to <reads>.<mode>.colors")
    q.add_argument("--report-color-ids", action="store_true")
    q.add_argument("--filter", action="store_true")
    q.add_argument("--invert", action="store_true")
    q.add_argument("--stdout", action="store_true")
    q.add_argument("--no-output", action="store_true",
                   help="write no output files")
    q.add_argument("--reverse", action="store_true")
    q.add_argument("--bin-width", type=int, default=150)
    q.add_argument("--out-file", "-o", default="")
    q.add_argument("--lanes", type=int, default=8192)
    q.add_argument("--no-jax", action="store_true",
                   help="use the scalar CPU reference engine (the name "
                        "is movi_tpu's)")
    q.add_argument("--rpml", action="store_true",
                   help="random repositioning PMLs (RPMLs), on the compact "
                        "engine")
    q.add_argument("--logs", action="store_true",
                   help="write .costs/.scans/.fastforwards trace files "
                        "(the scalar path)")
    q.add_argument("--no-resplit", action="store_true",
                   help="do not NT re-split a reference-format index at "
                        "load time (the compact engines run it)")
    q.add_argument("--platform", choices=["gpu", "cpu"], default="gpu",
                   help="gpu runs the CUDA kernels (the default; raises "
                        "without a card), cpu the plain PyTorch versions")
    q.add_argument("--paired-records", action="store_true",
                   help="force the paired two-base records")
    q.add_argument("--no-paired-records", action="store_true",
                   help="force the one-step records")
    q.add_argument("--ignore-illegal-chars", type=int, default=0,
                   choices=[0, 1, 2],
                   help="0=off, 1=replace with 'A', 2=replace with a "
                        "random base")
    q.set_defaults(func=cmd_query)

    args = p.parse_args(argv)
    if getattr(args, "filter", False):
        args.classify = True
    try:
        with timing(args.command):
            args.func(args)
    except (AssertionError, ValueError, FileNotFoundError, RuntimeError,
            NotImplementedError) as e:
        error(str(e))
        raise SystemExit(1)


if __name__ == "__main__":
    main()
