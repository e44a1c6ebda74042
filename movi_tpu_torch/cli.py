"""movi_tpu_torch command-line interface: `query --pml`, `--zml`,
`--count` and `--pml --multi-classify` on the port.

    python -m movi_tpu_torch.cli query --index IDX --read READS \\
        (--pml | --zml | --count) [--classify | --filter [--invert]] \\
        [--stdout] [--platform cpu]
    python -m movi_tpu_torch.cli query --index IDX --read READS --pml \\
        --multi-classify [--early-stop] [--report-colors] [--report-all] \\
        [--lca-tree nodes.dmp] [--stdout] [--platform cpu]

Mirrors the PML, ZML, count and Movi Color branches of movi_tpu/cli.py
`query` (index and color-table loading, the classifier, the
stdout/BPF/.matches/report/.multiclass.csv/.colors writers, LCA
post-processing), sharing its host helpers; the record caches and the
layout choice are `api.Index`'s.  Indexes are built with
`python -m movi_tpu.cli build` (`--color` for the color table).  Other
query types (MEMs, k-mers), and indexes the fused engines cannot run (PML
or color without thresholds, or not built with bound_ff=1), are not yet
ported: asking for them is an error, never a fallback to another engine.
"""

from __future__ import annotations

import argparse
import os

from movi_tpu.cli import (_apply_ignore_illegal, _load_color_table,
                          _load_index, _paired_force)
from movi_tpu.commons import error, info, timing

_NOT_PORTED = ("mem", "kmer", "kmer_count")
_QUERIES = ("pml", "zml", "count")


class NotPortedError(NotImplementedError):
    pass


def cmd_query(args):
    from movi_tpu.io.fastx import iter_fastx
    from movi_tpu.io.outputs import BPFWriter, count_line, pml_stdout_lines

    from .api import Index
    from .device import resolve_device

    asked = [q for q in _NOT_PORTED if getattr(args, q)]
    if asked:
        raise NotPortedError(
            f"--{asked[0].replace('_', '-')} is not yet ported to "
            f"movi_tpu_torch (only --pml, --zml and --count)")
    qt = next((q for q in _QUERIES if getattr(args, q)), None)
    if qt is None:
        raise SystemExit("specify one of --pml/--zml/--count")
    device = resolve_device("cuda" if args.platform == "gpu" else "cpu")

    ix = _load_index(args.index)
    reads = list(iter_fastx(args.read))
    if args.reverse:
        reads = [(n, s[::-1]) for n, s in reads]
    if args.ignore_illegal_chars:
        # host-side substitution before batching, drawn in the scalar
        # engine's order so the output equals ScalarEngine's
        reads = _apply_ignore_illegal(ix, reads, args.ignore_illegal_chars)

    index = Index.load(args.index, ix=ix)
    if args.multi_classify:
        multi_classify(args, ix, index, reads, device)
        return
    query = {"pml": index.query_pml, "zml": index.query_zml,
             "count": index.query_count}[qt]
    results = query(reads, lanes=args.lanes, paired=_paired_force(args),
                    device=device)

    classifier = None
    report_lines = []
    found_list = []  # positional, aligned with reads/results
    if args.classify:
        from movi_tpu.classify import (Classifier, EmpNullDatabase,
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
            from movi_tpu.classify import format_report_line

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
        else:
            rpath = f"{args.read}.{ix.mode}.{qt}.report"
            with open(rpath, "w") as f:
                for ln in report_lines:
                    f.write(ln + "\n")
            info(f"wrote {rpath}")


def multi_classify(args, ix, index, reads, device):
    """The --multi-classify branch: the CSV of per-read calls (or stdout),
    the .colors file with --report-colors, LCA post-processing."""
    ct = _load_color_table(args.index, ix)
    report_colors = args.report_colors or args.report_color_ids
    results = index.query_multiclass(
        reads, ct, lanes=args.lanes, paired=_paired_force(args),
        device=device, min_match_len=args.min_match_len,
        pvalue_scoring=args.pvalue_scoring, report_all=args.report_all,
        min_diff_frac=args.min_diff_frac, min_score_frac=args.min_score_frac,
        early_stop=args.early_stop)
    lines = [f"{name},{cell}" for name, (_, cell, _) in results]
    if report_colors:
        cpath = f"{args.read}.{ix.mode}.colors"
        with open(cpath, "w") as f:
            for name, (_, _, cols) in results:
                f.write(f">{name}\n" + " ".join(map(str, reversed(cols)))
                        + "\n")
        info(f"wrote {cpath}")
    if args.lca_tree:
        from movi_tpu.lca import lca_postprocess, load_nodes_dmp

        lines = lca_postprocess(lines, load_nodes_dmp(args.lca_tree))
    if args.stdout:
        for ln in lines:
            print(ln)
        return
    out_path = args.out_file or f"{args.read}.{ix.mode}.multiclass.csv"
    with open(out_path, "w") as f:
        for ln in lines:
            f.write(ln + "\n")
    info(f"wrote {out_path}")


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="movi-tpu-torch",
        description="PyTorch/CUDA port of movi_tpu (PML, ZML, count and "
                    "Movi Color queries)")
    sub = p.add_subparsers(dest="command", required=True)

    q = sub.add_parser("query")
    q.add_argument("--index", "-i", required=True)
    q.add_argument("--read", "-r", required=True)
    for flag in _QUERIES:
        q.add_argument("--" + flag, action="store_true")
    # accepted so that asking for them says they are not yet ported
    for flag in _NOT_PORTED:
        q.add_argument("--" + flag.replace("_", "-"), action="store_true",
                       help=argparse.SUPPRESS)
    q.add_argument("--classify", action="store_true")
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
    q.add_argument("--reverse", action="store_true")
    q.add_argument("--bin-width", type=int, default=150)
    q.add_argument("--out-file", "-o", default="")
    q.add_argument("--lanes", type=int, default=8192)
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
    if args.filter:
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
