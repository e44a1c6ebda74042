"""Multi-host deployment: byte-range read sharding, per-host querying,
cross-process counter reduction, and host-0 output merging.

Port of movi_tpu/parallel/multihost.py; the host helpers
`_find_record_start`, `byte_range_reads`, `merge_parts` and `bpf_header`
are copies of that module's.  The reference is single-process: OpenMP
threads share one BatchLoader under a critical section and write one
output file (movi.cpp:274-386).  Here every host runs the same program
under torch.distributed, parses only its own BYTE RANGE of the read file,
queries its card against the whole index, and writes its output shard.
The aggregate counters cross hosts through an all_gather of int64 CPU
tensors (gloo, whatever card runs the queries); host 0 then concatenates
the shards into the reference's single-file formats, byte-identical to a
1-host run.

Launch on each host (two hosts on one machine share its card):

    python -m movi_tpu_torch.parallel.multihost --coordinator host0:1234 \\
        --num-hosts 4 --host-id $ID --index idx --read reads.fastq --pml
"""

from __future__ import annotations

import argparse
import os
from typing import Iterator, List, Optional, Tuple


def initialize(coordinator: str, num_hosts: int, host_id: int):
    """Join the hosts' process group (gloo, for the host counters) at
    tcp://coordinator."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_hosts, rank=host_id)
    return dist


def _find_record_start(f, limit: int, fastq: bool) -> int:
    """Scan forward from the current position to the next record
    boundary: a '>' header line (FASTA), or an '@' header line whose
    second successor line starts with '+' (FASTQ; the lookahead
    disambiguates '@' inside quality strings)."""
    pos = f.tell()
    if pos == 0:
        return 0
    f.readline()  # finish the (possibly partial) current line
    while True:
        line_pos = f.tell()
        if line_pos >= limit:
            return limit
        line = f.readline()
        if not line:
            return limit
        if not fastq:
            if line.startswith(b">"):
                return line_pos
        elif line.startswith(b"@"):
            save = f.tell()
            f.readline()
            plus = f.readline()
            f.seek(save)
            if plus.startswith(b"+"):
                return line_pos


def byte_range_reads(path: str, num_hosts: int, host_id: int
                     ) -> Iterator[Tuple[str, bytes]]:
    """Parse only this host's byte range of a plain FASTA/FASTQ file.
    Ranges are [k*size/N, (k+1)*size/N) rounded to record boundaries, so
    concatenating the hosts' outputs in host order restores the file
    order.  Gzipped inputs cannot be byte-addressed: falls back to a
    CONTIGUOUS block of a full parse (every host decompresses, but the
    host-order merge still restores file order)."""
    if path.endswith(".gz"):
        from ..io.fastx import iter_fastx

        reads = list(iter_fastx(path))
        lo = len(reads) * host_id // num_hosts
        hi = len(reads) * (host_id + 1) // num_hosts
        yield from reads[lo:hi]
        return
    size = os.path.getsize(path)
    lo = size * host_id // num_hosts
    hi = size * (host_id + 1) // num_hosts
    with open(path, "rb") as f:
        head = f.read(1)
        fastq = head == b"@"
        f.seek(lo)
        start = _find_record_start(f, size, fastq)
        if host_id == num_hosts - 1:
            end = size
        else:
            f.seek(hi)
            end = _find_record_start(f, size, fastq)
        if start >= end:
            return
        f.seek(start)
        if fastq:
            while f.tell() < end:
                name = f.readline().rstrip()
                seq = f.readline().rstrip()
                f.readline()  # '+'
                f.readline()  # quality
                if name:
                    yield name[1:].split()[0].decode(), seq
        else:
            name = None
            seq_parts: List[bytes] = []
            while f.tell() < end:
                line = f.readline()
                if not line:
                    break
                if line.startswith(b">"):
                    if name is not None:
                        yield name, b"".join(seq_parts)
                    name = line[1:].rstrip().split()[0].decode()
                    seq_parts = []
                else:
                    seq_parts.append(line.rstrip())
            # the record spanning `end` belongs to this shard: finish it
            while True:
                line = f.readline()
                if not line or line.startswith(b">"):
                    break
                seq_parts.append(line.rstrip())
            if name is not None:
                yield name, b"".join(seq_parts)


def merged_counters(local) -> "np.ndarray":
    """Sum an int64 counter vector across all hosts (the cross-host
    analogue of the reference's `#pragma omp atomic` counters,
    read_processor.cpp:675-717): an all_gather of CPU tensors."""
    import numpy as np
    import torch
    import torch.distributed as dist

    t = torch.from_numpy(np.asarray(local, dtype=np.int64).copy())
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.stack(parts).sum(dim=0).numpy()


def barrier(name: str = "movi-multihost"):
    """Wait for every host (`name` labels the wait point, as the JAX
    package's sync_global_devices takes it)."""
    import torch.distributed as dist

    dist.barrier()


def merge_parts(out_path: str, part_paths: List[str],
                header: bytes = b"", cleanup: bool = True):
    """Concatenate per-host output shards (host order = file order under
    byte-range sharding) into the reference's single-file format."""
    with open(out_path, "wb") as out:
        out.write(header)
        for p in part_paths:
            with open(p, "rb") as f:
                while True:
                    chunk = f.read(1 << 20)
                    if not chunk:
                        break
                    out.write(chunk)
    if cleanup:
        for p in part_paths:
            os.remove(p)


def bpf_header(entry_size: int = 16) -> bytes:
    import struct

    from ..io.outputs import BPF_MAGIC, BPF_VERSION

    return struct.pack("<IBBBBH2x", BPF_MAGIC, *BPF_VERSION, entry_size, 0)


def run_sharded_query(index_dir: str, read_path: str, num_hosts: int,
                      host_id: int, qt: str = "pml", lanes: int = 8192,
                      classify: bool = False, bin_width: int = 150,
                      out_prefix: Optional[str] = None,
                      paired: Optional[bool] = None, k: int = 31,
                      min_mem_length: int = 0, device=None) -> dict:
    """One host's share of a distributed query on `device` (default: the
    card): PML/ZML (+ optional binary classification), count,
    multi-class, MEM finding, or exact k-mer counts.  Writes per-host
    output shards, reduces the aggregate counters across hosts, and
    merges on host 0.  Engine caches saved by Index.save are reused, and
    the paired layouts are chosen by capacity (engine/select.py) unless
    `paired` forces them.

    Returns {"found": ..., "total": ..., "out": path} on every host;
    multi-class adds "class_counts" (reads per species + unclassified,
    reduced across hosts)."""
    import numpy as np

    from ..api import Index
    from ..io.outputs import BPFWriter

    index = Index.load(index_dir)
    reads = list(byte_range_reads(read_path, num_hosts, host_id))
    prefix = out_prefix or f"{read_path}.{index.ix.mode}.{qt}"

    found = 0
    class_counts = None
    report_part = None
    if qt == "count":
        from ..io.outputs import count_line

        out = index.query_count(reads, lanes=lanes, paired=paired,
                                device=device)
        part = f"{prefix}.matches.part{host_id}"
        with open(part, "w") as f:
            for (name, (pos, cnt)), (_, seq) in zip(out, reads):
                f.write(count_line(name, len(seq), pos, cnt) + "\n")
        merged_name = prefix + ".matches"
        merged_header = b""
    elif qt == "mems":
        from ..io.outputs import mem_lines

        out = index.query_mems(reads, min_mem_length=min_mem_length,
                               lanes=lanes, device=device)
        part = f"{prefix}.mems.part{host_id}"
        with open(part, "w") as f:
            for name, mems in out:
                for ln in mem_lines(name, mems):
                    f.write(ln + "\n")
        merged_name = prefix + ".mems"
        merged_header = b""
    elif qt == "kmers":
        out = index.query_kmers(reads, k=k, counts=True, lanes=lanes,
                                paired=paired, device=device)
        part = f"{prefix}.kmers.part{host_id}"
        with open(part, "w") as f:
            for (name, (fk, total)), (_, seq) in zip(out, reads):
                # reads shorter than k have zero windows, not a negative
                # denominator
                nw = max(len(seq) - k + 1, 0)
                f.write(f"{name}\t{fk}/{nw}\t{total}\n")
        merged_name = f"{prefix}.kmers.{k}"
        merged_header = b""
    elif qt == "multiclass":
        from ..cli import _load_color_table

        ct = _load_color_table(index_dir, index.ix)
        out = index.multi_classify(reads, ct, lanes=lanes, device=device)
        part = f"{prefix}.multiclass.csv.part{host_id}"
        di = ct.doc_info
        tax2idx = {str(t): i for i, t in enumerate(di.to_taxon_id)}
        counts = np.zeros(di.num_species + 1, dtype=np.int64)
        with open(part, "w") as f:
            for name, cell in out:
                f.write(f"{name},{cell}\n")
                primary = cell.split(",")[0]
                counts[tax2idx.get(primary, di.num_species)] += 1
        class_counts = merged_counters(counts)
        merged_name = prefix + ".multiclass.csv"
        merged_header = b""
    else:
        out = (index.query_pml(reads, lanes=lanes, paired=paired,
                               device=device)
               if qt == "pml"
               else index.query_zml(reads, lanes=lanes, paired=paired,
                                    device=device))
        part = f"{prefix}.bpf.part{host_id}"
        with BPFWriter(part, write_header=False) as w:
            for name, pmls in out:
                w.write_read(name, pmls)
        merged_name = prefix + ".bpf"
        merged_header = bpf_header()

        if classify:
            from ..classify import (Classifier, EmpNullDatabase,
                                    format_report_line)

            db = EmpNullDatabase.load(
                os.path.join(index_dir, f"movi.{qt}.nulldb"))
            cls = Classifier(db, bin_width=bin_width)
            report_part = f"{prefix}.report.part{host_id}"
            with open(report_part, "w") as f:
                for name, pmls in out:
                    ok, avg, above, below = cls.classify(pmls)
                    found += int(ok)
                    f.write(format_report_line(name, ok, avg, above,
                                               below) + "\n")

    totals = merged_counters(np.array([found, len(out)]))
    barrier("movi-query-done")

    if host_id == 0:
        part_tpl = part[: -len(str(host_id))]
        merge_parts(merged_name,
                    [f"{part_tpl}{h}" for h in range(num_hosts)],
                    header=merged_header)
        if report_part is not None:
            from ..classify import format_report_header

            hdr = (format_report_header(cls.max_value_thr) + "\n").encode()
            merge_parts(prefix + ".report",
                        [f"{prefix}.report.part{h}"
                         for h in range(num_hosts)], header=hdr)
    barrier("movi-merge-done")
    res = {"found": int(totals[0]), "total": int(totals[1]),
           "out": merged_name}
    if class_counts is not None:
        res["class_counts"] = class_counts
    return res


def host_device(platform: str, host_id: int):
    """The device a host queries on: its card (host_id modulo the cards
    this machine has, so hosts on one machine with one card share it), or
    the CPU for --platform cpu."""
    if platform == "cpu":
        return "cpu"
    import torch

    from ..device import resolve_device

    resolve_device("cuda")  # raises without a card
    return f"cuda:{host_id % torch.cuda.device_count()}"


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True,
                   help="host:port of host 0's rendezvous")
    p.add_argument("--num-hosts", type=int, required=True)
    p.add_argument("--host-id", type=int, required=True)
    p.add_argument("--index", required=True)
    p.add_argument("--read", required=True)
    p.add_argument("--pml", action="store_true")
    p.add_argument("--zml", action="store_true")
    p.add_argument("--count", action="store_true")
    p.add_argument("--multi-classify", action="store_true")
    p.add_argument("--mems", action="store_true")
    p.add_argument("--kmers", action="store_true",
                   help="exact k-mer counts (see --k)")
    p.add_argument("--k", type=int, default=31)
    p.add_argument("--min-mem-length", type=int, default=0)
    p.add_argument("--classify", action="store_true")
    p.add_argument("--paired-records", action="store_true",
                   help="force the paired speed layouts (default: "
                        "capacity auto-selection)")
    p.add_argument("--no-paired-records", action="store_true")
    p.add_argument("--bin-width", type=int, default=150)
    p.add_argument("--lanes", type=int, default=32768)
    p.add_argument("--out-prefix", default=None)
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu",
                   help="query on the card (gpu, the default) or on the "
                        "CPU (cpu: the plain PyTorch versions)")
    args = p.parse_args(argv)

    device = host_device(args.platform, args.host_id)
    initialize(args.coordinator, args.num_hosts, args.host_id)
    qt = ("multiclass" if args.multi_classify else
          "mems" if args.mems else "kmers" if args.kmers else
          "count" if args.count else "zml" if args.zml else "pml")
    paired = (True if args.paired_records
              else False if args.no_paired_records else None)
    try:
        res = run_sharded_query(
            args.index, args.read, args.num_hosts, args.host_id,
            qt=qt, lanes=args.lanes,
            classify=args.classify, bin_width=args.bin_width,
            out_prefix=args.out_prefix, paired=paired, k=args.k,
            min_mem_length=args.min_mem_length, device=device)
    finally:
        import torch.distributed as dist

        dist.destroy_process_group()
    if args.host_id == 0:
        print(f"found {res['found']}/{res['total']} -> {res['out']}")


if __name__ == "__main__":
    main()
