"""The port's multi-host runtime (movi_tpu_torch/parallel/multihost.py):
byte-range read sharding against movi_tpu's reader, and real 1- and
2-process `python -m movi_tpu_torch.parallel.multihost --platform cpu`
runs (gloo) whose merged outputs are byte-identical to each other and to
what movi_tpu's Index answers for the same reads, on an index built by
the port's `build` from a synthetic FASTA."""

import gzip
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from movi_tpu.api import Index as JIndex
from movi_tpu.classify import (Classifier, EmpNullDatabase,
                               format_report_header, format_report_line)
from movi_tpu.io import outputs as jout
from movi_tpu.parallel import multihost as jmh
from movi_tpu_torch import cli as tcli
from movi_tpu_torch import testing
from movi_tpu_torch.parallel import multihost as tmh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mkreads(n, rng):
    return [(f"r{i}", "".join(rng.choice(list("ACGT"),
                                         size=int(rng.integers(40, 90)))))
            for i in range(n)]


def _write_fastq(path, reads):
    with open(path, "w") as f:
        for i, (name, seq) in enumerate(reads):
            # quality lines starting with '@' exercise the record-boundary
            # lookahead of _find_record_start
            q0 = "@" if i % 3 == 0 else "I"
            f.write(f"@{name}\n{seq}\n+\n{q0 * len(seq)}\n")


def _shards(reader, path, hosts):
    return [(n, s.decode()) for h in range(hosts)
            for n, s in reader(path, hosts, h)]


@pytest.mark.parametrize("hosts", [1, 2, 3, 4])
@pytest.mark.parametrize("form", ["fastq", "fasta", "gz"])
def test_byte_ranges_equal_movi_tpu(tmp_path, form, hosts):
    """FASTQ (with '@' quality lines), multi-line FASTA and gzipped FASTQ
    shard into the same reads, in file order, as movi_tpu's reader."""
    reads = _mkreads(23, np.random.default_rng(3 + hosts))
    path = str(tmp_path / {"fastq": "r.fastq", "fasta": "r.fa",
                           "gz": "r.fastq.gz"}[form])
    if form == "fastq":
        _write_fastq(path, reads)
    elif form == "fasta":
        with open(path, "w") as f:
            for name, seq in reads:
                f.write(f">{name}\n")
                for k in range(0, len(seq), 25):
                    f.write(seq[k:k + 25] + "\n")
    else:
        with gzip.open(path, "wt") as f:
            f.write("".join(f"@{n}\n{s}\n+\n{'I' * len(s)}\n"
                            for n, s in reads))
    got = _shards(tmh.byte_range_reads, path, hosts)
    assert got == reads
    assert got == _shards(jmh.byte_range_reads, path, hosts)
    for h in range(hosts):
        assert list(tmh.byte_range_reads(path, hosts, h)) == \
            list(jmh.byte_range_reads(path, hosts, h))


def test_merge_parts_and_header(tmp_path):
    parts = []
    for h in range(3):
        p = tmp_path / f"x.part{h}"
        p.write_bytes(bytes([h]) * (h + 5))
        parts.append(str(p))
    out = str(tmp_path / "x")
    tmh.merge_parts(out, parts, header=tmh.bpf_header())
    with open(out, "rb") as f:
        got = f.read()
    assert got == jmh.bpf_header() + b"".join(bytes([h]) * (h + 5)
                                               for h in range(3))
    assert not any(os.path.exists(p) for p in parts)
    assert tmh.bpf_header(32) == jmh.bpf_header(32)


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """A 2,500-base one-document FASTA indexed by the port's `build` (its
    reverse complement added, null statistics written), and 14 FASTQ
    reads from it, every other one with three substitutions."""
    d = tmp_path_factory.mktemp("multihost")
    rng = np.random.default_rng(23)
    doc = testing.random_text(2500, 23).tobytes().decode()
    fasta = str(d / "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">doc\n{doc}\n")
    idx = str(d / "idx")
    rc, _, err = testing.run_cli(tcli.main, ["build", "--fasta", fasta,
                                             "--index", idx])
    assert rc == 0, err
    reads = []
    for k in range(14):
        s = int(rng.integers(0, 2400))
        seq = list(doc[s:s + 70 + k])
        if k % 2:
            for pos in rng.integers(0, len(seq), size=3):
                seq[int(pos)] = "ACGT"[int(rng.integers(0, 4))]
        reads.append((f"r{k}", "".join(seq)))
    rpath = str(d / "reads.fastq")
    _write_fastq(rpath, reads)
    return d, idx, rpath, [(n, s.encode()) for n, s in reads]


def _run(d, idx, rpath, hosts, tag, flags):
    """`hosts` processes of the port's multihost runner; the merged
    output prefix."""
    prefix = str(d / tag)
    port = testing.free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "movi_tpu_torch.parallel.multihost",
         "--coordinator", f"127.0.0.1:{port}", "--num-hosts", str(hosts),
         "--host-id", str(h), "--index", idx, "--read", rpath, *flags,
         "--platform", "cpu", "--out-prefix", prefix],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for h in range(hosts)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return prefix


def _expected(idx, reads, kind, tmp):
    """The merged files of `kind` from movi_tpu's Index answers."""
    ix = JIndex.load(idx)
    if kind == "pml":
        out = ix.query_pml(reads, jax=False)
        path = str(tmp / "want.bpf")
        with jout.BPFWriter(path) as w:
            for name, pmls in out:
                w.write_read(name, pmls)
        with open(path, "rb") as f:
            bpf = f.read()
        cl = Classifier(EmpNullDatabase.load(os.path.join(
            idx, "movi.pml.nulldb")), bin_width=150)
        lines = [format_report_header(cl.max_value_thr)]
        for name, pmls in out:
            ok, avg, above, below = cl.classify(pmls)
            lines.append(format_report_line(name, ok, avg, above, below))
        return {".bpf": bpf, ".report": ("\n".join(lines) + "\n").encode()}
    if kind == "count":
        out = ix.query_count(reads, jax=False)
        return {".matches": "".join(
            jout.count_line(n, len(s), pos, cnt) + "\n"
            for (n, (pos, cnt)), (_, s) in zip(out, reads)).encode()}
    if kind == "mems":
        out = ix.query_mems(reads, min_mem_length=12, jax=False)
        return {".mems": "".join(ln + "\n" for n, mems in out
                                 for ln in jout.mem_lines(n, mems)).encode()}
    out = ix.query_kmers(reads, k=21, counts=True, jax=False)
    return {".kmers.21": "".join(
        f"{n}\t{fk}/{max(len(s) - 20, 0)}\t{tot}\n"
        for (n, (fk, tot)), (_, s) in zip(out, reads)).encode()}


KINDS = {"pml": ["--pml", "--classify"], "count": ["--count"],
         "mems": ["--mems", "--min-mem-length", "12"],
         "kmers": ["--kmers", "--k", "21"]}


@pytest.mark.parametrize("kind", list(KINDS))
def test_two_hosts_merge_like_one(built, kind):
    """1 and 2 hosts (processes joined over gloo) write byte-identical
    merged files, equal to movi_tpu's answers; host 0 removes the
    parts."""
    d, idx, rpath, reads = built
    with ThreadPoolExecutor(2) as pool:
        one, two = pool.map(
            lambda h: _run(d, idx, rpath, h, f"{kind}{h}", KINDS[kind]),
            (1, 2))
    want = _expected(idx, reads, kind, d)
    for suffix, body in want.items():
        with open(one + suffix, "rb") as f:
            b1 = f.read()
        with open(two + suffix, "rb") as f:
            b2 = f.read()
        assert b1 == b2 == body, suffix
        assert len(body.splitlines()) > 1
    assert not [p for p in os.listdir(d) if ".part" in p]
