"""The MEM v1 route of the port's entry points against the JAX package's,
on the CPU.  With MEM2_MAX_N lowered below the index's length in both
packages (as a pangenome past 2^28 positions would be), Index.query_mems,
Index.mem_engine and `query --mem` (run in this process) take the v1
machines in both, equal each other byte for byte and equal the v2 route's
answers; `--ftab-k` is ignored on that route, as in movi_tpu."""

import os

import numpy as np
import pytest

from movi_tpu import api as japi
from movi_tpu import cli as jcli
from movi_tpu.engine import fused_mem2 as jm2
from movi_tpu_torch import api as tapi
from movi_tpu_torch import cli as tcli
from movi_tpu_torch.engine import fused_mem as tfm
from movi_tpu_torch.engine import fused_mem2 as tm2
from movi_tpu_torch.index.structure import MoveIndex
from movi_tpu_torch.testing import mixed_reads, random_text, run_cli

V1_LOG = "using the fused MEM engine (v1, large-n)"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """`movi_tpu_torch.cli build` of one 2,500-base document (its reverse
    complement added), and reads from it: 30 short ones with N's and
    three of 300 bases, as a FASTA."""
    d = str(tmp_path_factory.mktemp("mem1_cli"))
    doc = random_text(2500, 23)
    fasta = os.path.join(d, "ref.fa")
    with open(fasta, "w") as f:
        f.write(f">doc\n{doc.tobytes().decode()}\n")
    idx = os.path.join(d, "idx")
    tcli.main(["build", "--fasta", fasta, "--index", idx, "--skip-null"])
    reads = mixed_reads(doc, seed=31, count=30)
    rng = np.random.default_rng(32)
    for i in range(3):
        s = int(rng.integers(0, len(doc) - 300))
        seq = doc[s:s + 300].copy()
        seq[rng.integers(0, 300, size=3)] = ord("N")
        reads.append((f"long{i}", seq.tobytes()))
    rpath = os.path.join(d, "reads.fa")
    with open(rpath, "w") as f:
        f.writelines(f">{n}\n{s.decode()}\n" for n, s in reads)
    ix = MoveIndex.load(os.path.join(idx, "index.npz"))
    return dict(d=d, idx=idx, reads=rpath, read_list=reads, ix=ix)


def _lower_cap(monkeypatch, ix):
    n = int(ix.all_p[-1])
    monkeypatch.setattr(jm2, "MEM2_MAX_N", n - 1)
    monkeypatch.setattr(tm2, "MEM2_MAX_N", n - 1)


@pytest.mark.parametrize("L", [0, 12, 20])
def test_api_v1_route_equals_jax(built, monkeypatch, L):
    """Index.query_mems past the cap: the v1 engines in both packages
    (the JAX Index builds its v1 table, the port's mem_engine returns a
    v1 engine), equal answers, equal to the v2 route's."""
    ix, reads = built["ix"], built["read_list"]
    v2 = tapi.Index(ix).query_mems(reads, min_mem_length=L, lanes=16,
                                   device="cpu")
    _lower_cap(monkeypatch, ix)
    jindex = japi.Index(ix)
    want = jindex.query_mems(reads, min_mem_length=L, lanes=16)
    assert jindex._fused_mem is not None and jindex._fused_mem2 is None
    index = tapi.Index(ix)
    eng = index.mem_engine(L, "cpu")
    assert isinstance(eng, tfm.FusedMemEngine if L else
                      tfm.FusedAllMemEngine)
    assert index._mem2 is None and index._mem1.pos2rba is not None
    got = index.query_mems(reads, min_mem_length=L, lanes=16, device="cpu")
    assert got == want == v2
    assert sum(len(m) for _, m in got) > 0


def _both_clis(built, flags):
    """(JAX's output and log, the port's output and log) of `query` with
    flags: the .mems file, or stdout with --stdout."""
    out = f"{built['reads']}.regular-thresholds.mems"
    res = []
    for main in (jcli.main, tcli.main):
        if os.path.exists(out):
            os.unlink(out)
        rc, stdout, err = run_cli(main, ["query", "--index", built["idx"],
                                         "--read", built["reads"], *flags,
                                         "--platform", "cpu"])
        assert rc == 0, err
        if "--stdout" in flags:
            res.append(stdout)
        else:
            with open(out) as f:
                res.append(f.read())
        res.append(err)
    return res


@pytest.mark.parametrize("flags", [
    ["--mem", "--min-mem-length", "12"],
    ["--mem"],
    ["--mem", "--min-mem-length", "12", "--ftab-k", "6", "--stdout"]])
def test_cli_v1_route_equals_jax(built, monkeypatch, flags):
    """`query --mem` past the cap: both CLIs log the v1 engine and write
    the same lines, which equal their v2 route's."""
    v2, _, tv2, v2_log = _both_clis(built, flags)
    assert V1_LOG not in v2_log and tv2 == v2
    _lower_cap(monkeypatch, built["ix"])
    want, jlog, got, log = _both_clis(built, flags)
    assert V1_LOG in jlog and V1_LOG in log
    assert got == want == v2
    lines = got.splitlines()
    assert lines and all(len(ln.split("\t")) == 4 for ln in lines)


def test_cli_v1_ignores_ftab_k(built, monkeypatch):
    """On the v1 route --ftab-k changes nothing (it sizes the v2 table's
    anchors, and the v1 machines have none), in both CLIs."""
    _lower_cap(monkeypatch, built["ix"])
    base = ["--mem", "--min-mem-length", "8", "--stdout"]
    want, _, got, log = _both_clis(built, base)
    for fk in ("4", "10"):
        jout, _, tout, _ = _both_clis(built, base + ["--ftab-k", fk])
        assert jout == want and tout == got == want
    assert V1_LOG in log and "ftab" not in log
