"""The port's Index takes the parameters of movi_tpu's: Index(ix,
bwt_runs=runs) is valid in both, and Index.build keeps the runs it built,
as movi_tpu's does (no query reads them)."""

import inspect

import numpy as np

from movi_tpu import api as japi
from movi_tpu_torch import api as tapi
from movi_tpu_torch.build.suffix import build_bwt_runs
from movi_tpu_torch.index.structure import build_move_index
from movi_tpu_torch.testing import random_text, write_fasta


def _params(fn):
    return [(p.name, p.kind, p.default)
            for p in inspect.signature(fn).parameters.values()]


def test_constructors_take_the_same_parameters():
    assert _params(tapi.Index.__init__) == _params(japi.Index.__init__)
    assert _params(tapi.Index.build) == _params(japi.Index.build)


def test_index_keeps_the_runs_it_is_given():
    text = random_text(800, 21)
    runs = build_bwt_runs(text)
    ix = build_move_index(runs, "regular-thresholds", bound_ff=1)
    assert tapi.Index(ix, bwt_runs=runs)._runs is runs
    assert tapi.Index(ix)._runs is None
    assert japi.Index(ix, bwt_runs=runs)._runs is runs


def test_build_keeps_the_runs(tmp_path):
    """Index.build passes the runs it built, equal to those of movi_tpu's
    Index.build on the same FASTA, and the queries answer alike."""
    text = random_text(1200, 22)
    fasta = str(tmp_path / "ref.fa")
    write_fasta(fasta, [("doc", text.tobytes())])
    index = tapi.Index.build(fasta)
    jindex = japi.Index.build(fasta)
    runs, jruns = index._runs, jindex._runs
    assert runs is not None
    for f in ("bwt", "heads", "lens", "starts", "thresholds"):
        assert np.array_equal(getattr(runs, f), getattr(jruns, f)), f
    reads = [("r", text[100:180].tobytes())]
    assert index.query_pml(reads, device="cpu") == jindex.query_pml(reads)
