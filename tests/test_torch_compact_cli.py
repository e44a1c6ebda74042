"""The port's CLI on the compact engines against movi_tpu's, on the CPU:
`query --pml`, `--pml --rpml`, `--count` and `--zml --classify` on a
`build --type regular` index (no thresholds) and on a thresholds index not
built with bound_ff=1, and `--no-resplit` on an index.movi, byte for byte.
Both CLIs run in this process (their `main`), so each case pays no
interpreter start-up and the JAX scans compile once per shape."""

import os
import shutil

import pytest

from movi_tpu import cli as jcli
from movi_tpu_torch import cli as tcli
from movi_tpu_torch.index.movi_format import write_movi
from movi_tpu_torch.testing import cli_inputs, run_cli, unsplit_index


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("compact_cli"))
    fasta, rpath, _ = cli_inputs(d)
    thr = os.path.join(d, "thr")
    tcli.main(["build", "--fasta", fasta, "--index", thr])
    regular = os.path.join(d, "regular")
    tcli.main(["build", "--fasta", fasta, "--index", regular, "--type",
               "regular", "--skip-null"])
    unbounded = os.path.join(d, "unbounded")
    os.makedirs(unbounded)
    ix, _, _ = unsplit_index(fasta)
    ix.save(os.path.join(unbounded, "index.npz"))
    movi = os.path.join(d, "movi")
    os.makedirs(movi)
    write_movi(ix, os.path.join(movi, "index.movi"))
    # --classify reads the null database; both CLIs read the same file
    for dst in (regular, unbounded):
        for db in ("movi.pml.nulldb", "movi.zml.nulldb"):
            shutil.copy(os.path.join(thr, db), dst)
    return dict(d=d, reads=rpath, regular=(regular, "regular"),
                unbounded=(unbounded, "regular-thresholds"),
                movi=(movi, "regular-thresholds"))


def both(data, where, flags, outputs):
    """Run `query` through both CLIs; return (JAX's texts, the port's, the
    port's log): stdout and the files of `outputs`."""
    idx, mode = data[where]
    out = os.path.join(data["d"], "out")
    paths = [p.format(out=out, read=data["reads"], mode=mode)
             for p in outputs]
    texts = []
    for main in (jcli.main, tcli.main):
        for p in paths:
            if os.path.exists(p):
                os.unlink(p)
        rc, stdout, err = run_cli(main, ["query", "--index", idx, "--read",
                                         data["reads"], *flags, "--out-file",
                                         out, "--platform", "cpu"])
        assert rc == 0, err
        files = []
        for p in paths:
            with open(p, "rb") as f:
                files.append(f.read())
        texts.append((stdout, files))
    return texts[0], texts[1], err


QUERIES = [
    pytest.param(["--pml", "--stdout"], [], id="pml"),
    pytest.param(["--pml", "--rpml", "--stdout"], [], id="rpml"),
    pytest.param(["--count"], ["{out}.count.matches"], id="count"),
    pytest.param(["--zml", "--classify"], ["{read}.{mode}.zml.report"],
                 id="zml-classify")]


@pytest.mark.parametrize("flags,outputs", QUERIES)
@pytest.mark.parametrize("where", ["regular", "unbounded"])
def test_compact_queries_equal_jax(data, where, flags, outputs):
    want, got, log = both(data, where, flags, outputs)
    assert got == want
    assert want[0] or all(want[1])
    assert "using the compact" in log
    # without thresholds PML repositions at random, as --rpml asks
    random_rep = "--pml" in flags and ("--rpml" in flags
                                       or where == "regular")
    assert ("random repositioning" in log) == random_rep


@pytest.mark.parametrize("flags,route", [
    (["--pml", "--stdout", "--no-resplit"], "using the compact pml"),
    (["--zml", "--stdout", "--no-resplit"], "using the compact zml"),
    (["--pml", "--stdout"], "re-split")])
def test_no_resplit_equals_jax(data, flags, route):
    """index.movi (written by the port's write_movi, no NT splitting)
    with --no-resplit keeps its rows and runs the compact engines; without
    it the rows are re-split for the records."""
    want, got, log = both(data, "movi", flags, [])
    assert got == want
    assert len(want[0].splitlines()) == 2 * 33
    assert route in log
