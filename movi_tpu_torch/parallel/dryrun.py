"""A dry run of the whole multi-device runtime on one rank of a mesh.

Port of __graft_entry__.py:50 `dryrun_multichip`: the same steps on the
port's engines, run once per rank (every rank of an n-rank process group
calls `dryrun_multichip(n)`; one rank needs no process group).  PML with
on-device classification, one-step and paired; count and ZML, one-step
and paired; Movi Color; exact k-mer counts; MEMs (BML, and all-MEMs,
whose entry state kernel 13c builds); the model-sharded PML, count and
ZML scans on a (2, n/2) mesh (or (1, n) for odd n) against the
data-parallel ones; 1,400-1,535-base reads through the PML, count, ZML
and MEM engines, one lane held to ScalarEngine; and the multi-host merge
of headerless BPF parts.  Raises on any disagreement; returns the shapes
it checked.

    python -m movi_tpu_torch.parallel.dryrun [--platform cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
from typing import Optional

import numpy as np

from ..device import DeviceLike


def dryrun_multichip(n_devices: int, device: DeviceLike = None,
                     backend: Optional[str] = None) -> dict:
    """The dry run on this rank of an n_devices-rank 'data' mesh."""
    import torch

    from ..build.suffix import build_bwt_runs
    from ..color import DocumentInfo, build_color_table
    from ..cpu_ref.scalar import ScalarEngine
    from ..engine.fused import build_fused_index
    from ..engine.fused_color import build_fused_color_index
    from ..engine.fused_mem import build_fused_mem_index
    from ..engine.fused_search import build_fused_search_index
    from ..engine.fused_search2 import build_fused_search2_index
    from ..index.structure import build_move_index
    from ..io.outputs import BPFWriter, read_bpf
    from ..testing import kmer_window_columns, right_aligned
    from . import make_2d_mesh, make_mesh
    from .mesh import (ShardedColorEngine, ShardedKmerEngine,
                       ShardedMemEngine, ShardedPMLEngine,
                       ShardedSearchEngine)
    from .multihost import bpf_header, merge_parts
    from .sharded_index import (close_tables, sharded_fused_count,
                                sharded_fused_pml, sharded_fused_zml)

    def host(t):
        return t.cpu().numpy()

    def require(ok: bool, what: str):
        if not ok:
            raise AssertionError(f"dry run: {what}")

    mesh = make_mesh(n_devices, device, backend)
    dev = mesh.device
    rng = np.random.default_rng(0)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    text = rng.choice(bases, size=3000).astype(np.uint8)
    ix = build_move_index(build_bwt_runs(text), "regular-thresholds",
                          bound_ff=1)
    fi = build_fused_index(ix)
    lanes, W = 8 * n_devices, 24
    seqs, lengths, _ = right_aligned(rng, text, lanes, W, 8)

    eng = ShardedPMLEngine(fi, mesh=mesh, bin_width=8, max_value_thr=4)
    ml, found, above, below = eng.query_batch_device(seqs, lengths)
    require(tuple(ml.shape) == (W, lanes // n_devices), "ml shard shape")
    ml_all = host(eng.gather(ml, 1))
    found_all = host(eng.gather(found, 0))
    # the paired-record (two bases per load) scan
    eng2 = ShardedPMLEngine(fi, mesh=mesh, bin_width=8, max_value_thr=4,
                            paired=True)
    ml2, found2, _, _ = eng2.query_batch_device(seqs, lengths)
    require(np.array_equal(host(eng2.gather(ml2, 1)), ml_all)
            and np.array_equal(host(eng2.gather(found2, 0)), found_all),
            "paired PML disagrees with one-step")

    # count/ZML, one-step and paired, and Movi Color over the same mesh
    si = build_fused_search_index(ix)
    se = ShardedSearchEngine(si, mesh=mesh)
    matched, count = (host(se.gather(t, 0))
                      for t in se.count_batch_device(seqs, lengths))
    zml = host(se.gather(se.zml_batch_device(seqs, lengths), 1))
    se2 = ShardedSearchEngine(build_fused_search2_index(ix, dev), mesh=mesh,
                              paired=True)
    matched2, count2 = (host(se2.gather(t, 0))
                        for t in se2.count_batch_device(seqs, lengths))
    require(np.array_equal(matched2, matched)
            and np.array_equal(count2, count), "paired count disagrees")
    require(np.array_equal(host(se2.gather(se2.zml_batch_device(
        seqs, lengths), 1)), zml), "paired ZML disagrees")
    ct = build_color_table(ix, build_bwt_runs(text).sa,
                           DocumentInfo.create([len(text)]))
    ce = ShardedColorEngine(build_fused_color_index(ix, ct, fi=fi), mesh=mesh)
    cml, ccol = (host(ce.gather(t, 1)) for t in ce.query_batch_device(seqs))
    require(np.array_equal(cml, ml_all), "color ml disagrees with PML")

    # exact k-mer counts: one lane per window, windows padded to the mesh
    k = 6
    wins, _ = kmer_window_columns(seqs, lengths, si.alphamap_query, k,
                                  n_devices)
    ke = ShardedKmerEngine(si, k, mesh=mesh)
    kfound, kcnt = (host(ke.gather(t, 0))
                    for t in ke.count_windows_device(wins))
    require(kcnt.shape == (wins.shape[1],), "k-mer count shape")

    # MEMs: BML, and all-MEMs (kernel 13c builds each lane's entry state)
    mi = build_fused_mem_index(ix, dev)
    mem_ends = {}
    for L in (10, 0):
        st = ShardedMemEngine(mi, min_mem_length=L, mesh=mesh) \
            .query_batch_device(seqs, lengths)
        mem_ends[L] = host(mesh.gather(st["ends"], 0))
        require(mem_ends[L].shape == (lanes, W), "MEM ends shape")

    # the model-sharded record tables (capacity mode) against the
    # data-parallel scans
    mesh2 = (make_2d_mesh(2, n_devices // 2, device, backend)
             if n_devices % 2 == 0 else make_2d_mesh(1, n_devices, device,
                                                     backend))
    alphas_t = fi.alphamap_query[seqs[:, ::-1]].T.astype(np.int32)
    ml_sh = host(mesh2.gather(sharded_fused_pml(mesh2, fi, alphas_t), 1))
    require(np.array_equal(ml_sh, ml_all),
            "model-sharded PML disagrees with the replicated scan")
    amap = si.alphamap_query
    al_s = np.full((lanes, W), -2, dtype=np.int32)
    for i in range(lanes):
        al_s[i, :lengths[i]] = amap[seqs[i, W - lengths[i]:]][::-1]
    m_sh, c_sh = (host(mesh2.gather(t, 0))
                  for t in sharded_fused_count(mesh2, si, al_s.T))
    require(np.array_equal(m_sh, matched) and np.array_equal(c_sh, count),
            "model-sharded count disagrees")
    z_sh = host(mesh2.gather(sharded_fused_zml(mesh2, si, al_s.T), 1))
    require(np.array_equal(z_sh, zml), "model-sharded ZML disagrees")
    close_tables(mesh2)

    # long reads through the data-parallel PML, count, ZML and MEM engines
    WL = 1536
    text_l = rng.choice(bases, size=8000).astype(np.uint8)
    ix_l = build_move_index(build_bwt_runs(text_l), "regular-thresholds",
                            bound_ff=1)
    seqs_l, lens_l, _ = right_aligned(rng, text_l, lanes, WL, 1400)
    ml_l = host(mesh.gather(ShardedPMLEngine(
        build_fused_index(ix_l), mesh=mesh, bin_width=150,
        max_value_thr=4).query_batch_device(seqs_l, lens_l)[0], 1))
    se_l = ShardedSearchEngine(build_fused_search_index(ix_l), mesh=mesh)
    matched_l, count_l = (host(se_l.gather(t, 0))
                          for t in se_l.count_batch_device(seqs_l, lens_l))
    se_l.zml_batch_device(seqs_l, lens_l)
    sc_l = ScalarEngine(ix_l)
    seq0 = seqs_l[0, WL - lens_l[0]:].tobytes()
    require(ml_l[:lens_l[0], 0].tolist() == sc_l.query_pml(seq0),
            "long-read PML differs from ScalarEngine")
    pos0, cnt0 = sc_l.query_count(seq0)
    require((int(lens_l[0]) - int(matched_l[0]), int(count_l[0]))
            == (pos0, cnt0), "long-read count differs from ScalarEngine")
    mem_l = ShardedMemEngine(build_fused_mem_index(ix_l, dev),
                             min_mem_length=20, mesh=mesh) \
        .query_batch_device(seqs_l[:n_devices], lens_l[:n_devices])

    # the multi-host output merge: headerless BPF parts under one header
    back = None
    if mesh.d == 0 and mesh.m == 0:
        with tempfile.TemporaryDirectory() as td:
            parts = []
            half = lanes // 2
            for h, sl in enumerate((slice(0, half), slice(half, lanes))):
                part = os.path.join(td, f"out.bpf.part{h}")
                with BPFWriter(part, write_header=False) as w:
                    for i in range(sl.start, sl.stop):
                        w.write_read(f"r{i}",
                                     ml_all[W - lengths[i]:, i].tolist())
                parts.append(part)
            merged = os.path.join(td, "out.bpf")
            merge_parts(merged, parts, header=bpf_header())
            back = read_bpf(merged)
        require(len(back) == lanes and back[0][0] == "r0", "BPF merge")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return dict(devices=n_devices, ml=ml_all.shape, found=int(found_all.sum()),
                zml=zml.shape, color=ccol.shape, kmer=kcnt.shape,
                mem_ends={L: e.shape for L, e in mem_ends.items()},
                model_sharded=(mesh2.data, mesh2.model),
                long_reads=(WL, tuple(mem_l["ends"].shape)),
                merged_bpf_reads=None if back is None else len(back))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--platform", choices=("gpu", "cpu"), default="gpu")
    args = p.parse_args(argv)
    print("dryrun_multichip OK:",
          dryrun_multichip(1, "cuda" if args.platform == "gpu" else "cpu"))


if __name__ == "__main__":
    main()
