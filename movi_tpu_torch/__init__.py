"""movi_tpu_torch: the PyTorch and CUDA port of movi_tpu.

The index build and the PML, count, ZML, SA-entries, k-mer and Movi Color
query paths of movi_tpu (one-step and paired records, the paired-record
composes, engine selection, the API and the `build`/`query` CLI) on
PyTorch, with each device function as a hand-written CUDA kernel for
Hopper (`csrc/`).  The JAX package `movi_tpu` is the reference: every
output here is bit-identical to it and to its scalar oracles.  The port
keeps its own copies of the host layers it needs (index build, I/O,
classify, the scalar oracles) and imports nothing of movi_tpu or JAX.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like movi_tpu/__init__.py: importing the package builds nothing
    if name in ("Index", "build_index"):
        from .api import Index, build_index

        return {"Index": Index, "build_index": build_index}[name]
    raise AttributeError(name)
