"""movi_tpu_torch: the PyTorch and CUDA port of movi_tpu.

The PML, count and ZML query paths of movi_tpu (one-step and paired
step and search records, the paired-record composes, engine selection,
the API and the `query --pml/--count/--zml` CLI) on PyTorch, with each
device function as a hand-written CUDA kernel for Hopper (`csrc/`).  The JAX package `movi_tpu` is the reference: every
output here is bit-identical to it and to its scalar oracle.  The host
layers of `movi_tpu` that import no JAX (index build, I/O, classify, the
scalar oracle) are shared, not copied.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # lazy, like movi_tpu/__init__.py: importing the package builds nothing
    if name in ("Index", "build_index"):
        from .api import Index, build_index

        return {"Index": Index, "build_index": build_index}[name]
    raise AttributeError(name)
