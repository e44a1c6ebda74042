"""Engine selection: the paired layout when it fits the device.

Port of movi_tpu/engine/select.py.  For PML the paired records cost
16*(sigma+1)^2 B per run (400 B for DNA) against 8*(sigma+1) B per run for
the one-step layout; for count/ZML ("search") 48*sigma^2 B per run (768 B)
against 32*sigma B per run; for Movi Color ("color") 32*(sigma+1)^2 B per
run (800 B) against 12*(sigma+1) B per run, and the paired color records
also need the kept doc sets to fit 16-bit color ids.  The budget is the device's own memory
(device.memory_budget_bytes).  The JAX package's VMEM-residency rule is a
TPU measurement and is not carried over: no cache-residency rule has been
measured on the card, so a small index takes the paired layout here.
Outputs are identical either way.

Past both tables, PML, count and ZML take the compact engines
(engine/pml.py, engine/search.py) on the run tables, whose bytes
compact_pml_table_bytes and compact_search_table_bytes give.  For PML
these cost 13 + 12*sigma B per run (61 for DNA), more than the one-step
records' 8*(sigma+1) (40): the rung adds no capacity for PML.  For count
and ZML they cost 16 + 8*sigma B per run (48) against 32*sigma (128).
"""

from __future__ import annotations

from typing import Optional

from ..device import DeviceLike, memory_budget_bytes
from .fused2 import MAX_RUNS
from .fused_color import MAX_PACKED_COLORS
from .fused_search2 import MAX_RUNS as SEARCH2_MAX_RUNS
from .fused_search2 import MAX_SIGMA as SEARCH2_MAX_SIGMA

# leave room for the one-step records (the compose input) and the batches
BUDGET_FRACTION = 0.5


def paired_pml_table_bytes(r: int, sigma: int) -> int:
    return 16 * (sigma + 1) ** 2 * r


def one_step_pml_table_bytes(r: int, sigma: int) -> int:
    return 8 * (sigma + 1) * r


def paired_search_table_bytes(r: int, sigma: int) -> int:
    return 2 * 24 * sigma * sigma * r


def one_step_search_table_bytes(r: int, sigma: int) -> int:
    return 32 * sigma * r


def paired_color_table_bytes(r: int, sigma: int) -> int:
    return 2 * paired_pml_table_bytes(r, sigma)


def one_step_color_table_bytes(r: int, sigma: int) -> int:
    return 12 * (sigma + 1) * r


def compact_pml_table_bytes(r: int, sigma: int) -> int:
    """n, lf_abs, c, thr_full, rep_up and rep_down per run, and all_p."""
    return (4 + 4 + 1 + 3 * 4 * sigma) * r + 4 * (r + 1)


def compact_search_table_bytes(r: int, sigma: int) -> int:
    """n, lf_abs, c_search, ch_up_s and ch_down_s per run, all_p, and the
    first/last run tables."""
    return (4 + 4 + 4 + 2 * 4 * sigma) * r + 4 * (r + 1) + 16 * (sigma + 1)


def _fits(nbytes: int, device: DeviceLike) -> bool:
    return nbytes <= BUDGET_FRACTION * memory_budget_bytes(device)


def use_paired_pml(r: int, sigma: int, force: Optional[bool] = None,
                   device: DeviceLike = None) -> bool:
    """True when PML should run on the paired two-base records."""
    if force is not None:
        return force
    return r < MAX_RUNS and _fits(paired_pml_table_bytes(r, sigma), device)


def use_paired_search(r: int, sigma: int, force: Optional[bool] = None,
                      device: DeviceLike = None) -> bool:
    """True when count/ZML should run on the paired search records."""
    if force is not None:
        return force
    return (r < SEARCH2_MAX_RUNS and sigma <= SEARCH2_MAX_SIGMA
            and _fits(paired_search_table_bytes(r, sigma), device))


def use_paired_color(r: int, sigma: int, num_sets: int,
                     force: Optional[bool] = None,
                     device: DeviceLike = None) -> bool:
    """True when Movi Color should run on the paired 32 B records, which
    also need num_sets + 1 (the sentinel) to fit 16 bits; a forced
    paired layout that cannot hold the color ids gives the one-step
    engine."""
    if force is not None:
        return force and num_sets + 1 <= MAX_PACKED_COLORS
    return (r < MAX_RUNS and num_sets + 1 <= MAX_PACKED_COLORS
            and _fits(paired_color_table_bytes(r, sigma), device))


def pick_backend(r: int, sigma: int, kind: str = "pml",
                 force_paired: Optional[bool] = None,
                 device: DeviceLike = None, num_sets: int = 0) -> str:
    """'paired' when the two-step layout of `kind` ("pml", "search" or
    "color", which takes the kept doc-set count num_sets) fits, else
    'one-step' when the one-step table fits, else 'compact': the compact
    engine on the run tables for PML, count and ZML (as movi_tpu/cli.py
    routes it), the one-step layout for color and k-mers (as the JAX
    package runs them)."""
    if kind == "pml":
        paired = use_paired_pml(r, sigma, force_paired, device)
        one_step = one_step_pml_table_bytes(r, sigma)
    elif kind == "search":
        paired = use_paired_search(r, sigma, force_paired, device)
        one_step = one_step_search_table_bytes(r, sigma)
    elif kind == "color":
        paired = use_paired_color(r, sigma, num_sets, force_paired, device)
        one_step = one_step_color_table_bytes(r, sigma)
    else:
        raise ValueError(f"unknown query kind {kind!r}")
    if paired:
        return "paired"
    if _fits(one_step, device):
        return "one-step"
    return "compact"
