"""Engine selection for PML: the paired layout when it fits the device.

Port of the PML half of movi_tpu/engine/select.py.  The paired records
cost 16*(sigma+1)^2 B per run (400 B for DNA) against 8*(sigma+1) B per
run for the one-step layout.  The budget is the device's own memory
(device.memory_budget_bytes).  The JAX package's VMEM-residency rule is a
TPU measurement and is not carried over: no cache-residency rule has been
measured on the card, so a small index takes the paired layout here.
Outputs are identical either way.
"""

from __future__ import annotations

from typing import Optional

from ..device import DeviceLike, memory_budget_bytes
from .fused2 import MAX_RUNS

# leave room for the one-step records (the compose input) and the batches
BUDGET_FRACTION = 0.5


def paired_pml_table_bytes(r: int, sigma: int) -> int:
    return 16 * (sigma + 1) ** 2 * r


def one_step_pml_table_bytes(r: int, sigma: int) -> int:
    return 8 * (sigma + 1) * r


def use_paired_pml(r: int, sigma: int, force: Optional[bool] = None,
                   device: DeviceLike = None) -> bool:
    """True when PML should run on the paired two-base records."""
    if force is not None:
        return force
    return (r < MAX_RUNS and paired_pml_table_bytes(r, sigma)
            <= BUDGET_FRACTION * memory_budget_bytes(device))


def pick_backend(r: int, sigma: int, force_paired: Optional[bool] = None,
                 device: DeviceLike = None) -> str:
    """'paired' when the two-step layout fits, else 'one-step' when the
    one-step table fits, else 'compact' (not yet ported)."""
    if use_paired_pml(r, sigma, force=force_paired, device=device):
        return "paired"
    if (one_step_pml_table_bytes(r, sigma)
            <= BUDGET_FRACTION * memory_budget_bytes(device)):
        return "one-step"
    return "compact"
