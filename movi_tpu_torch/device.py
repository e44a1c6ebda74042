"""Device resolution and the memory budget, with no silent fallback.

Every entry point takes a `torch.device` (or its name) and defaults to
CUDA.  Without a card, asking for CUDA raises: a run on the CPU happens
only when the caller names the CPU.
"""

from __future__ import annotations

import os
import subprocess
from typing import Union

import torch

DeviceLike = Union[None, str, torch.device]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device a query runs on: CUDA unless the caller names the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: "
                "--platform cpu) to run the plain PyTorch versions")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {dev} (use cuda or cpu)")


def memory_budget_bytes(device: DeviceLike = None) -> int:
    """Memory the record tables may be sized against: the card's total
    memory on CUDA, the host's physical RAM on an explicit CPU device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return int(torch.cuda.mem_get_info(dev)[1])
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")


def card_line(device: DeviceLike = None) -> str:
    """`name, power.limit` of the card as nvidia-smi reports it, to be
    printed beside every number measured on it."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("card_line needs a CUDA device")
    out = subprocess.run(
        ["nvidia-smi", "-i", str(dev.index),
         "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()
