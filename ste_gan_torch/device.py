"""Where the port's entry points run."""
from __future__ import annotations

import subprocess
from typing import Optional, Union

import torch


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi`` reports
    them; written beside every measurement."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one. Raises when CUDA was wanted and no card is present;
    it never carries on on the CPU by itself."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device found; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU")
    return dev
