"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for another device;
asking for CUDA where there is none raises instead of quietly running on
the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev
