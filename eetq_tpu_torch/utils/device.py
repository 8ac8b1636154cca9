"""The device a tensor made from nothing lands on.

The port runs on the card unless the caller asks for the CPU: every entry
point that allocates without an input tensor to follow (caches, tables,
parameters carried across from numpy, empty shells) takes `device=None` and
resolves it here. Where there is no card the allocation then fails loudly;
the CPU tests pass `device="cpu"`.
"""

from __future__ import annotations

import torch


def resolve(device: torch.device | str | None = None) -> torch.device:
    """`device` as a torch.device; None is the CUDA card."""
    return torch.device("cuda" if device is None else device)
