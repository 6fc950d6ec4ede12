"""Device selection for the port's entry points.

The port runs on the card: ``resolve()`` with no argument returns the
CUDA device and raises when none is present — it never falls back to the
CPU.  The CPU is used only when a caller asks for it (``device="cpu"``),
as the tests do.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raising without a card); else ``device``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch paths on the CPU")
    return dev


def disable_tf32() -> None:
    """Keep fp32 matmuls and convolutions in full fp32 (no TF32), so the
    card's results stay comparable with the fp32 reference."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
