"""Device resolution for the port's entry points.

Entry points run on the GPU unless the caller asks for the CPU by name.
There is no quiet fallback: with no CUDA device and no explicit CPU request
the entry point raises.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` or ``"cuda"`` -> the current CUDA device (raises without one);
    ``"cpu"`` -> the CPU, only when asked for explicitly."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
