"""Device selection shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Turn ``device`` into a ``torch.device``; raise if it names CUDA and no
    CUDA device is present. The port never moves work to the CPU on its own:
    callers that want the CPU ask for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the CPU"
        )
    return dev
