"""Device selection: the card by default, the CPU only when asked for."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``cuda`` when ``device`` is None; raises when CUDA is missing and the
    caller did not ask for ``"cpu"`` — never a quiet CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        # an explicit index: torch.cuda.set_device needs one in other threads
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
