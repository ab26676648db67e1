"""Device policy shared by every entry point of the port.

``device=None`` means the CUDA device.  There is no silent fallback: if
CUDA is absent, an entry point raises unless its caller asked for the
CPU explicitly (``device="cpu"``), which is what the CPU tests do.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The torch device an entry point runs on (``None`` -> ``"cuda"``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (cuda or cpu)")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default, but "
                "torch.cuda.is_available() is False; pass device='cpu' to "
                "run on the CPU")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
