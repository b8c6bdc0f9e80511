"""The port's device rule: an entry point runs on the card unless its
caller asks for the CPU (``device="cpu"``), as the tests do.

Without a CUDA device, a call that leaves ``device`` out raises at once
instead of quietly running on the CPU.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    no CUDA device."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} (the default) needs a CUDA device and "
            "none is available; pass device='cpu' to run on the CPU")
    return dev
