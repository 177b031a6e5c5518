"""The explicit-device rule shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when CUDA is asked for (explicitly or by default) and no GPU is
    present: the port never falls back to the CPU unless the caller passes
    ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the "
            "CPU")
    return dev
