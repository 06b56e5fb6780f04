"""Device resolution for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device: Union[str, torch.device, None] = None
                   ) -> torch.device:
    """``device`` as a ``torch.device`` (default ``cuda``).

    Asking for CUDA on a machine without a usable GPU raises: the port
    never carries on silently on the CPU. Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels instead."""
    dev = torch.device(DEFAULT_DEVICE if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; repro_torch runs on the GPU by "
            "default — pass device='cpu' (or --device cpu) to run the plain "
            "PyTorch versions of the kernels on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev
