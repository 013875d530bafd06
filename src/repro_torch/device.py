"""Device resolution for the port's entry points.

Entry points default to ``cuda``. Asking for ``cuda`` where PyTorch sees no
GPU raises: nothing drops to the CPU on its own. The CPU is used only when
the caller names it, as the tests do.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """``torch.device`` for ``device`` (``None`` means ``cuda``), checked:
    a CUDA device must exist, and only CPU and CUDA devices are accepted."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} was asked for but torch.cuda."
                f"is_available() is False; pass device='cpu' to run the "
                f"plain PyTorch versions on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev


def resolve_or_meta(device: Union[str, torch.device, None] = "cuda"
                    ) -> torch.device:
    """``meta`` as it is (shapes and dtypes without memory), any other
    device through :func:`resolve_device`."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)
