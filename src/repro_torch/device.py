"""The port's device rule: entry points run on the card unless asked not to."""
from __future__ import annotations

from typing import Optional, Union

import torch
from torch._subclasses.fake_tensor import FakeTensor

__all__ = ["resolve_device", "takes_plain"]


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    """``None`` means ``"cuda"``. Asking for the card where there is none
    raises instead of quietly running on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port's plain PyTorch versions on the CPU"
            )
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise ValueError(f"the port runs on 'cuda' or 'cpu', not {device}")
    return device


def takes_plain(t: torch.Tensor) -> bool:
    """Whether a kernel wrapper takes its plain PyTorch version for ``t``:
    a tensor on the CPU, a ``meta`` tensor, or a fake one (shape and dtype,
    no storage: the dry run's), whatever device a fake one names. Any
    other tensor launches the wrapper's kernel, or raises."""
    return t.device.type in ("cpu", "meta") or isinstance(t, FakeTensor)
