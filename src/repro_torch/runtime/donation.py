"""The central buffer-donation policy. Twin of ``repro.runtime.donation``.

One place decides whether a hot-path builder is asked to donate, as in the
reference: off the CPU it donates, on the CPU it does not, and every
builder that takes buffers it could donate accepts a ``donate=`` override
that this module threads through.

PyTorch has no ``jit`` and no ``donate_argnums``. In the port the words
mean:

* **donated** — the callee may update the caller's params, velocity or
  stacked worker buffers in place: after the call the caller's tensors may
  hold the results (the returned tensors may *be* them), so the caller must
  not read the old values from them any more;
* **not donated** — the callee leaves them untouched: it returns new
  tensors, and the caller may call it again on the same inputs (what the
  equivalence tests and a retried step do).

A donating callee writes the caller's buffers only after its last
operation that can fail, so a fault raised inside the call leaves them as
they were, as a donated XLA call that fails leaves its inputs valid.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

__all__ = ["backend_donates", "donate_argnums"]


def backend_donates(device: Optional[Union[str, torch.device]] = None) -> bool:
    """Whether the policy requests donation: on ``device`` when one is
    given, else on the port's default device (the card when there is one)."""
    if device is None:
        return torch.cuda.is_available()
    return torch.device(device).type != "cpu"


def donate_argnums(
    *argnums: int, override: Optional[Tuple[int, ...]] = None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[int, ...]:
    """The donated argument positions of a hot-path call.

    ``override`` short-circuits the policy: builders thread their
    ``donate=`` parameter through here so that tests can force donation on
    or off on any device. ``None`` means "apply the policy" (on ``device``
    when given)."""
    if override is not None:
        return tuple(override)
    return tuple(argnums) if backend_donates(device) else ()
