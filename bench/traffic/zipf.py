"""A Zipf token stream, drawn on the device from a ``torch.Generator``:
token ids ranked by a random permutation of the vocabulary (drawn once
from the seed), rank r drawn with probability proportional to
``1 / (r + 1) ** exponent``. Each step takes ``batch`` sequences of ``seq``
tokens and the next token of each (``seq + 1`` draws a sequence); no
packing and no document boundaries.

Parameters (the traffic file): ``exponent``, ``batch``, ``seq``; the vocabulary
is the configuration's.
"""
from __future__ import annotations

from typing import Dict

import torch


class ZipfStream:
    def __init__(self, p: Dict, vocab: int, gen: torch.Generator, device):
        self.batch, self.seq, self.gen = int(p["batch"]), int(p["seq"]), gen
        ranks = torch.arange(1, vocab + 1, dtype=torch.float64, device=device)
        self.probs = ranks.pow(-float(p["exponent"])).float()
        self.ids = torch.randperm(vocab, generator=gen, device=device)

    def draw(self) -> torch.Tensor:
        """(batch, seq + 1) int64 token ids on the device."""
        r = torch.multinomial(self.probs, self.batch * (self.seq + 1), replacement=True,
                              generator=self.gen)
        return self.ids[r].reshape(self.batch, self.seq + 1)


def make(p: Dict, vocab: int, gen: torch.Generator, device) -> ZipfStream:
    return ZipfStream(p, vocab, gen, device)
