"""RG-LRU recurrent block (RecurrentGemma / Griffin, arXiv:2402.19427).
Twin of ``repro.models.griffin``.

Block: x -> [linear_y (gate branch, GeLU), linear_x -> causal conv1d(4) ->
RG-LRU] -> elementwise product -> linear_out.

RG-LRU recurrence (per channel):
    r_t = sigmoid(W_a x_t)            recurrence gate
    i_t = sigmoid(W_x x_t)            input gate
    a_t = a^(c * r_t),  a = sigmoid(Lambda),  c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

A linear diagonal recurrence: the Mamba block's chunked scan (a Python loop
over chunks, a log-depth scan inside each, the chunk body checkpointed where
autograd records), on a (B, d_rnn) state. The gate branch's GeLU is the tanh
approximation, ``jax.nn.gelu``'s default.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dense_init
from repro_torch.models.mamba import (_causal_conv, _checkpointed, _pad_seq, linear_scan,
                                      softplus)

__all__ = [
    "RGLRUConfig",
    "init_rglru_block",
    "rglru_fwd",
    "init_rglru_state",
    "rglru_specs",
]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_model: int
    d_rnn: int              # recurrentgemma-2b: 2560
    d_conv: int = 4
    c_exponent: float = 8.0
    chunk: int = 256


def init_rglru_block(gen: torch.Generator, cfg: RGLRUConfig, dtype: torch.dtype,
                     device: torch.device, into: Optional[Params] = None) -> Params:
    d, dr = cfg.d_model, cfg.d_rnn
    out = (into or {}).get
    return {
        "linear_x": dense_init(gen, (d, dr), d, dtype, device, out("linear_x")),
        "linear_y": dense_init(gen, (d, dr), d, dtype, device, out("linear_y")),
        "conv_w": dense_init(gen, (cfg.d_conv, dr), cfg.d_conv, dtype, device, out("conv_w")),
        "conv_b": torch.zeros((dr,), dtype=dtype, device=device),
        "w_a": dense_init(gen, (dr, dr), dr, dtype, device, out("w_a")),
        "w_x": dense_init(gen, (dr, dr), dr, dtype, device, out("w_x")),
        "lambda_p": torch.full((dr,), 2.2, dtype=torch.float32, device=device),  # sigmoid ~ 0.9
        "linear_out": dense_init(gen, (dr, d), dr, dtype, device, out("linear_out")),
    }


def rglru_specs() -> Dict:
    """The logical-axis spec of :func:`init_rglru_block`'s parameters."""
    return {
        "linear_x": ("embed", "inner"), "linear_y": ("embed", "inner"),
        "conv_w": (None, "inner"), "conv_b": ("inner",), "w_a": ("inner", "inner_b"),
        "w_x": ("inner", "inner_b"), "lambda_p": ("inner",), "linear_out": ("inner", "embed"),
    }


def _rglru_chunk(h, g, a):
    a_sc, b_sc = linear_scan(a, g)
    h_all = a_sc * h[:, None] + b_sc
    return h_all[:, -1], h_all


def _rglru_scan(gx: torch.Tensor, a_t: torch.Tensor, h0: torch.Tensor, chunk: int):
    """h_t = a_t h_{t-1} + gx_t, chunked. gx, a_t: (B,S,dr); h0: (B,dr).
    The padded tail's a_t is 1."""
    S = gx.shape[1]
    c = min(chunk, S)
    n_chunks = -(-S // c)
    pad = n_chunks * c - S
    gx, a_t = _pad_seq(gx, pad), _pad_seq(a_t, pad, 1.0)
    h, hs = h0, []
    for i in range(n_chunks):
        at = slice(i * c, (i + 1) * c)
        h, h_all = _checkpointed(_rglru_chunk, h, gx[:, at], a_t[:, at])
        hs.append(h_all)
    return torch.cat(hs, dim=1)[:, :S], h


def rglru_fwd(params: Params, x: torch.Tensor, cfg: RGLRUConfig,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """The block over (B, S, d); a new state is returned only when one is
    given."""
    B = x.shape[0]
    y_gate = F.gelu(x @ params["linear_y"], approximate="tanh")
    xr = x @ params["linear_x"]
    conv_state = state["conv"] if state else None
    xr, new_conv = _causal_conv(xr, params["conv_w"], params["conv_b"], conv_state)

    xf = xr.float()
    r = torch.sigmoid(xf @ params["w_a"].float())
    i = torch.sigmoid(xf @ params["w_x"].float())
    log_a = cfg.c_exponent * r * -softplus(-params["lambda_p"])  # log_sigmoid
    a_t = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a_t.square(), min=1e-12)) * (i * xf)
    h0 = (state["rnn"].float() if state
          else torch.zeros((B, cfg.d_rnn), dtype=torch.float32, device=x.device))
    h_seq, hT = _rglru_scan(gated, a_t, h0, cfg.chunk)
    out = (h_seq.to(x.dtype) * y_gate) @ params["linear_out"]
    new_state = {"rnn": hT.float(), "conv": new_conv} if state is not None else None
    return out, new_state


def init_rglru_state(cfg: RGLRUConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> Dict:
    return {
        "rnn": torch.zeros((batch, cfg.d_rnn), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_rnn), dtype=dtype, device=device),
    }
