"""Mamba-1 block (falcon-mamba-7b): the selective SSM. Twin of
``repro.models.mamba``.

The recurrence runs as the reference's chunked scan: the (B, d_inner,
d_state) state is carried across chunks of ``chunk`` positions by a Python
loop, and inside a chunk the linear recurrence h_t = a_t h_{t-1} + b_t is a
log-depth (Hillis-Steele) scan over the chunk's positions with the
reference's combine ``(a_l a_r, b_r + a_r b_l)``: log2(c) steps of whole-chunk
tensor operations, where a loop over the positions would launch c times as
many kernels on the card. Each step multiplies pairs the sequential
recurrence multiplies in another grouping, which holds the reference's
tolerance against the sequential recurrence (``tests/test_model_numerics.py``:
1e-4). Where autograd records, each chunk body runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the backward
recomputes the chunk's (B, c, d_inner, d_state) intermediates instead of
keeping them for every chunk.

``dt_bc_norms`` adds Jamba's RMSNorms (learned weights, eps 1e-6)
on dt, B and C after ``x_proj``, as ``JambaMambaMixer`` has them. The
selective scan runs inside the ``lm.mamba.scan`` span (its forward, and
remat's recompute of it; not its backward).

``softplus`` is the reference's ``jax.nn.softplus``, ``logaddexp(x, 0)``
(``F.softplus`` switches to the identity above 20). The in and out
projections are plain ``torch.matmul``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import obs
from repro_torch.models.layers import dense_init, rmsnorm

__all__ = ["MambaConfig", "init_mamba_block", "mamba_fwd", "mamba_decode_step",
           "init_mamba_state", "mamba_specs"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_model: int
    d_inner: int            # expand * d_model (falcon-mamba: 2 * 4096)
    d_state: int = 16
    d_conv: int = 4
    dt_rank: int = 0        # 0 -> d_model // 16
    chunk: int = 256
    dt_bc_norms: bool = False  # RMSNorms on dt, B and C (Jamba)

    @property
    def rank(self) -> int:
        return self.dt_rank or max(1, self.d_model // 16)


def init_mamba_block(gen: torch.Generator, cfg: MambaConfig, dtype: torch.dtype,
                     device: torch.device, into: Optional[Params] = None) -> Params:
    d, di, ds, r = cfg.d_model, cfg.d_inner, cfg.d_state, cfg.rank
    a = torch.arange(1, ds + 1, dtype=torch.float32).expand(di, ds)
    out = (into or {}).get
    norms = {}
    if cfg.dt_bc_norms:  # unit-offset scales, as the model's other RMSNorms
        norms = {name: torch.zeros((n,), dtype=dtype, device=device)
                 for name, n in (("dt_norm", r), ("b_norm", ds), ("c_norm", ds))}
    return {
        **norms,
        "in_proj": dense_init(gen, (d, 2 * di), d, dtype, device, out("in_proj")),
        "conv_w": dense_init(gen, (cfg.d_conv, di), cfg.d_conv, dtype, device, out("conv_w")),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": dense_init(gen, (di, r + 2 * ds), di, dtype, device, out("x_proj")),
        "dt_proj": dense_init(gen, (r, di), r, dtype, device, out("dt_proj")),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),  # softplus^-1(~0.01)
        "a_log": torch.log(a).to(device),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": dense_init(gen, (di, d), di, dtype, device, out("out_proj")),
    }


def mamba_specs(cfg: Optional[MambaConfig] = None) -> Dict:
    """The logical-axis spec of :func:`init_mamba_block`'s parameters."""
    norms = {}
    if cfg is not None and cfg.dt_bc_norms:
        norms = {"dt_norm": (None,), "b_norm": (None,), "c_norm": (None,)}
    return {
        **norms,
        "in_proj": ("embed", "inner2"), "conv_w": (None, "inner"), "conv_b": ("inner",),
        "x_proj": ("inner", None), "dt_proj": (None, "inner"), "dt_bias": ("inner",),
        "a_log": ("inner", None), "d_skip": ("inner",), "out_proj": ("inner", "embed"),
    }


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, width K. x: (B,S,di), w: (K,di).
    init_state: (B, K-1, di) previous inputs for decode continuity."""
    K = w.shape[0]
    if init_state is None:
        xp = F.pad(x, (0, 0, K - 1, 0))
    else:
        xp = torch.cat([init_state.to(x.dtype), x], dim=1)
    y = sum(xp[:, i: i + x.shape[1]] * w[i] for i in range(K))
    return y + b, xp[:, -(K - 1):]  # new conv state


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along axis 1 of the pairs (a, b) under the combine
    ``(a_l a_r, b_r + a_r b_l)`` (l the earlier position), Hillis-Steele:
    at offset s = 1, 2, 4, ... every position combines with the one s
    before it. Returns (prefix products of a, the recurrence from 0)."""
    c = a.shape[1]
    s = 1
    while s < c:
        a, b = (torch.cat([a[:, :s], a[:, :-s] * a[:, s:]], dim=1),
                torch.cat([b[:, :s], b[:, s:] + a[:, s:] * b[:, :-s]], dim=1))
        s *= 2
    return a, b


def _checkpointed(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` where autograd records
    (the reference's ``jax.checkpoint`` of a chunk body)."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


def _ssm_chunk(h, ub, db, bb, cb, A):
    da = torch.exp(db[..., None] * A)
    dbu = db[..., None] * bb[:, :, None, :] * ub[..., None]
    a_sc, b_sc = linear_scan(da, dbu)
    h_all = a_sc * h[:, None] + b_sc                      # (B,c,di,ds)
    y = torch.einsum("bcds,bcs->bcd", h_all, cb)
    return h_all[:, -1], y


def _pad_seq(t: torch.Tensor, pad: int, value: float = 0.0) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, pad), value=value) if pad else t


def _ssm_chunked(u, delta, Bc, Cc, A, h0, chunk):
    """Selective scan.  u,delta: (B,S,di); Bc,Cc: (B,S,ds); A: (di,ds);
    h0: (B,di,ds). Returns y (B,S,di), hT."""
    S = u.shape[1]
    c = min(chunk, S)
    n_chunks = -(-S // c)
    pad = n_chunks * c - S
    u, delta, Bc, Cc = (_pad_seq(t, pad) for t in (u, delta, Bc, Cc))
    h, ys = h0, []
    for i in range(n_chunks):
        at = slice(i * c, (i + 1) * c)
        h, y = _checkpointed(_ssm_chunk, h, u[:, at], delta[:, at], Bc[:, at], Cc[:, at], A)
        ys.append(y)
    return torch.cat(ys, dim=1)[:, :S], h


def mamba_fwd(params: Params, x: torch.Tensor, cfg: MambaConfig,
              state: Optional[Dict] = None) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (train/prefill) forward. state carries (ssm, conv); a
    new state is returned only when one is given."""
    B = x.shape[0]
    di, ds, r = cfg.d_inner, cfg.d_state, cfg.rank
    xp, z = (x @ params["in_proj"]).chunk(2, dim=-1)
    conv_state = state["conv"] if state else None
    xp, new_conv = _causal_conv(xp, params["conv_w"], params["conv_b"], conv_state)
    xp = F.silu(xp)

    xdb = (xp @ params["x_proj"]).float()
    dt, Bc, Cc = torch.split(xdb, [r, ds, ds], dim=-1)
    if cfg.dt_bc_norms:
        dt, Bc, Cc = (rmsnorm({"scale": params[k]}, t)
                      for k, t in (("dt_norm", dt), ("b_norm", Bc), ("c_norm", Cc)))
    delta = softplus(dt @ params["dt_proj"].float() + params["dt_bias"].float())
    A = -torch.exp(params["a_log"])
    h0 = (state["ssm"].float() if state
          else torch.zeros((B, di, ds), dtype=torch.float32, device=x.device))
    with obs.span("lm.mamba.scan"):
        y, hT = _ssm_chunked(xp.float(), delta, Bc, Cc, A, h0, cfg.chunk)
    y = y + params["d_skip"] * xp.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ params["out_proj"]
    new_state = {"ssm": hT.float(), "conv": new_conv} if state is not None else None
    return out, new_state


def init_mamba_state(cfg: MambaConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> Dict:
    return {
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.d_state), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros((batch, cfg.d_conv - 1, cfg.d_inner), dtype=dtype, device=device),
    }


def mamba_decode_step(params: Params, x: torch.Tensor, cfg: MambaConfig, state: Dict):
    """x: (B, 1, d). O(1) state update."""
    return mamba_fwd(params, x, cfg, state=state)
