"""Mixture-of-Experts FFN with grouped sort-based dispatch (static shapes).
Twin of ``repro.models.moe``.

Dispatch is organised in ``groups`` independent token groups: each group
sorts and capacity-buckets only its own tokens, producing (G, E, C, d)
expert buffers. Overflow beyond capacity C = ceil(T_g * k * cf / E) is
dropped (standard capacity-factor semantics; the auxiliary loss pushes the
router toward balance). The sort by expert is stable, so capacity drops the
same tokens as the reference's.

Plain PyTorch, as the reference leaves it to XLA: the router in f32, the
three expert einsums as ``torch.einsum``. The reference's combine scatters
with ``.at[st].add``; ``index_add_`` on the card sums with atomics, in
another order on every run. Each token has exactly K entries, so here the
sorted contributions are put back in (token, k) order by the inverse of the
sort's permutation and summed over k in index order: a fixed order, no
scatter-add.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.all_relu import activation_fn
from repro_torch.models.layers import dense_init

__all__ = ["MoEConfig", "dispatch_shape", "init_moe", "moe_fwd", "moe_specs"]

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int                      # per-expert hidden
    capacity_factor: float = 1.25
    activation: str = "silu"
    router_aux_weight: float = 0.01
    norm_topk_prob: bool = True    # qwen3 renormalizes top-k gates
    groups: int = 1                # data-parallel dispatch groups


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype: torch.dtype,
             device: torch.device, into: Optional[Params] = None) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    out = (into or {}).get
    return {
        "router": dense_init(gen, (d, e), d, torch.float32, device, out("router")),
        "wi_gate": dense_init(gen, (e, d, f), d, dtype, device, out("wi_gate")),
        "wi_up": dense_init(gen, (e, d, f), d, dtype, device, out("wi_up")),
        "wo": dense_init(gen, (e, f, d), f, dtype, device, out("wo")),
    }


def moe_specs() -> Dict:
    """The logical-axis spec of :func:`init_moe`'s parameters."""
    return {
        "router": ("embed", None),
        "wi_gate": ("experts", "embed", "expert_mlp"),
        "wi_up": ("experts", "embed", "expert_mlp"),
        "wo": ("experts", "expert_mlp", "embed"),
    }


def _dispatch(params: Params, xg: torch.Tensor, cfg: MoEConfig, C: int):
    """Route (G, Tg, d) tokens: returns the auxiliary loss and, per group in
    expert-sorted order, each entry's slot (``e * C + position``, the
    overflow row ``E * C`` where dropped), token, gate and kept flag, and
    the sort's permutation ``order`` of the (token, k) entries."""
    G, Tg, _ = xg.shape
    E, K = cfg.n_experts, cfg.top_k
    logits = (xg @ params["router"].to(xg.dtype)).float()
    probs = torch.softmax(logits, dim=-1)              # (G, Tg, E)
    gate, eidx = torch.topk(probs, K, dim=-1)          # (G, Tg, K)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)

    # load-balancing aux loss (Switch): E * mean_e f_e * p_e (global mean)
    me = probs.mean(dim=(0, 1))
    fe = F.one_hot(eidx[..., 0], E).float().mean(dim=(0, 1))
    aux = cfg.router_aux_weight * E * torch.sum(fe * me)

    dev = xg.device
    flat_e = eidx.reshape(G, Tg * K)
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K).expand(G, Tg * K)
    flat_g = gate.reshape(G, Tg * K)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    st = flat_t.gather(-1, order)
    sg = flat_g.gather(-1, order)
    seg_start = torch.searchsorted(se, torch.arange(E, device=dev).expand(G, E).contiguous())
    pos_in_e = torch.arange(Tg * K, device=dev) - seg_start.gather(-1, se)
    keep = pos_in_e < C
    slot = torch.where(keep, se * C + pos_in_e, E * C)  # overflow -> scratch row
    return aux, slot, st, sg, keep, order


def dispatch_shape(cfg: MoEConfig, T: int) -> Tuple[int, int, int]:
    """(G, Tg, C) of a dispatch of ``T`` tokens: ``gcd(groups, T)`` groups
    of ``Tg`` tokens, each expert ``C`` slots a group."""
    G = max(1, math.gcd(cfg.groups, T))
    Tg = T // G
    return G, Tg, max(1, int(math.ceil(Tg * cfg.top_k * cfg.capacity_factor / cfg.n_experts)))


def moe_fwd(params: Params, x: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., d). Returns (y, aux_loss)."""
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    E, K = cfg.n_experts, cfg.top_k
    G, Tg, C = dispatch_shape(cfg, xt.shape[0])
    xg = xt.reshape(G, Tg, d)
    aux, slot, st, sg, keep, order = _dispatch(params, xg, cfg, C)

    # scatter the kept entries into their slots; the dropped ones all land in
    # the scratch row E * C, which is cut off
    groups = torch.arange(G, device=x.device)[:, None]
    vals = torch.where(keep[..., None], xg[groups, st], 0)
    buf = xg.new_zeros((G, E * C + 1, d))
    buf[groups, slot] = vals
    xe = buf[:, : E * C].reshape(G, E, C, d)

    act = activation_fn(cfg.activation)
    g = act(torch.einsum("gecd,edf->gecf", xe, params["wi_gate"]), 1)
    u = torch.einsum("gecd,edf->gecf", xe, params["wi_up"])
    ye = torch.einsum("gecf,efd->gecd", g * u, params["wo"])   # (G, E, C, d)

    # combine: each sorted entry's weighted output, put back in (token, k)
    # order and summed over k in index order
    flat_y = ye.reshape(G, E * C, d)
    picked = flat_y[groups, slot.clamp(max=E * C - 1)]
    contrib = torch.where(keep[..., None], picked, 0) * sg[..., None].to(flat_y.dtype)
    inv = torch.empty_like(order).scatter_(
        -1, order, torch.arange(Tg * K, device=x.device).expand(G, Tg * K).contiguous())
    per_k = contrib[groups, inv].reshape(G, Tg, K, d)
    y = per_k[:, :, 0]
    for k in range(1, K):
        y = y + per_k[:, :, k]
    return y.reshape(*lead, d), aux
