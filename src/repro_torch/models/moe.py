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

``dropless=True`` is the published semantics of Jamba and Mixtral: every
routed entry is computed, with no capacity and no padding. The entries
are sorted by expert (stable); one host read of the per-expert counts
(the only host sync) gives each expert its contiguous rows, and each held
expert's three products are one ``torch.matmul`` each over its rows. The
combine is the same fixed order as above. ``held = (first, stop)`` is the
expert-parallel share of one chip: the router keeps all ``n_experts``
outputs and its top-k, the layer holds and computes only experts
``first..stop-1``, and the entries routed elsewhere add nothing here (on
one chip the layer runs without its exchange). Its auxiliary loss is
theirs too, ``load_balancing_loss_func``: each layer returns its routing
counts and :func:`pooled_aux` turns their sum over the layers into the
loss (the capacity dispatch returns its layer's top-1 Switch loss).

Each call runs inside the ``lm.moe`` span (routing, experts and combine);
a dropless call sets its attributes ``rows`` (entries computed by the
held experts), ``max_rows`` (the busiest held expert's) and
``host_syncs``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.all_relu import activation_fn
from repro_torch.models.layers import dense_init

__all__ = ["MoEConfig", "dispatch_shape", "init_moe", "moe_fwd", "moe_specs", "pooled_aux"]

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
    dropless: bool = False         # every routed entry computed (Jamba, Mixtral)
    held: Optional[Tuple[int, int]] = None  # [first, stop) of the experts held here

    @property
    def held_range(self) -> Tuple[int, int]:
        return tuple(self.held) if self.held is not None else (0, self.n_experts)


def init_moe(gen: torch.Generator, cfg: MoEConfig, dtype: torch.dtype,
             device: torch.device, into: Optional[Params] = None) -> Params:
    first, stop = cfg.held_range
    e, d, f = stop - first, cfg.d_model, cfg.d_ff
    out = (into or {}).get
    return {
        "router": dense_init(gen, (d, cfg.n_experts), d, torch.float32, device, out("router")),
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
    probs, gate, eidx = _route(params, xg, cfg)        # (G, Tg, E), (G, Tg, K) x 2

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
    """x: (..., d). Returns (y, aux): the auxiliary loss, or with
    ``dropless`` this layer's routing counts (:func:`pooled_aux`)."""
    if cfg.held is not None and not cfg.dropless:
        raise ValueError("a held share of the experts needs dropless dispatch")
    with obs.span("lm.moe") as sp:
        if cfg.dropless:
            return _dropless_fwd(params, x, cfg, sp)
        return _capacity_fwd(params, x, cfg)


def _route(params: Params, xt: torch.Tensor, cfg: MoEConfig):
    """(probs (..., E) f32, gate (..., K), eidx (..., K)) of tokens ``xt``
    (..., d): the router's softmax over all its experts in f32 and its top k."""
    logits = (xt @ params["router"].to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate, eidx = torch.topk(probs, cfg.top_k, dim=-1)
    if cfg.norm_topk_prob:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate, eidx


def _routing_counts(probs: torch.Tensor, eidx: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """One layer's counts for :func:`pooled_aux`: each (k, expert)'s routed
    entries, each expert's summed probability and the token count, in one
    f32 vector."""
    fe = F.one_hot(eidx, cfg.n_experts).float().sum(0).reshape(-1)    # (K * E,)
    n = torch.full((1,), float(probs.shape[0]), device=probs.device)
    return torch.cat([fe, probs.sum(0), n])


def pooled_aux(stats: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """``router_aux_weight * load_balancing_loss_func`` from the sum of the
    MoE layers' :func:`_routing_counts`: ``E * sum_{k,e} f_{k,e} P_e`` with
    ``f`` each (k, expert)'s share of the entries and ``P`` each expert's
    mean probability, both over every layer's tokens together."""
    E, K = cfg.n_experts, cfg.top_k
    n = stats[-1]
    fe = stats[: K * E].reshape(K, E) / n
    pe = stats[K * E: K * E + E] / n
    return cfg.router_aux_weight * E * torch.sum(fe * pe[None])


def _expert_rows(counts: List[int], first: int, stop: int) -> List[Tuple[int, int]]:
    """(start, rows) of each held expert's entries in the expert-sorted
    order: all of its entries, from where it starts."""
    start = sum(counts[:first])
    out = []
    for e in range(first, stop):
        out.append((start, counts[e]))
        start += counts[e]
    return out


def _dropless_fwd(params: Params, x: torch.Tensor, cfg: MoEConfig, sp):
    lead, d = x.shape[:-1], x.shape[-1]
    xt = x.reshape(-1, d)
    T, E, K = xt.shape[0], cfg.n_experts, cfg.top_k
    first, stop = cfg.held_range
    probs, gate, eidx = _route(params, xt, cfg)
    aux = _routing_counts(probs, eidx, cfg)
    flat_e = eidx.reshape(-1)
    order = torch.argsort(flat_e, stable=True)           # (T * K,) entries by expert
    counts = torch.bincount(flat_e, minlength=E).tolist()  # the one host sync
    segs = _expert_rows(counts, first, stop)
    sorted_gate = gate.reshape(-1)[order]
    held_lo = sum(counts[:first])
    held_hi = held_lo + sum(counts[first:stop])
    xs = xt[order[held_lo:held_hi] // K]                 # the held experts' rows, sorted
    act = activation_fn(cfg.activation)
    pieces = [xt.new_zeros((held_lo, d))]
    for e, (start, n) in enumerate(segs):
        rows = xs[start - held_lo: start - held_lo + n]
        ye = (act(rows @ params["wi_gate"][e], 1) * (rows @ params["wi_up"][e])) @ params["wo"][e]
        pieces.append(ye * sorted_gate[start: start + n, None].to(ye.dtype))
        if counts[first + e] > n:                        # entries left uncomputed
            pieces.append(xt.new_zeros((counts[first + e] - n, d)))
    pieces.append(xt.new_zeros((T * K - held_hi, d)))
    expert_rows = [n for _, n in segs]
    sp.set(rows=sum(expert_rows), max_rows=max(expert_rows, default=0), host_syncs=1)
    # combine: the sorted contributions back in (token, k) order, summed
    # over k in index order
    contrib = torch.cat(pieces)
    inv = torch.empty_like(order).scatter_(0, order, torch.arange(T * K, device=x.device))
    per_k = contrib[inv].reshape(T, K, d)
    y = per_k[:, 0]
    for k in range(1, K):
        y = y + per_k[:, k]
    return y.reshape(*lead, d), aux


def _capacity_fwd(params: Params, x: torch.Tensor, cfg: MoEConfig):
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
