"""Shared model layers: norms, RoPE, GQA attention (chunked online softmax),
the gated FFN and the paper's sparse SET-FFN, embeddings. Twin of
``repro.models.layers``.

As there, the layers are functions: ``init_*`` returns the parameter dict
(and, for the sparse FFN, its host topologies and block metas) and ``*_fwd``
computes. The reference's logical-axis specs, which name shardings for the
pod machinery, come with it (ROADMAP Queue 1, item 9). Dense draws come from
an explicit ``torch.Generator``, on the generator's device, and are then
moved to ``device``: a CPU generator gives the same weights on every device
(not jax.random's draws: they cross over through ``interop.lm_from_numpy``
and ``interop.whisper_from_numpy``); the sparse FFN draws from numpy, the
reference's draws bit for bit.

Arithmetic follows the reference's order and precision: norms and attention
scores in f32, the running (max, denominator, accumulator) triple of the
chunked softmax, and Python scalars rounded to the operand's dtype before a
multiply (``kernels.ref.scalar_in``), as JAX rounds a weakly typed scalar.
The dense products (``x @ wq``, the unembedding) are ``torch.matmul``, as
the reference leaves them to XLA; attention is plain PyTorch, as it is an
XLA pass there. The sparse FFN is the kernels: kernel C (W_in) with kernel
B's bias-free All-ReLU in its store, kernel C (W_out) on the card, their
plain versions on the CPU; under autograd, kernel C's autograd Function on
each weight (backward: kernels D and E) with All-ReLU between them.
Whisper's layers (``cross_attention_fwd``, ``init_plain_ffn``,
``plain_ffn_fwd``) are dense: ``torch.matmul`` and plain PyTorch, as XLA
computes them in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.all_relu import activation_fn, all_relu
from repro_torch.core.sparsity import BlockMeta, BlockTopoArrays, BlockTopology
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import scalar_in

__all__ = [
    "AttnConfig", "SparseFFNConfig", "apply_rope", "attention_fwd", "cross_attention_fwd",
    "dense_init", "embed", "gated_ffn_fwd", "init_attention", "init_embedding",
    "init_gated_ffn", "init_layernorm", "init_plain_ffn", "init_rmsnorm", "init_sparse_ffn",
    "layernorm", "plain_ffn_fwd", "rmsnorm", "sparse_ffn_fwd", "unembed",
]

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape, in_axis_size: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Normal draws scaled by 1/sqrt(fan-in), drawn in f32 from the
    generator ``gen`` on its device, then cast and moved."""
    scale = 1.0 / math.sqrt(max(1, in_axis_size))
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device) * scale
    return w.to(dtype).to(device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: torch.Tensor, *, eps: float = 1e-6,
            unit_offset: bool = True) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    scale = params["scale"].float()
    scale = 1.0 + scale if unit_offset else scale
    return (y * scale).to(x.dtype)


def init_layernorm(d: int, dtype: torch.dtype, device: torch.device) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params: Params, x: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *, theta: float = 10000.0
               ) -> torch.Tensor:
    """x: (..., S, H, D); positions: (..., S)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    angles = positions.unsqueeze(-1).float() * freq        # (..., S, half)
    angles = angles.unsqueeze(-2)                          # broadcast over heads
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention (GQA, chunked online softmax)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    d_model: int
    qkv_bias: bool = False
    softcap: Optional[float] = None        # gemma2 logit soft-capping
    window: Optional[int] = None           # sliding-window size (local/SWA)
    rope_theta: float = 10000.0
    query_scale: Optional[float] = None    # default 1/sqrt(head_dim)
    kv_chunk: int = 1024
    causal_skip: bool = False              # perf: skip fully-masked kv chunks


def init_attention(gen: torch.Generator, cfg: AttnConfig, dtype: torch.dtype,
                   device: torch.device) -> Params:
    h, kv, d, dm = cfg.n_heads, cfg.n_kv, cfg.head_dim, cfg.d_model
    params = {
        "wq": dense_init(gen, (dm, h * d), dm, dtype, device),
        "wk": dense_init(gen, (dm, kv * d), dm, dtype, device),
        "wv": dense_init(gen, (dm, kv * d), dm, dtype, device),
        "wo": dense_init(gen, (h * d, dm), h * d, dtype, device),
    }
    if cfg.qkv_bias:
        params.update(
            bq=torch.zeros((h * d,), dtype=dtype, device=device),
            bk=torch.zeros((kv * d,), dtype=dtype, device=device),
            bv=torch.zeros((kv * d,), dtype=dtype, device=device),
        )
    return params


MaskFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _online_softmax_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            mask_fn: MaskFn, cfg: AttnConfig,
                            q_positions: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, D); k, v: (B, Skv, KV, D). Walks the KV chunks with a
    running (max, denominator, accumulator) triple, as the reference's scan
    does. ``mask_fn(q_positions, kv_positions)`` gives (Sq, chunk), or
    (B, Sq, chunk) where each row has its own positions (the engine's
    decode)."""
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    groups = H // k.shape[2]
    scale = cfg.query_scale or (1.0 / math.sqrt(D))
    qf = (q * scalar_in(scale, q.dtype)).float()
    chunk = min(cfg.kv_chunk, Skv)
    n_chunks = -(-Skv // chunk)
    m = torch.full((B, H, Sq), -math.inf, dtype=torch.float32, device=q.device)
    den = torch.zeros((B, H, Sq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, H, Sq, D), dtype=torch.float32, device=q.device)
    for ci in range(n_chunks):
        lo = ci * chunk
        kb = k[:, lo:lo + chunk]
        vb = v[:, lo:lo + chunk]
        width = kb.shape[1]
        if width < chunk:  # the reference pads the last chunk with zeros
            kb = torch.nn.functional.pad(kb, (0, 0, 0, 0, 0, chunk - width))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, 0, 0, chunk - width))
        kv_pos = lo + torch.arange(chunk, device=q.device)
        kbh = torch.repeat_interleave(kb, groups, dim=2).float()      # (B, chunk, H, D)
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kbh)
        if cfg.softcap:
            s = torch.tanh(s / cfg.softcap) * cfg.softcap
        msk = mask_fn(q_positions, kv_pos)
        if msk.dim() == 3:  # per-row positions: (B, Sq, chunk) over the heads
            msk = msk.unsqueeze(1)
        s = s.masked_fill(~msk, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new.unsqueeze(-1))
        den = den * alpha + p.sum(dim=-1)
        vbh = torch.repeat_interleave(vb, groups, dim=2).float()
        acc = acc * alpha.unsqueeze(-1) + torch.einsum("bhqk,bkhd->bhqd", p, vbh)
        m = m_new
    out = acc / torch.clamp(den, min=1e-30).unsqueeze(-1)
    return out.transpose(1, 2).to(q.dtype)  # (B, Sq, H, D)


def _causal_skip_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           cfg: AttnConfig, q_positions: torch.Tensor) -> torch.Tensor:
    """Exact-FLOPs causal attention: a Python loop over q chunks, each
    attending only to its static KV prefix (plus window clipping)."""
    Sq = q.shape[1]
    chunk = min(cfg.kv_chunk, Sq)
    n_q = -(-Sq // chunk)
    outs = []
    for qi in range(n_q):
        q_lo, q_hi = qi * chunk, min((qi + 1) * chunk, Sq)
        kv_lo = 0 if cfg.window is None else max(0, q_lo - cfg.window)

        def mask_fn(qpos, kpos, _off=kv_lo):
            kabs = kpos + _off
            msk = qpos[:, None] >= kabs[None, :]
            if cfg.window is not None:
                msk &= kabs[None, :] > qpos[:, None] - cfg.window
            return msk

        outs.append(_online_softmax_chunked(
            q[:, q_lo:q_hi], k[:, kv_lo:q_hi], v[:, kv_lo:q_hi], mask_fn, cfg,
            q_positions[q_lo:q_hi]))
    return torch.cat(outs, dim=1)


def _decode_write(cache: torch.Tensor, new: torch.Tensor, at: torch.Tensor) -> None:
    """Write ``new`` (B, Sq, KV, D) into ``cache`` (B, S, KV, D) in place:
    at positions ``at`` (Sq,) shared by every row, or (B, Sq) per row."""
    new = new.to(cache.dtype)
    if at.dim() == 1:
        cache[:, at] = new
    else:
        rows = torch.arange(cache.shape[0], device=cache.device).unsqueeze(1)
        cache[rows, at] = new


def attention_fwd(
    params: Params,
    x: torch.Tensor,
    cfg: AttnConfig,
    *,
    positions: torch.Tensor,
    mode: str = "train",                              # train | prefill | decode
    cache: Optional[Dict[str, torch.Tensor]] = None,  # {"k": (B,S,KV,D), "v": ...[, "pos"]}
    prefix_len: Optional[int] = None,                 # PrefixLM: bidirectional prefix
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """One attention sublayer: returns (out, cache). ``positions`` is (S,)
    or (B, S). In ``decode`` mode the new K/V are written into ``cache`` in
    place (the reference returns an updated copy) at ``positions``: (S,)
    is shared by every row; (B, S) with B > 1 gives each row its own
    positions (the engine's slots), and each row masks by its own (the
    reference vmaps a batch-1 decode for that). A ring cache (``"pos"``, a
    windowed layer's cache with ``decode_window_cache``) takes shared
    positions only. ``prefill`` also returns the prompt's K/V."""
    B = x.shape[0]
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = x @ params["wq"]
    kx = x @ params["wk"]
    vx = x @ params["wv"]
    if cfg.qkv_bias:
        q, kx, vx = q + params["bq"], kx + params["bk"], vx + params["bv"]
    q = q.reshape(B, -1, h, d)
    kx = kx.reshape(B, -1, kv, d)
    vx = vx.reshape(B, -1, kv, d)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    kx = apply_rope(kx, positions, theta=cfg.rope_theta)

    if mode == "decode":
        if cache is None:
            raise ValueError("decode needs a cache")
        per_row = positions.dim() > 1 and positions.shape[0] > 1
        idx = positions if per_row else (positions[0] if positions.dim() > 1 else positions)
        if "pos" in cache:
            if per_row:
                raise ValueError("a ring cache takes positions shared by every row")
            # ring buffer for windowed layers: O(window) memory at any context
            W = cache["k"].shape[1]
            slots = (idx[0] + torch.arange(idx.shape[0], device=idx.device)) % W
            _decode_write(cache["k"], kx, slots)
            _decode_write(cache["v"], vx, slots)
            cache["pos"][slots] = idx.to(cache["pos"].dtype)
            cpos = cache["pos"]

            def mask_fn(qpos, kidx):
                # absolute positions of the ring's slots; a padded last chunk's
                # indices past the ring hold no key
                kp = cpos[kidx.clamp(max=W - 1)]
                msk = (qpos[:, None] >= kp[None, :]) & (kp[None, :] >= 0) & (kidx < W)[None, :]
                if cfg.window is not None:
                    msk &= kp[None, :] > qpos[:, None] - cfg.window
                return msk
        else:
            at = idx if per_row else idx[0] + torch.arange(idx.shape[0], device=idx.device)
            _decode_write(cache["k"], kx, at)
            _decode_write(cache["v"], vx, at)

            def mask_fn(qpos, kpos):
                if qpos.dim() == 2:  # per row: (B, Sq, chunk)
                    msk = qpos[:, :, None] >= kpos[None, None, :]
                    if cfg.window is not None:
                        msk &= kpos[None, None, :] > qpos[:, :, None] - cfg.window
                    return msk
                msk = qpos[:, None] >= kpos[None, :]
                if cfg.window is not None:
                    msk &= kpos[None, :] > qpos[:, None] - cfg.window
                return msk

        out = _online_softmax_chunked(q, cache["k"], cache["v"], mask_fn, cfg, idx)
        new_cache = cache
    else:
        # prefill (engine-facing): the same causal pass as train, handing back
        # the prompt's K/V, the prompt prefix of a full decode cache
        new_cache = {"k": kx, "v": vx} if mode == "prefill" else None
        qpos = positions[0] if positions.dim() > 1 else positions
        if cfg.causal_skip and prefix_len is None:
            out = _causal_skip_attention(q, kx, vx, cfg, qpos)
        else:

            def mask_fn(qp, kp):
                msk = qp[:, None] >= kp[None, :]
                if prefix_len is not None:
                    # PrefixLM: full attention within the prefix
                    msk |= (qp[:, None] < prefix_len) & (kp[None, :] < prefix_len)
                if cfg.window is not None:
                    win_ok = kp[None, :] > qp[:, None] - cfg.window
                    if prefix_len is not None:
                        win_ok |= (qp[:, None] < prefix_len) & (kp[None, :] < prefix_len)
                    msk &= win_ok
                return msk

            out = _online_softmax_chunked(q, kx, vx, mask_fn, cfg, qpos)
    out = out.reshape(B, -1, h * d)
    return out @ params["wo"], new_cache


def cross_attention_fwd(params: Params, x: torch.Tensor, memory: torch.Tensor,
                        cfg: AttnConfig) -> torch.Tensor:
    """Encoder-decoder cross attention (Whisper): ``x`` (B, Sq, d_model)
    attends to all of ``memory`` (B, Sm, d_model). As the reference's, it
    reads ``wq``, ``wk``, ``wv`` and ``wo`` and no biases, applies no RoPE,
    and masks nothing: the zero keys that pad ``memory``'s last KV chunk
    take part in the softmax as they do there."""
    B = x.shape[0]
    h, kv, d = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = (x @ params["wq"]).reshape(B, -1, h, d)
    k = (memory @ params["wk"]).reshape(B, -1, kv, d)
    v = (memory @ params["wv"]).reshape(B, -1, kv, d)

    def mask_fn(qp, kp):
        return torch.ones((qp.shape[0], kp.shape[0]), dtype=torch.bool, device=qp.device)

    qpos = torch.arange(x.shape[1], device=x.device)
    out = _online_softmax_chunked(q, k, v, mask_fn, cfg, qpos)
    return out.reshape(B, -1, h * d) @ params["wo"]


# ---------------------------------------------------------------------------
# FFN variants
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SparseFFNConfig:
    """SET sparse FFN (the paper's technique in the LM zoo)."""

    epsilon: float = 64.0
    block_m: int = 128
    block_n: int = 128
    activation: str = "all_relu"
    alpha: float = 0.6
    density: Optional[float] = None  # overrides epsilon if set


def init_gated_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    return {
        "wi_gate": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "wi_up": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "wo": dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
    }


def gated_ffn_fwd(params: Params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = activation_fn(activation)
    g = act(x @ params["wi_gate"], 1)
    u = x @ params["wi_up"]
    return (g * u) @ params["wo"]


def init_plain_ffn(gen: torch.Generator, d_model: int, d_ff: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    """2-layer MLP with biases (Whisper's)."""
    return {
        "fc1": dense_init(gen, (d_model, d_ff), d_model, dtype, device),
        "b1": torch.zeros((d_ff,), dtype=dtype, device=device),
        "fc2": dense_init(gen, (d_ff, d_model), d_ff, dtype, device),
        "b2": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def plain_ffn_fwd(params: Params, x: torch.Tensor, activation: str = "gelu") -> torch.Tensor:
    act = activation_fn(activation)
    return act(x @ params["fc1"] + params["b1"], 1) @ params["fc2"] + params["b2"]


def init_sparse_ffn(rng: np.random.Generator, d_model: int, d_ff: int, sc: SparseFFNConfig,
                    dtype: torch.dtype, device: torch.device):
    """Block-sparse W_in/W_out with host topologies, the reference's numpy
    draws in its order (t_in, t_out, then their values). Returns
    (params, (t_in, t_out), (meta_in, meta_out))."""
    meta_in = BlockMeta(d_model, d_ff, sc.block_m, sc.block_n)
    meta_out = BlockMeta(d_ff, d_model, sc.block_m, sc.block_n)
    if sc.density is not None:
        t_in = BlockTopology.erdos_renyi(meta_in, sc.density, rng)
        t_out = BlockTopology.erdos_renyi(meta_out, sc.density, rng)
    else:
        t_in = BlockTopology.from_epsilon(meta_in, sc.epsilon, rng)
        t_out = BlockTopology.from_epsilon(meta_out, sc.epsilon, rng)
    params = {
        "win": t_in.init_values(rng, dtype=dtype, device=device),
        "wout": t_out.init_values(rng, dtype=dtype, device=device),
    }
    return params, (t_in, t_out), (meta_in, meta_out)


def sparse_ffn_fwd(params: Params, topo_in: BlockTopoArrays, topo_out: BlockTopoArrays,
                   metas: Tuple[BlockMeta, BlockMeta], x: torch.Tensor, sc: SparseFFNConfig,
                   layer_index: int, impl: str = "kernel") -> torch.Tensor:
    """W_in with All-ReLU of the layer's parity in its store (kernel C, no
    bias), then W_out (kernel C), in x's dtype: two launches a layer in
    bfloat16 (in f32, kernel B follows W_in: C's f32 instance has no
    epilogue). The reference runs its plain ``bsmm_xla`` here, which rounds
    each tile's product to the model dtype before it adds a column's tiles;
    kernel C and its plain version round once, so in bfloat16 the two differ
    by bf16 rounding where a column holds more than one tile (equal in f32
    to within the sums' order).

    Where autograd records (training), each weight runs ``bsmm_kernel``
    (kernel C forward; kernels D and E backward) and All-ReLU runs between
    them as plain autograd, the reference's ``act(h, layer_index)``: C's
    store keeps no branch mask, so it has no backward. The forward's bits
    are the same on both paths: the store rounds C's f32 sum to the dtype,
    then applies ``core.all_relu.all_relu``'s arithmetic.

    ``impl="xla"`` runs the reference's own formulation instead, ``bsmm_xla``
    (plain autograd PyTorch) around All-ReLU: the oracle the kernel path is
    held to on the card."""
    if sc.activation != "all_relu":
        raise ValueError(f"the sparse FFN runs All-ReLU, not {sc.activation!r}")
    meta_in, meta_out = metas
    win, wout = params["win"], params["wout"]
    if impl == "xla":
        h = all_relu(kops.bsmm_xla(x, win, topo_in, meta_in), sc.alpha, layer_index)
        return kops.bsmm_xla(h, wout, topo_out, meta_out)
    if impl != "kernel":
        raise ValueError(f"unknown sparse FFN impl {impl!r}")
    if torch.is_grad_enabled() and (x.requires_grad or win.requires_grad
                                    or wout.requires_grad):
        h = all_relu(kops.bsmm_kernel(x, win, topo_in, meta_in), sc.alpha, layer_index)
        return kops.bsmm_kernel(h, wout, topo_out, meta_out)
    h = kops.bsmm_infer(x, win, topo_in, meta_in, all_relu=(sc.alpha, layer_index))
    return kops.bsmm_infer(h, wout, topo_out, meta_out)


# ---------------------------------------------------------------------------
# embeddings
# ---------------------------------------------------------------------------


def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype: torch.dtype,
                   device: torch.device) -> Params:
    return {"table": dense_init(gen, (vocab, d_model), d_model, dtype, device)}


def embed(params: Params, tokens: torch.Tensor) -> torch.Tensor:
    return params["table"][tokens]


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["table"].T
