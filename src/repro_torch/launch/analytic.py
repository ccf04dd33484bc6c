"""Closed-form MODEL_FLOPS per (arch, shape), the roofline's numerator. Twin
of ``repro.launch.analytic``, copied as it is.

MODEL_FLOPS counts only the *useful* math the model defines (PaLM-style):
matmul params x tokens (x6 for train: fwd 2 + bwd 4; x2 for prefill/decode)
plus the attention score/value term 12*S*H*hd per token per attention layer
(x3 ratio for train). MoE counts ACTIVE expert params only (6*N_active*D).
The ratio MODEL_FLOPS / recorded FLOPs (``launch.dryrun``'s ``flops``, from
``launch.hlo_analysis``) measures how much of the executed compute is
useful (remat recompute, masked-causal waste, capacity-factor overcompute
and dispatch all show up there).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs import SHAPES, ArchSpec
from repro_torch.models.whisper import WhisperConfig

__all__ = ["model_flops", "param_counts"]


def _lm_matmul_params(cfg) -> Dict[str, float]:
    """Per-layer-kind matmul params for PatternLM configs."""
    d = cfg.d_model
    counts = {}
    attn = d * (cfg.n_heads * cfg.head_dim) * 2 + d * (cfg.n_kv * cfg.head_dim) * 2
    if cfg.ffn == "gated":
        ffn_active = 3 * d * cfg.d_ff
        ffn_router = 0.0
    elif cfg.ffn == "moe":
        ffn_active = 3 * d * cfg.expert_d_ff * cfg.top_k
        ffn_router = d * cfg.n_experts
    else:  # sparse: live blocks only (2 sparse matmuls, no gate)
        from repro_torch.core.sparsity import density_from_epsilon

        dens = (
            cfg.sparse_density
            if cfg.sparse_density is not None
            else density_from_epsilon(cfg.sparse_epsilon, d, cfg.d_ff)
        )
        ffn_active = 2 * d * cfg.d_ff * dens
        ffn_router = 0.0
    counts["attn"] = attn
    counts["ffn"] = ffn_active + ffn_router
    counts["mamba"] = (
        2 * d * cfg.d_inner              # in_proj
        + cfg.d_inner * (max(1, d // 16) + 2 * cfg.d_state)  # x_proj
        + max(1, d // 16) * cfg.d_inner  # dt_proj
        + cfg.d_inner * d                # out_proj
    )
    counts["rglru"] = 2 * d * cfg.d_rnn + 2 * cfg.d_rnn * cfg.d_rnn + cfg.d_rnn * d
    counts["logits"] = d * cfg.vocab
    return counts


def param_counts(cfg) -> Dict[str, float]:
    """(active_matmul_params_per_token, attention_layers) summed over depth."""
    c = _lm_matmul_params(cfg)
    per_layer = []
    n_attn = 0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        if kind in ("global", "local"):
            per_layer.append(c["attn"] + c["ffn"])
            n_attn += 1
        elif kind == "mamba":
            per_layer.append(c["mamba"])
        elif kind == "rglru":
            per_layer.append(c["rglru"] + c["ffn"])
            n_attn += 1  # local attn every pattern — handled below
        else:
            raise ValueError(kind)
    n_attn = sum(
        1 for i in range(cfg.n_layers)
        if cfg.pattern[i % len(cfg.pattern)] in ("global", "local")
    )
    return {
        "active_per_token": sum(per_layer) + c["logits"],
        "n_attn_layers": n_attn,
    }


def _attn_flops_per_token(cfg, kv_len: int, n_attn: int) -> float:
    """12 * kv * H * hd per attention layer-token (score + value matmuls,
    fwd+... x1; caller scales for train)."""
    if getattr(cfg, "n_heads", 0) == 0:
        return 0.0
    window = getattr(cfg, "window", None)
    per_layer = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        if kind == "local":
            eff = min(window or kv_len, kv_len)
        elif kind == "global":
            eff = kv_len
        else:
            continue
        per_layer += 4.0 * eff * cfg.n_heads * cfg.head_dim  # 2 matmuls x2 flops
    return per_layer


def model_flops(spec: ArchSpec, shape_id: str) -> Dict[str, float]:
    sh = SHAPES[shape_id]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    cfg = spec.config

    if isinstance(cfg, WhisperConfig):
        d = cfg.d_model
        attn_p = 4 * d * cfg.n_heads * cfg.head_dim
        ffn_p = 2 * d * cfg.d_ff
        enc_per_tok = cfg.n_layers * (attn_p + ffn_p)
        dec_per_tok = cfg.n_layers * (2 * attn_p + ffn_p) + d * cfg.vocab
        if kind in ("train", "prefill"):
            dec_len = min(448, cfg.max_text)
            enc_tokens = B * S
            dec_tokens = B * dec_len
            fwd = 2 * (enc_per_tok * enc_tokens + dec_per_tok * dec_tokens)
            # quadratic attention terms
            fwd += enc_tokens * 4 * S * cfg.n_heads * cfg.head_dim * cfg.n_layers
            fwd += dec_tokens * 4 * (dec_len + S) * cfg.n_heads * cfg.head_dim * cfg.n_layers
            total = 3 * fwd if kind == "train" else fwd
        else:  # decode
            toks = B
            total = 2 * dec_per_tok * toks
            total += toks * 4 * (S + 1500) * cfg.n_heads * cfg.head_dim * cfg.n_layers
        return {"model_flops": float(total), "tokens": float(B * S)}

    pc = param_counts(cfg)
    n_active = pc["active_per_token"]
    if kind in ("train", "prefill"):
        tokens = B * S
        # average causal kv length = S/2 for the quadratic term
        attn = tokens * _attn_flops_per_token(cfg, S // 2, pc["n_attn_layers"])
        fwd = 2 * n_active * tokens + attn
        total = 3 * fwd if kind == "train" else fwd
    else:
        tokens = B  # one token per sequence
        attn = tokens * _attn_flops_per_token(cfg, S, pc["n_attn_layers"])
        total = 2 * n_active * tokens + attn
    return {"model_flops": float(total), "tokens": float(tokens)}
