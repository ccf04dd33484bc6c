"""input_specs(): ``meta`` tensors standing in for every model input (shape
and dtype, zero allocation) and their logical axis specs. Twin of
``repro.launch.specs``.

Shape semantics per family:
  LM        train/prefill: tokens (B, S); decode: one token + KV cache of S.
  VLM       prefix_tokens patch embeddings (stub SigLIP) + text tokens filling
            the rest of S.
  audio     S = encoder frames (stub conv frontend); train/prefill pair the
            encoder with a 448-token teacher-forced decoder; decode = decoder
            self-cache of S with cross-attention to a 1500-frame memory.

Token ids are int64, as the port's steps take them (the reference's are
int32); everything else has the reference's dtype.
"""
from __future__ import annotations

import copy
from typing import Any, Dict, Tuple

import torch

from repro_torch.configs import SHAPES, ArchSpec
from repro_torch.launch.sharding import is_spec_leaf
from repro_torch.models.whisper import WhisperConfig
from repro_torch.tree import tree_map

__all__ = ["input_specs"]

_META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=_META)


def _meta_caches(model, B: int, S: int, dtype: torch.dtype):
    """``model.init_caches(B, S)`` built on the meta device."""
    shadow = copy.copy(model)
    shadow.device = _META
    return shadow.init_caches(B, S, dtype=dtype)


def input_specs(spec: ArchSpec, shape_id: str, model, *, model_axis: int = 16
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Returns (inputs, logical_specs) for the given (arch, shape) cell.
    model_axis: TP degree; decides the KV-cache sharding fallback."""
    sh = SHAPES[shape_id]
    B, S, kind = sh["global_batch"], sh["seq_len"], sh["kind"]
    cfg = spec.config
    tok = torch.int64

    if isinstance(cfg, WhisperConfig):
        return _whisper_specs(spec, model, B, S, kind)

    if kind in ("train", "prefill"):
        if spec.family == "vlm":
            text = S - spec.prefix_tokens
            inputs = {
                "tokens": _sds((B, text), tok),
                "patch_embeds": _sds((B, spec.prefix_tokens, cfg.d_model),
                                     getattr(torch, cfg.dtype)),
            }
            logical = {"tokens": ("batch", "seq"), "patch_embeds": ("batch", "seq", None)}
        else:
            inputs = {"tokens": _sds((B, S), tok)}
            logical = {"tokens": ("batch", "seq")}
        if kind == "train":
            inputs["labels"] = _sds((B, S), tok)
            logical["labels"] = ("batch", "seq")
        return inputs, logical

    # decode: one new token against a cache of length S
    caches = _meta_caches(model, B, S, getattr(torch, cfg.dtype))
    cache_logical = model.cache_specs()
    if getattr(cfg, "n_kv", 0) and cfg.n_kv % model_axis != 0:
        # kv heads don't divide TP: shard cache SEQ over 'model' instead of
        # replicating the whole cache on every model shard
        def fix(spec_leaf):
            t = tuple(spec_leaf)
            if len(t) >= 4 and "kv_heads" in t:
                t = tuple("cache_seq_model" if name == "cache_seq"
                          else (None if name == "kv_heads" else name) for name in t)
            return t

        cache_logical = tree_map(fix, cache_logical, is_leaf=is_spec_leaf)
    inputs = {"tokens": _sds((B, 1), tok), "position": _sds((), tok), "caches": caches}
    logical = {"tokens": ("batch", None), "position": None, "caches": cache_logical}
    return inputs, logical


def _whisper_specs(spec: ArchSpec, model, B, S, kind):
    cfg: WhisperConfig = spec.config
    dt = getattr(torch, cfg.dtype)
    tok = torch.int64
    if kind in ("train", "prefill"):
        dec_len = min(448, cfg.max_text)
        inputs = {"frames": _sds((B, S, cfg.d_model), dt)}
        logical = {"frames": ("batch", "seq", None)}
        inputs["tokens"] = _sds((B, dec_len), tok)
        logical["tokens"] = ("batch", "seq")
        if kind == "train":
            inputs["labels"] = _sds((B, dec_len), tok)
            logical["labels"] = ("batch", "seq")
        return inputs, logical
    # decode: decoder self-cache of length S, cross-attn memory of 1500 frames
    inputs = {
        "tokens": _sds((B, 1), tok),
        "position": _sds((), tok),
        "caches": _meta_caches(model, B, S, dt),
        "memory": _sds((B, 1500, cfg.d_model), dt),
    }
    logical = {
        "tokens": ("batch", None),
        "position": None,
        "caches": {
            "self": {
                "k": (None, "batch", "cache_seq", "kv_heads", None),
                "v": (None, "batch", "cache_seq", "kv_heads", None),
            }
        },
        "memory": ("batch", None, None),
    }
    return inputs, logical
