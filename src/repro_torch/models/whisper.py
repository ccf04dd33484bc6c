"""Whisper backbone (encoder-decoder, arXiv:2212.04356), conv frontend
stubbed. Twin of ``repro.models.whisper``.

As in the reference, the modality frontend is a stub: ``encode`` takes
precomputed log-mel *frame embeddings* (B, frames, d_model) straight into
the encoder (the two conv layers are not part of the backbone).

Encoder: bidirectional self-attention (``attention_fwd(...,
prefix_len=frames)``) + plain GELU FFN, sinusoidal positions. Decoder:
causal self-attention + cross-attention to the encoder's output + plain
FFN, learned positions. The parameters keep the reference's leaf names,
stacking and dtypes: ``params["enc"]`` and ``params["dec"]`` hold each
leaf stacked over the layers, and the stacks are Python loops over
per-layer views of them (``torch.unbind``, whose backward stacks the
layers' gradients); with ``remat="block"`` each layer runs under
``torch.utils.checkpoint`` where autograd records, as the reference
checkpoints its scan body. Every product is dense (``torch.matmul``), as
XLA computes it there: the reference's Whisper runs no Pallas kernel.

The weights draw the reference's distributions (``dense_init``, zero
biases, layernorm ones) from one ``torch.Generator`` on the model's
device, seeded with ``seed``; they are not jax.random's draws, which the
parity tests carry over with ``interop.whisper_from_numpy``.

``decode_step`` writes the self-attention cache in place (the reference
returns an updated copy); cross attention recomputes the memory's K and V
every step, as the reference does.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["WhisperConfig", "WhisperModel"]


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int          # per stack (medium: 24 + 24)
    n_heads: int
    head_dim: int
    d_ff: int
    n_frames: int = 1500   # encoder positions (30s audio)
    max_text: int = 448
    dtype: str = "bfloat16"
    kv_chunk: int = 1024
    remat: str = "block"

    def attn_cfg(self) -> L.AttnConfig:
        return L.AttnConfig(
            n_heads=self.n_heads,
            n_kv=self.n_heads,   # MHA
            head_dim=self.head_dim,
            d_model=self.d_model,
            qkv_bias=True,
            rope_theta=10000.0,  # RoPE is applied in self-attention, as in the reference
            kv_chunk=self.kv_chunk,
        )


def _unstack(stacked, n: int):
    """Per-layer views of a stacked tree: ``n`` trees of ``unbind(0)``
    slices."""
    leaves, unflatten = tree_flatten(stacked)
    parts = [a.unbind(0) for a in leaves]
    return [unflatten([p[i] for p in parts]) for i in range(n)]


class WhisperModel:
    """Builds the parameters and exposes the encoder, the teacher-forced
    decoder and the decode step. ``device=None`` means the card; without
    one it raises (pass ``device="cpu"`` for the CPU). ``specs`` holds every
    parameter's logical-axis names (the reference's); ``abstract=True``
    builds on the ``meta`` device, drawing nothing (the dry run)."""

    def __init__(self, cfg: WhisperConfig, seed: int = 0, device=None, abstract: bool = False):
        if cfg.remat not in ("block", "none"):
            raise ValueError(f"remat must be 'block' or 'none', not {cfg.remat!r}")
        self.cfg = cfg
        self._seed = seed
        self.device = torch.device("meta") if abstract else resolve_device(device)
        self.specs = self._specs()
        self.params = self._build()

    def _specs(self) -> Dict:
        """Every parameter's logical-axis names, the reference's tree."""
        acfg = self.cfg.attn_cfg()
        ln = L.layernorm_specs

        def stack(tree):
            return tree_map(lambda s: ("stack",) + s, tree,
                            is_leaf=lambda x: isinstance(x, tuple))

        return {
            "enc": stack({"ln1": ln(), "attn": L.attention_specs(acfg), "ln2": ln(),
                          "ffn": L.plain_ffn_specs()}),
            "dec": stack({"ln1": ln(), "self_attn": L.attention_specs(acfg), "ln2": ln(),
                          "cross_attn": L.attention_specs(acfg), "ln3": ln(),
                          "ffn": L.plain_ffn_specs()}),
            "enc_final_ln": ln(),
            "dec_final_ln": ln(),
            "tok_embed": ("vocab", "embed"),
            "pos_embed": (None, "embed"),
        }

    def _build(self) -> Dict:
        """The reference's tree and build order (per encoder layer its
        attention then its FFN, per decoder layer self-attention,
        cross-attention, FFN; then ``tok_embed`` and ``pos_embed``), drawn
        from one generator on the model's device, each stack straight into
        its stacked leaves (``layers.draw_stacked``)."""
        cfg, dev = self.cfg, self.device
        dtype = getattr(torch, cfg.dtype)
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(self._seed)
        acfg = cfg.attn_cfg()

        def ln():
            return L.init_layernorm(cfg.d_model, dtype, dev)

        def enc_layer(into):
            sub = (into or {}).get
            attn = L.init_attention(gen, acfg, dtype, dev, sub("attn"))
            ffn = L.init_plain_ffn(gen, cfg.d_model, cfg.d_ff, dtype, dev, sub("ffn"))
            return {"ln1": ln(), "attn": attn, "ln2": ln(), "ffn": ffn}

        def dec_layer(into):
            sub = (into or {}).get
            sa = L.init_attention(gen, acfg, dtype, dev, sub("self_attn"))
            ca = L.init_attention(gen, acfg, dtype, dev, sub("cross_attn"))
            ffn = L.init_plain_ffn(gen, cfg.d_model, cfg.d_ff, dtype, dev, sub("ffn"))
            return {"ln1": ln(), "self_attn": sa, "ln2": ln(), "cross_attn": ca,
                    "ln3": ln(), "ffn": ffn}

        return {
            "enc": L.draw_stacked(cfg.n_layers, enc_layer),
            "dec": L.draw_stacked(cfg.n_layers, dec_layer),
            "enc_final_ln": ln(),
            "dec_final_ln": ln(),
            "tok_embed": L.dense_init(gen, (cfg.vocab, cfg.d_model), cfg.d_model, dtype, dev),
            "pos_embed": L.dense_init(gen, (cfg.max_text, cfg.d_model), cfg.d_model, dtype,
                                      dev),
        }

    @property
    def n_params(self) -> int:
        leaves, _ = tree_flatten(self.params)
        return sum(int(a.numel()) for a in leaves)

    def _run_stack(self, fn, h: torch.Tensor, layers) -> torch.Tensor:
        remat = self.cfg.remat == "block" and torch.is_grad_enabled()
        for lp in layers:
            if remat:
                h = checkpoint(fn, h, lp, use_reentrant=False, preserve_rng_state=False)
            else:
                h = fn(h, lp)
        return h

    # -- encoder ---------------------------------------------------------------

    @staticmethod
    def _sinusoid(n_pos: int, d: int, dtype: torch.dtype, device) -> torch.Tensor:
        """Sinusoidal positions, computed in f32 and then cast."""
        pos = torch.arange(n_pos, dtype=torch.float32, device=device)[:, None]
        dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
        ang = pos / torch.pow(torch.tensor(10000.0, device=device), 2 * dim / d)
        return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)

    def encode(self, params, frame_embeds: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        acfg = cfg.attn_cfg()
        Sf = frame_embeds.shape[1]
        h = frame_embeds + self._sinusoid(Sf, cfg.d_model, frame_embeds.dtype,
                                          frame_embeds.device)
        positions = torch.arange(Sf, device=h.device)

        def body(h, lp):
            # bidirectional: the whole window is the prefix
            a, _ = L.attention_fwd(lp["attn"], L.layernorm(lp["ln1"], h), acfg,
                                   positions=positions, mode="train", prefix_len=Sf)
            h = h + a
            return h + L.plain_ffn_fwd(lp["ffn"], L.layernorm(lp["ln2"], h))

        h = self._run_stack(body, h, _unstack(params["enc"], cfg.n_layers))
        return L.layernorm(params["enc_final_ln"], h)

    # -- decoder ---------------------------------------------------------------

    def decode_train(self, params, tokens: torch.Tensor, memory: torch.Tensor) -> torch.Tensor:
        """Teacher-forced decoder; returns hidden states (B, S, d)."""
        cfg = self.cfg
        acfg = cfg.attn_cfg()
        S = tokens.shape[1]
        h = params["tok_embed"][tokens] + params["pos_embed"][:S]
        positions = torch.arange(S, device=h.device)

        def body(h, lp):
            a, _ = L.attention_fwd(lp["self_attn"], L.layernorm(lp["ln1"], h), acfg,
                                   positions=positions, mode="train")
            h = h + a
            h = h + L.cross_attention_fwd(lp["cross_attn"], L.layernorm(lp["ln2"], h),
                                          memory, acfg)
            return h + L.plain_ffn_fwd(lp["ffn"], L.layernorm(lp["ln3"], h))

        h = self._run_stack(body, h, _unstack(params["dec"], cfg.n_layers))
        return L.layernorm(params["dec_final_ln"], h)

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        return h @ params["tok_embed"].T

    # -- decode step (serving) ---------------------------------------------------

    def init_caches(self, batch: int, max_len: int, memory: Optional[torch.Tensor] = None,
                    dtype: torch.dtype = torch.bfloat16):
        """Zero self-attention caches, ``{"self": {"k", "v"}}`` each
        (n_layers, B, max_len, H, D); ``memory`` is unused, as in the
        reference."""
        cfg = self.cfg
        shape = (cfg.n_layers, batch, max_len, cfg.n_heads, cfg.head_dim)
        return {"self": {"k": torch.zeros(shape, dtype=dtype, device=self.device),
                         "v": torch.zeros(shape, dtype=dtype, device=self.device)}}

    def decode_step(self, params, tokens: torch.Tensor, pos, caches, memory: torch.Tensor):
        """tokens: (B, 1); pos: a scalar position shared by every row;
        memory: the encoder's output. Returns ``(logits, caches)``, the
        caches written in place."""
        cfg = self.cfg
        acfg = cfg.attn_cfg()
        pos_t = torch.as_tensor(pos, device=tokens.device).reshape(1).long()
        h = params["tok_embed"][tokens] + params["pos_embed"].index_select(0, pos_t)
        ck, cv = caches["self"]["k"], caches["self"]["v"]
        for l, lp in enumerate(_unstack(params["dec"], cfg.n_layers)):
            a, _ = L.attention_fwd(lp["self_attn"], L.layernorm(lp["ln1"], h), acfg,
                                   positions=pos_t, mode="decode",
                                   cache={"k": ck[l], "v": cv[l]})
            h = h + a
            h = h + L.cross_attention_fwd(lp["cross_attn"], L.layernorm(lp["ln2"], h),
                                          memory, acfg)
            h = h + L.plain_ffn_fwd(lp["ffn"], L.layernorm(lp["ln3"], h))
        h = L.layernorm(params["dec_final_ln"], h)
        return self.logits(params, h), caches
