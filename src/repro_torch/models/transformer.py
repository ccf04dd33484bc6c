"""PatternLM, the pattern-scan language model covering the whole zoo. Twin
of ``repro.models.transformer``.

An architecture is a repeating ``pattern`` of block kinds:

  'global'  full causal GQA attention + FFN     (qwen, internlm, paligemma, ...)
  'local'   sliding-window GQA attention + FFN  (gemma local layers, mixtral SWA)
  'mamba'   Mamba-1 SSM block (no FFN)          (falcon-mamba)
  'rglru'   RG-LRU recurrent block + FFN        (recurrentgemma)

:class:`HybridConfig`'s ``slot_ffn`` gives each pattern slot its own FFN
kind (Jamba's period of 8: Mamba with a dense or an MoE FFN, attention
without RoPE with a dense one); without it every attention and RG-LRU slot
takes ``ffn`` and a Mamba slot none, as above. A slot whose FFN kind is
``none`` has no ``ln2`` and no ``ffn`` leaves.

``n_layers = n_rep * len(pattern) + remainder``. The parameter tree is the
reference's, so a checkpoint has the same leaf names in both packages:
``params["stack"][f"s{i}_{kind}"]`` holds each pattern slot's layers stacked
on a leading ``n_rep`` axis, ``params["rest"]`` the remainder layers as a
list, and ``params["embed"]``, ``params["final_norm"]`` (and
``params["unembed"]`` where the embeddings are untied). The FFN of a block
is ``gated`` (the dense baseline), ``sparse`` (the paper's SET
block-sparse FFN with All-ReLU, on kernel C: All-ReLU in W_in's store) or
``moe`` (``models.moe``, whose auxiliary loss the forward sums over the
layers).

The reference runs the repeats under one ``lax.scan``; here a Python loop
visits the layers in the same order (repeat-major, then pattern slot), with
the same 1-based layer index for All-ReLU's parity. The reference's
``scan_barrier`` argument (an XLA optimisation barrier between scan
iterations) means nothing to eager PyTorch: the forward takes none.
``remat="block"`` (the reference's ``jax.checkpoint`` of the scan body)
wraps each stacked layer in ``torch.utils.checkpoint`` where autograd
records in ``train`` mode: its activations are recomputed in the backward,
which changes memory, not numbers.

Each layer's topology arrays are views memoized per topology: the same
tensor objects on every call, so the block kernels' per-topology checks
and offsets run once. Each stacked weight is split into its repeats once a
forward (``torch.unbind``, whose backward stacks the repeats' gradients
once); the views of one (params, topology) pair are memoized where
autograd does not record (serving), and made anew where it does, since they
belong to one graph. :func:`chunked_softmax_xent` is the training loss.

Decode writes every cache in place: attention's K/V at the step's
positions, and a recurrent block's state (``models.mamba``,
``models.griffin``) with the new one. As in the reference, a recurrent
block keeps no state in ``train`` or ``prefill`` mode: ``prefill`` returns
none for it.

``model.specs`` holds every parameter's logical-axis names, the
reference's tree and tuples (``launch.sharding`` maps them onto a mesh),
and ``cache_specs()`` the decode caches'. ``abstract=True`` is the dry
run's shape-only build: the parameters on the ``meta`` device, no dense
draws; the sparse FFN's host topologies (and the numpy value draws that
the topologies' stream runs through) are drawn as in the reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.sparsity import BlockMeta, BlockTopoArrays
from repro_torch.device import resolve_device
from repro_torch.kernels.ref import scalar_in
from repro_torch.models import layers as L
from repro_torch.models.griffin import (RGLRUConfig, init_rglru_block, init_rglru_state,
                                        rglru_fwd, rglru_specs)
from repro_torch.models.mamba import (MambaConfig, init_mamba_block, init_mamba_state,
                                      mamba_fwd, mamba_specs)
from repro_torch.models.moe import MoEConfig, init_moe, moe_fwd, moe_specs, pooled_aux
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["HybridConfig", "ModelConfig", "PatternLM", "chunked_softmax_xent"]

Tree = Any
DeviceLike = Optional[Union[str, torch.device]]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    vocab: int
    d_model: int
    n_layers: int
    n_heads: int = 0
    n_kv: int = 0
    head_dim: int = 0
    d_ff: int = 0
    pattern: Tuple[str, ...] = ("global",)
    window: int = 4096
    softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    rope_theta_local: Optional[float] = None   # gemma3: local layers 10k, global 1M
    norm: str = "rms"
    tied_embeddings: bool = True
    embed_scale: bool = False                  # gemma: x *= sqrt(d_model)
    post_norms: bool = False                   # gemma2/3 post-attn/ffn norms
    activation: str = "silu"
    ffn: str = "gated"                         # gated | sparse | moe | none
    # moe
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0
    moe_groups: int = 1
    # ssm / rnn
    d_inner: int = 0
    d_state: int = 16
    d_rnn: int = 0
    # sparse FFN (the paper's technique)
    sparse_epsilon: float = 64.0
    sparse_block: int = 128
    sparse_alpha: float = 0.6
    sparse_density: Optional[float] = None
    # vlm / enc-dec hooks
    prefix_len: int = 0                        # paligemma image-prefix tokens
    # runtime
    dtype: str = "bfloat16"
    kv_chunk: int = 1024
    causal_skip: bool = False
    ssm_chunk: int = 256
    remat: str = "block"                       # block | none
    decode_window_cache: bool = True           # ring buffers for local layers

    # :class:`HybridConfig`'s options, at the values every reference arch
    # has; class attributes, not fields, so that a ``ModelConfig`` is the
    # reference's field for field (``dataclasses.asdict``, checkpoints)
    slot_ffn = None
    rope = True
    mamba_norms = False
    moe_dropless = False
    moe_held = None
    moe_norm_topk = True
    moe_aux_weight = 0.01

    # -- derived -------------------------------------------------------------

    @property
    def n_rep(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def remainder(self) -> int:
        return self.n_layers - self.n_rep * len(self.pattern)

    def ffn_kind(self, slot: int) -> str:
        """The FFN kind of pattern slot ``slot``: ``slot_ffn``'s, else
        none for a Mamba slot and ``ffn`` for the others."""
        if self.slot_ffn is not None:
            return self.slot_ffn[slot]
        return "none" if self.pattern[slot] == "mamba" else self.ffn

    def attn_cfg(self, kind: str) -> L.AttnConfig:
        theta = self.rope_theta
        if kind == "local" and self.rope_theta_local is not None:
            theta = self.rope_theta_local
        return L.AttnConfig(
            n_heads=self.n_heads,
            n_kv=self.n_kv,
            head_dim=self.head_dim,
            d_model=self.d_model,
            qkv_bias=self.qkv_bias,
            softcap=self.softcap,
            window=self.window if kind == "local" else None,
            rope_theta=theta,
            kv_chunk=self.kv_chunk,
            causal_skip=self.causal_skip,
            rope=self.rope,
        )

    def moe_cfg(self) -> MoEConfig:
        return MoEConfig(
            n_experts=self.n_experts,
            top_k=self.top_k,
            d_model=self.d_model,
            d_ff=self.expert_d_ff,
            activation=self.activation,
            groups=self.moe_groups,
            router_aux_weight=self.moe_aux_weight,
            norm_topk_prob=self.moe_norm_topk,
            dropless=self.moe_dropless,
            held=self.moe_held,
        )

    def mamba_cfg(self) -> MambaConfig:
        return MambaConfig(
            d_model=self.d_model,
            d_inner=self.d_inner,
            d_state=self.d_state,
            chunk=self.ssm_chunk,
            dt_bc_norms=self.mamba_norms,
        )

    def rglru_cfg(self) -> RGLRUConfig:
        return RGLRUConfig(d_model=self.d_model, d_rnn=self.d_rnn, chunk=self.ssm_chunk)

    def sparse_cfg(self) -> L.SparseFFNConfig:
        return L.SparseFFNConfig(
            epsilon=self.sparse_epsilon,
            block_m=self.sparse_block,
            block_n=self.sparse_block,
            activation="all_relu",
            alpha=self.sparse_alpha,
            density=self.sparse_density,
        )


@dataclasses.dataclass(frozen=True)
class HybridConfig(ModelConfig):
    """A ``ModelConfig`` with the options of the hybrids the reference has no
    twin of (Jamba): ``slot_ffn`` each pattern slot's FFN kind (None: see
    :meth:`ModelConfig.ffn_kind`); ``rope`` False for attention without
    position encoding; ``mamba_norms`` the RMSNorms on Mamba's dt, B and C;
    the MoE FFN's ``moe_dropless`` dispatch (with its pooled auxiliary
    loss), ``moe_held`` share of the experts ([first, stop)),
    ``moe_norm_topk`` renormalisation and ``moe_aux_weight``."""

    slot_ffn: Optional[Tuple[str, ...]] = ModelConfig.slot_ffn
    rope: bool = ModelConfig.rope
    mamba_norms: bool = ModelConfig.mamba_norms
    moe_dropless: bool = ModelConfig.moe_dropless
    moe_held: Optional[Tuple[int, int]] = ModelConfig.moe_held
    moe_norm_topk: bool = ModelConfig.moe_norm_topk
    moe_aux_weight: float = ModelConfig.moe_aux_weight


# ---------------------------------------------------------------------------
# block init / fwd
# ---------------------------------------------------------------------------


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None))) for e in x)


def _block_specs(cfg: ModelConfig, kind: str, ffn: str) -> Dict[str, Tree]:
    """The logical-axis specs of :func:`_init_block`'s parameters."""
    norm = L.rmsnorm_specs if cfg.norm == "rms" else L.layernorm_specs
    specs: Dict[str, Tree] = {"ln1": norm()}
    if kind in ("global", "local"):
        specs["attn"] = L.attention_specs(cfg.attn_cfg(kind))
        if cfg.post_norms:
            specs["post_attn"] = norm()
        specs["ln2"] = norm()
        if cfg.post_norms:
            specs["post_ffn"] = norm()
    elif kind == "mamba":
        specs["mamba"] = mamba_specs(cfg.mamba_cfg())
        if ffn == "none":
            return specs
        specs["ln2"] = norm()
    elif kind == "rglru":
        specs["rglru"] = rglru_specs()
        specs["ln2"] = norm()
    else:
        raise ValueError(kind)
    specs["ffn"] = {"gated": L.gated_ffn_specs, "moe": moe_specs,
                    "sparse": L.sparse_ffn_specs}[ffn]()
    return specs


def model_specs(cfg: ModelConfig) -> Dict[str, Tree]:
    """``PatternLM.specs`` of ``cfg``: the reference's tree of logical-axis
    tuples, a stacked slot's with ``"stack"`` leading."""
    norm = L.rmsnorm_specs if cfg.norm == "rms" else L.layernorm_specs
    specs: Dict[str, Tree] = {"embed": L.embedding_specs(), "final_norm": norm()}
    if not cfg.tied_embeddings:
        specs["unembed"] = ("embed", "vocab")
    P = len(cfg.pattern)
    specs["stack"] = {
        f"s{s_idx}_{kind}": tree_map(lambda s: ("stack",) + s,
                                     _block_specs(cfg, kind, cfg.ffn_kind(s_idx)),
                                     is_leaf=_is_spec)
        for s_idx, kind in enumerate(cfg.pattern) if cfg.n_rep}
    specs["rest"] = [_block_specs(cfg, cfg.pattern[i % P], cfg.ffn_kind(i % P))
                     for i in range(cfg.remainder)]
    return specs


def _init_block(gen: torch.Generator, cfg: ModelConfig, kind: str, ffn: str,
                np_rng: np.random.Generator, device: torch.device, into=None):
    """Returns (params, topos | None, metas | None). ``into``: the views the
    dense draws are cast into (``layers.draw_stacked``), or None."""
    dtype = getattr(torch, cfg.dtype)
    sub = (into or {}).get

    def norm():
        return (L.init_rmsnorm(cfg.d_model, dtype, device) if cfg.norm == "rms"
                else L.init_layernorm(cfg.d_model, dtype, device))

    params: Dict[str, Tree] = {"ln1": norm()}
    if kind in ("global", "local"):
        params["attn"] = L.init_attention(gen, cfg.attn_cfg(kind), dtype, device, sub("attn"))
        if cfg.post_norms:
            params["post_attn"] = norm()
        params["ln2"] = norm()
        if cfg.post_norms:
            params["post_ffn"] = norm()
    elif kind == "mamba":
        params["mamba"] = init_mamba_block(gen, cfg.mamba_cfg(), dtype, device, sub("mamba"))
        if ffn == "none":
            return params, None, None
        params["ln2"] = norm()
    elif kind == "rglru":
        params["rglru"] = init_rglru_block(gen, cfg.rglru_cfg(), dtype, device, sub("rglru"))
        params["ln2"] = norm()
    else:
        raise ValueError(kind)
    topos = metas = None
    if ffn == "gated":
        params["ffn"] = L.init_gated_ffn(gen, cfg.d_model, cfg.d_ff, dtype, device, sub("ffn"))
    elif ffn == "moe":
        params["ffn"] = init_moe(gen, cfg.moe_cfg(), dtype, device, sub("ffn"))
    elif ffn == "sparse":
        params["ffn"], topos, metas = L.init_sparse_ffn(
            np_rng, cfg.d_model, cfg.d_ff, cfg.sparse_cfg(), dtype, device)
    else:
        raise ValueError(ffn)
    return params, topos, metas


def _norm(cfg: ModelConfig, p, x: torch.Tensor) -> torch.Tensor:
    return L.rmsnorm(p, x) if cfg.norm == "rms" else L.layernorm(p, x)


def _block_fwd(params, h: torch.Tensor, *, cfg: ModelConfig, kind: str, ffn: str,
               positions: torch.Tensor, layer_index: int, mode: str, cache,
               topo: Optional[Tuple[BlockTopoArrays, BlockTopoArrays]],
               metas, prefix_len: Optional[int], sparse_impl: str = "kernel",
               moe_groups: Optional[int] = None):
    """One residual block. Returns (h, new_cache, aux): ``aux`` is the MoE
    FFN's auxiliary loss (None without one: nothing to add). A recurrent
    block's state is written into ``cache`` in place. ``moe_groups``: the
    MoE FFN's dispatch groups for this call (None: the config's). The
    configuration is keyword-only: static, as the repository's convention
    has it."""
    aux = None
    if kind in ("mamba", "rglru"):
        fwd, cfg_of = (mamba_fwd, cfg.mamba_cfg) if kind == "mamba" else (rglru_fwd,
                                                                          cfg.rglru_cfg)
        r, new_state = fwd(params[kind], _norm(cfg, params["ln1"], h), cfg_of(), state=cache)
        if new_state is not None:
            for name, t in new_state.items():
                cache[name].copy_(t)
        new_cache = None if new_state is None else cache
        h = h + r
        if ffn == "none":
            return h, new_cache, aux
    elif kind in ("global", "local"):
        a, new_cache = L.attention_fwd(
            params["attn"], _norm(cfg, params["ln1"], h), cfg.attn_cfg(kind),
            positions=positions, mode=mode, cache=cache, prefix_len=prefix_len,
        )
        if cfg.post_norms:
            a = _norm(cfg, params["post_attn"], a)
        h = h + a
    else:
        raise ValueError(kind)
    f_in = _norm(cfg, params["ln2"], h)
    if ffn == "gated":
        f = L.gated_ffn_fwd(params["ffn"], f_in, cfg.activation)
    elif ffn == "moe":
        mcfg = cfg.moe_cfg()
        if moe_groups is not None:
            mcfg = dataclasses.replace(mcfg, groups=moe_groups)
        f, aux = moe_fwd(params["ffn"], f_in, mcfg)
    else:
        f = L.sparse_ffn_fwd(params["ffn"], topo[0], topo[1], metas, f_in,
                             cfg.sparse_cfg(), layer_index, impl=sparse_impl)
    if cfg.post_norms and kind != "rglru":
        f = _norm(cfg, params["post_ffn"], f)
    return h + f, new_cache, aux


def _rep(stacked: BlockTopoArrays, r: int) -> BlockTopoArrays:
    return BlockTopoArrays(*(a[r] for a in stacked))


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


class PatternLM:
    """Builds the parameters and the sparse FFN's host topologies; exposes
    the forward. ``device=None`` means the card; without one it raises
    (pass ``device="cpu"`` for the plain versions). ``sparse_impl`` is the
    sparse FFN's products: ``"kernel"`` (kernels C, D and E) or ``"xla"``
    (the reference's plain autograd ``bsmm_xla``, an oracle).

    The dense weights draw from a CPU generator, the same weights on every
    device; ``draw_on_device=True`` draws them from a generator on
    ``device`` instead (other weights than the CPU's, for a seed: a 7 B
    model's draws on the card take milliseconds, where the CPU's take a
    minute)."""

    sparse_impl = "kernel"

    def __init__(self, cfg: ModelConfig, seed: int = 0, device: DeviceLike = None,
                 abstract: bool = False, draw_on_device: bool = False):
        self.cfg = cfg
        self._seed = seed
        self._draw_on_device = draw_on_device
        self.device = torch.device("meta") if abstract else resolve_device(device)
        self.specs = model_specs(cfg)
        self.topologies: Dict[str, List] = {}
        self.block_metas: Optional[Tuple[BlockMeta, BlockMeta]] = None
        self._views = None
        self._topo_views = None
        if cfg.remat not in ("block", "none"):
            raise ValueError(f"remat must be 'block' or 'none', not {cfg.remat!r}")
        self.params = self._build()

    def _build(self) -> Dict[str, Tree]:
        """The reference's build order. The sparse FFN draws from
        ``np.random.default_rng(seed)`` per layer in that order (t_in,
        t_out, then their values), so a seed gives the reference's
        topologies and values; the dense weights draw from a CPU
        ``torch.Generator`` seeded alike (not jax.random's draws), or one
        on the model's device with ``draw_on_device``. A pattern slot's
        repeats draw straight into its stacked leaves
        (``layers.draw_stacked``): the build's peak is the parameters and
        one layer's draw."""
        cfg, dev = self.cfg, self.device
        on_device = self._draw_on_device and dev.type != "meta"
        gen = torch.Generator(device=dev if on_device else "cpu").manual_seed(self._seed)
        np_rng = np.random.default_rng(self._seed)
        dtype = getattr(torch, cfg.dtype)
        self.topologies = {}
        params: Dict[str, Tree] = {
            "embed": L.init_embedding(gen, cfg.vocab, cfg.d_model, dtype, dev),
            "final_norm": (L.init_rmsnorm(cfg.d_model, dtype, dev) if cfg.norm == "rms"
                           else L.init_layernorm(cfg.d_model, dtype, dev)),
        }
        if not cfg.tied_embeddings:
            params["unembed"] = L.dense_init(gen, (cfg.d_model, cfg.vocab), cfg.d_model,
                                             dtype, dev)
        P = len(cfg.pattern)
        stack: Dict[str, Tree] = {}
        for s_idx, kind in enumerate(cfg.pattern):
            slot = f"s{s_idx}_{kind}"
            slot_topos = []

            def draw(into, kind=kind, ffn=cfg.ffn_kind(s_idx), slot_topos=slot_topos):
                pr, topos, metas = _init_block(gen, cfg, kind, ffn, np_rng, dev, into)
                if topos is not None:
                    slot_topos.append(topos)
                    self.block_metas = metas
                return pr

            if cfg.n_rep:
                stack[slot] = L.draw_stacked(cfg.n_rep, draw)
            if slot_topos:
                self.topologies[slot] = slot_topos
        params["stack"] = stack
        rest = []
        for i in range(cfg.remainder):
            pr, topos, metas = _init_block(gen, cfg, cfg.pattern[i % P], cfg.ffn_kind(i % P),
                                           np_rng, dev)
            rest.append(pr)
            if topos is not None:
                self.topologies[f"rest{i}"] = [topos]
                self.block_metas = metas
        params["rest"] = rest
        return params

    def to(self, device: DeviceLike) -> "PatternLM":
        """Move the parameters to ``device`` (``None``: the card), in place."""
        device = resolve_device(device)
        if device != self.device:
            self.params = tree_map(lambda a: a.to(device), self.params)
            self.device = device
            self._views = self._topo_views = None
        return self

    # -- topology device views ---------------------------------------------

    def topo_arrays(self) -> Optional[Dict[str, Tuple[BlockTopoArrays, BlockTopoArrays]]]:
        """Stacked ``BlockTopoArrays`` per slot, (n_rep, nb) each (``None``
        without a sparse FFN)."""
        if not self.topologies:
            return None
        out = {}
        for slot, topos in self.topologies.items():
            ins = [t[0].device_arrays(self.device) for t in topos]
            outs = [t[1].device_arrays(self.device) for t in topos]
            out[slot] = (BlockTopoArrays(*(torch.stack(f) for f in zip(*ins))),
                         BlockTopoArrays(*(torch.stack(f) for f in zip(*outs))))
        return out

    def _layer_topos(self, topo) -> List[Optional[tuple]]:
        """Each layer's (W_in, W_out) topology views, in layer order,
        memoized for the last ``topo``: the same view objects on every call
        with it."""
        if self._topo_views is not None and self._topo_views[0] is topo:
            return self._topo_views[1]
        cfg = self.cfg
        views = []
        for r in range(cfg.n_rep):
            for s_idx, kind in enumerate(cfg.pattern):
                slot = f"s{s_idx}_{kind}"
                has = topo is not None and slot in topo
                views.append((_rep(topo[slot][0], r), _rep(topo[slot][1], r)) if has else None)
        for i in range(cfg.remainder):
            has = topo is not None and f"rest{i}" in topo
            views.append(tuple(_rep(t, 0) for t in topo[f"rest{i}"]) if has else None)
        self._topo_views = (topo, views)
        return views

    def _layers(self, params, topo) -> List[tuple]:
        """(kind, ffn kind, layer_index, where, layer params, layer topology)
        per layer in order. Each stacked leaf is split into its repeats once
        (``torch.unbind``). Where autograd does not record, memoized for the
        last (params, topo) pair: the same view objects on every call."""
        record = torch.is_grad_enabled()
        if (not record and self._views is not None and self._views[0] is params
                and self._views[1] is topo):
            return self._views[2]
        cfg = self.cfg
        P = len(cfg.pattern)
        topos = iter(self._layer_topos(topo))
        reps = {}
        for slot, stacked in params["stack"].items():
            leaves, unflatten = tree_flatten(stacked)
            parts = [a.unbind(0) for a in leaves]
            reps[slot] = [unflatten([p[r] for p in parts]) for r in range(cfg.n_rep)]
        layers = []
        for r in range(cfg.n_rep):
            for s_idx, kind in enumerate(cfg.pattern):
                slot = f"s{s_idx}_{kind}"
                layers.append((kind, cfg.ffn_kind(s_idx), r * P + s_idx + 1,
                               ("stack", slot, r), reps[slot][r], next(topos)))
        for i in range(cfg.remainder):
            layers.append((cfg.pattern[i % P], cfg.ffn_kind(i % P), cfg.n_rep * P + i + 1,
                           ("rest", i), params["rest"][i], next(topos)))
        self._views = None if record else (params, topo, layers)
        return layers

    # -- forward -------------------------------------------------------------

    def forward(
        self,
        params,
        tokens: torch.Tensor,
        *,
        topo=None,
        positions: Optional[torch.Tensor] = None,
        mode: str = "train",
        caches=None,
        prefix_embeds: Optional[torch.Tensor] = None,
        return_hidden: bool = False,
        moe_groups: Optional[int] = None,
    ):
        """tokens: (B, S). Returns (hidden_or_logits, new_caches, aux).

        Modes: ``train`` (no caches), ``decode`` (one step with caches,
        written in place: the returned caches are the caches given; positions
        (S,) shared by every row, or (B, S) one row each), ``prefill`` (the
        full causal forward over the prompt that also returns every layer's
        K/V of prompt length, stacked as the reference's scan stacks them,
        for the engine to insert into its decode caches; a recurrent block
        returns no state, as in the reference). ``aux`` is the MoE auxiliary
        loss summed over the layers in order (0 without an MoE FFN; with
        ``moe_dropless``, :func:`models.moe.pooled_aux` of the layers'
        summed routing counts).
        ``moe_groups`` sets the MoE FFN's dispatch groups for this call
        (None: the config's ``moe_groups``): the serving engine's decode
        gives each slot its own, as the reference's vmap over the slots
        does, without touching ``self.cfg``."""
        if mode not in ("train", "prefill", "decode"):
            raise ValueError(f"unknown mode {mode!r}")
        cfg = self.cfg
        h = L.embed(params["embed"], tokens)
        if cfg.embed_scale:
            h = h * scalar_in(math.sqrt(cfg.d_model), h.dtype)
        prefix_len = None
        if prefix_embeds is not None:
            h = torch.cat([prefix_embeds.to(h.dtype), h], dim=1)
            prefix_len = prefix_embeds.shape[1]
        elif cfg.prefix_len and mode != "decode":
            prefix_len = cfg.prefix_len
        if positions is None:
            positions = torch.arange(h.shape[1], device=h.device)
        if mode == "decode" and caches is None:
            raise ValueError("decode needs caches")

        collected: Dict[str, List] = {}
        aux = torch.zeros((), dtype=torch.float32, device=h.device)
        # the reference checkpoints its scan body (the stacked layers) in
        # train mode; the LM draws nothing random, so no RNG state is kept
        remat = cfg.remat == "block" and mode == "train" and torch.is_grad_enabled()
        for kind, ffn, layer_index, where, lp, lt in self._layers(params, topo):
            cache = None
            if caches is not None:
                cache = (tree_map(lambda a, r=where[2]: a[r], caches["stack"][where[1]])
                         if where[0] == "stack" else caches["rest"][where[1]])
            block = dict(cfg=cfg, kind=kind, ffn=ffn, positions=positions, layer_index=layer_index,
                         mode=mode, cache=cache, topo=lt, metas=self.block_metas,
                         prefix_len=prefix_len, sparse_impl=self.sparse_impl,
                         moe_groups=moe_groups)
            if remat and where[0] == "stack":
                h, nc, aux_b = checkpoint(_block_fwd, lp, h, use_reentrant=False,
                                          preserve_rng_state=False, **block)
            else:
                h, nc, aux_b = _block_fwd(lp, h, **block)
            if aux_b is not None:
                aux = aux + aux_b
            if mode == "prefill" and (nc is not None or where[0] == "rest"):
                collected.setdefault(where[1] if where[0] == "stack" else "rest", []).append(nc)

        if aux.dim():  # a dropless MoE's routing counts
            aux = pooled_aux(aux, cfg.moe_cfg())
        new_caches = None
        if mode == "decode":
            new_caches = caches
        elif mode == "prefill":
            rest = collected.pop("rest", [])
            new_caches = {"stack": {slot: tree_map(lambda *xs: torch.stack(xs), *ncs)
                                    for slot, ncs in collected.items()},
                          "rest": rest}
        h = _norm(cfg, params["final_norm"], h)
        if return_hidden:
            return h, new_caches, aux
        return self.logits(params, h), new_caches, aux

    def logits(self, params, h: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        out = L.unembed(params["embed"], h) if cfg.tied_embeddings else h @ params["unembed"]
        if cfg.final_softcap:
            cap = scalar_in(cfg.final_softcap, out.dtype)
            out = torch.tanh(out / cap) * cap
        return out

    # -- caches ----------------------------------------------------------------

    def init_caches(self, batch: int, max_len: int, dtype: torch.dtype = torch.bfloat16):
        """Decode caches: full K/V for global slots, ring buffers for local
        ones (with ``decode_window_cache``), recurrent states for mamba and
        rglru (``ssm``/``rnn`` in f32, ``conv`` in ``dtype``), stacked along
        n_rep per slot; zeros, since decode writes into them in place."""
        cfg, dev = self.cfg, self.device

        def one(kind, lead=()):
            if kind in ("mamba", "rglru"):
                init = (init_mamba_state(cfg.mamba_cfg(), batch, dtype, dev) if kind == "mamba"
                        else init_rglru_state(cfg.rglru_cfg(), batch, dtype, dev))
                return tree_map(lambda a: a.new_zeros(lead + a.shape), init)
            if kind not in ("global", "local"):
                raise ValueError(kind)
            ring = kind == "local" and cfg.decode_window_cache
            w = min(cfg.window, max_len) if ring else max_len
            shape = lead + (batch, w, cfg.n_kv, cfg.head_dim)
            c = {"k": torch.zeros(shape, dtype=dtype, device=dev),
                 "v": torch.zeros(shape, dtype=dtype, device=dev)}
            if ring:
                c["pos"] = torch.full(lead + (w,), -1, dtype=torch.int32, device=dev)
            return c

        stack = {f"s{s_idx}_{kind}": one(kind, (cfg.n_rep,))
                 for s_idx, kind in enumerate(cfg.pattern) if cfg.n_rep}
        rest = [one(cfg.pattern[i % len(cfg.pattern)]) for i in range(cfg.remainder)]
        return {"stack": stack, "rest": rest}

    def cache_specs(self) -> Dict[str, Tree]:
        """Logical axes of :meth:`init_caches`'s arrays (the dry run's
        shardings), the reference's."""
        cfg = self.cfg

        def one(kind):
            if kind in ("global", "local"):
                c = {"k": ("batch", "cache_seq", "kv_heads", None),
                     "v": ("batch", "cache_seq", "kv_heads", None)}
                if kind == "local" and cfg.decode_window_cache:
                    c["pos"] = (None,)
                return c
            if kind == "mamba":
                return {"ssm": ("batch", "inner", None), "conv": ("batch", None, "inner")}
            if kind == "rglru":
                return {"rnn": ("batch", "inner"), "conv": ("batch", None, "inner")}
            raise ValueError(kind)

        stack = {f"s{s_idx}_{kind}": tree_map(lambda s: (None,) + s, one(kind), is_leaf=_is_spec)
                 for s_idx, kind in enumerate(cfg.pattern) if cfg.n_rep}
        rest = [one(cfg.pattern[i % len(cfg.pattern)]) for i in range(cfg.remainder)]
        return {"stack": stack, "rest": rest}


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def chunked_softmax_xent(model: PatternLM, params, h: torch.Tensor, labels: torch.Tensor,
                         chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the vocabulary, the logits made in f32 one
    sequence chunk at a time (the reference's scan over chunks). ``h``
    (B, S, d) are the final hidden states, ``labels`` (B, S) the targets;
    a label of -1 (and the padding of a last chunk shorter than ``chunk``)
    counts in neither the sum nor the mean."""
    B, S, _ = h.shape
    c = min(chunk, S)
    n_chunks = -(-S // c)
    pad = n_chunks * c - S
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
    tot = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(n_chunks):
        lx = labels[:, i * c:(i + 1) * c]
        logits = model.logits(params, h[:, i * c:(i + 1) * c]).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, lx.clamp(min=0).long()[..., None])[..., 0]
        tot = tot + torch.where(lx >= 0, lse - gold, 0.0).sum()
    n_valid = (labels >= 0).sum().clamp(min=1)
    return tot / n_valid
