"""The plain reference of Jamba's training step, in f32 with TF32 off: the
equations of Hugging Face transformers' ``modeling_jamba.py`` written out
in plain ``torch``, independent of the program.

* Mamba layers: ``JambaMambaMixer.slow_forward``: the in projection, the
  depthwise causal conv with bias, SiLU, ``x_proj``, the RMSNorms on dt, B
  and C, ``dt_proj`` with its bias and softplus, ``A = -exp(A_log)``, the
  discretisation ``exp(delta * A)`` and ``delta * B * u``, the sequential
  recurrence ``h_t = dA_t h_{t-1} + dBu_t``, ``y_t = h_t . C_t``, the D skip,
  the SiLU gate and the out projection.
* The attention layer: ``JambaAttention``: GQA, no position encoding, the
  causal softmax over all keys.
* The FFNs: ``JambaMLP`` (SwiGLU) and ``JambaSparseMoeBlock``: the router's
  softmax over all experts, its top k, the gates not renormalised, every
  routed token computed, here by a loop over the experts.
* The loss: next-token cross-entropy over the labels (-1 counts nowhere)
  plus ``router_aux_loss_coef * load_balancing_loss_func`` over the MoE
  layers' router logits pooled.

Departures from ``modeling_jamba.py``, each on purpose:

* The expert share: only experts ``held[0]..held[1]-1`` are computed (a
  chip's expert-parallel share); entries routed to the others add nothing,
  as in the program. With every expert held this is the uncut layer.
* ``routes``: the MoE layers may be given their top-k choices (the
  program's, recorded) instead of choosing their own; the gates are still
  the reference's own probabilities at those choices. The reference's own
  top-k is returned beside.
* The recurrence runs in chunks of positions, the discretised (dA, dBu)
  made for one chunk at a time and the state carried between chunks: the
  same recurrence, in memory that fits.
* Weights are plain tensors named here (:func:`leaf_names`), products are
  ``x @ W`` with ``W`` (in, out) (``nn.Linear`` keeps (out, in)); the conv's
  taps are (K, d_inner).
* :func:`loss_and_grads` runs the step layer by layer: a forward that keeps
  each layer's input, then each layer recomputed and differentiated from
  the last to the first, so that one layer's f32 weights and activations
  are on the device at a time.

``precision`` puts the controls in the program's place: ``"fp8"`` rounds
every product's operands (and the gradients reaching them) to fp8 e4m3,
each tensor scaled by its largest magnitude; ``"bf16_scan"`` keeps the
scan's discretisation and state in bf16.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
E4M3_MAX = 448.0


def config_from_json(c: Dict) -> Dict:
    """The reference's configuration from a Hugging Face ``JambaConfig``'s
    keys (the benchmark's configuration file): layer kinds from the
    periods and offsets, the held experts from ``experts_held``."""
    d = c["hidden_size"]
    n = c["num_hidden_layers"]
    kinds = []
    for i in range(n):
        mixer = "attention" if i % c["attn_layer_period"] == c["attn_layer_offset"] else "mamba"
        ffn = "moe" if i % c["expert_layer_period"] == c["expert_layer_offset"] else "dense"
        kinds.append((mixer, ffn))
    return dict(
        d_model=d, vocab=c["vocab_size"], n_heads=c["num_attention_heads"],
        n_kv=c["num_key_value_heads"], head_dim=d // c["num_attention_heads"],
        d_ff=c["intermediate_size"], d_inner=c["mamba_expand"] * d,
        d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"], dt_rank=c["mamba_dt_rank"],
        n_experts=c.get("router_experts", c["num_experts"]), top_k=c["num_experts_per_tok"],
        held=tuple(c.get("experts_held", (0, c["num_experts"]))), eps=c["rms_norm_eps"],
        aux_coef=c["router_aux_loss_coef"], kinds=kinds)


def layer_leaves(cfg: Dict, i: int) -> List[str]:
    mixer, ffn = cfg["kinds"][i]
    names = ["ln1", "ln2"]
    names += (["in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log", "D",
               "out_proj", "dt_norm", "b_norm", "c_norm"] if mixer == "mamba"
              else ["wq", "wk", "wv", "wo"])
    names += ["router", "gate", "up", "down"] if ffn == "moe" else ["gate", "up", "down"]
    return [f"{i}.{n}" for n in names]


def leaf_names(cfg: Dict) -> List[str]:
    """Every weight's name: ``embed``, ``final_norm``, ``unembed`` and each
    layer's ``{i}.{leaf}``."""
    out = ["embed", "final_norm", "unembed"]
    for i in range(len(cfg["kinds"])):
        out += layer_leaves(cfg, i)
    return out


# -- the controls' rounding ------------------------------------------------------


def round_e4m3(x: Tensor) -> Tensor:
    """``x`` scaled so its largest magnitude is e4m3's largest, rounded to
    e4m3 (to nearest) and scaled back."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    s = E4M3_MAX / amax
    return (x.float() * s).to(torch.float8_e4m3fn).float() / s


class _E4M3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_e4m3(x)

    @staticmethod
    def backward(ctx, g):
        return round_e4m3(g)


def _op(x: Tensor, precision: str) -> Tensor:
    return _E4M3.apply(x) if precision == "fp8" else x


def mm(a: Tensor, b: Tensor, precision: str = "f32") -> Tensor:
    return _op(a, precision) @ _op(b, precision)


# -- layers ---------------------------------------------------------------------------


def rms(x: Tensor, w: Tensor, eps: float) -> Tensor:
    return w * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def swiglu(x: Tensor, g: Tensor, u: Tensor, dn: Tensor, precision: str) -> Tensor:
    return mm(F.silu(mm(x, g, precision)) * mm(x, u, precision), dn, precision)


def scan(u: Tensor, delta: Tensor, A: Tensor, Bm: Tensor, Cm: Tensor, precision: str,
         chunk: int = 256) -> Tensor:
    """The sequential selective recurrence. u, delta: (B, S, di); Bm, Cm:
    (B, S, ds); A: (di, ds). Returns y (B, S, di)."""
    Bt, S, di = u.shape
    low = precision == "bf16_scan"
    state = u.new_zeros((Bt, di, A.shape[1]), dtype=torch.bfloat16 if low else torch.float32)
    ys = []
    for c0 in range(0, S, chunk):
        c1 = min(S, c0 + chunk)
        dA = torch.exp(delta[:, c0:c1, :, None] * A)                       # (B, c, di, ds)
        dBu = delta[:, c0:c1, :, None] * Bm[:, c0:c1, None, :] * u[:, c0:c1, :, None]
        if low:
            dA, dBu = dA.bfloat16(), dBu.bfloat16()
        for t in range(c1 - c0):
            state = dA[:, t] * state + dBu[:, t]
            ys.append(torch.einsum("bds,bs->bd", state.float(), Cm[:, c0 + t]))
    return torch.stack(ys, dim=1)


def mamba(w: Dict[str, Tensor], x: Tensor, cfg: Dict, precision: str):
    """(out, y): the mixer's output and its scan output ``y``."""
    di, ds, r, K = cfg["d_inner"], cfg["d_state"], cfg["dt_rank"], cfg["d_conv"]
    S = x.shape[1]
    hs, gate = mm(x, w["in_proj"], precision).chunk(2, dim=-1)
    hp = F.pad(hs, (0, 0, K - 1, 0))
    conv = sum(hp[:, k:k + S] * w["conv_w"][k] for k in range(K)) + w["conv_b"]
    hs = F.silu(conv)
    dt, Bm, Cm = torch.split(mm(hs, w["x_proj"], precision), [r, ds, ds], dim=-1)
    dt, Bm, Cm = (rms(dt, w["dt_norm"], cfg["eps"]), rms(Bm, w["b_norm"], cfg["eps"]),
                  rms(Cm, w["c_norm"], cfg["eps"]))
    delta = F.softplus(mm(dt, w["dt_proj"], precision) + w["dt_bias"])
    A = -torch.exp(w["A_log"])
    y = scan(hs, delta, A, Bm, Cm, precision)
    out = (y + hs * w["D"]) * F.silu(gate)
    return mm(out, w["out_proj"], precision), y


def attention(w: Dict[str, Tensor], x: Tensor, cfg: Dict, precision: str) -> Tensor:
    B, S, _ = x.shape
    H, KV, D = cfg["n_heads"], cfg["n_kv"], cfg["head_dim"]
    q = mm(x, w["wq"], precision).reshape(B, S, H, D).transpose(1, 2)
    k = mm(x, w["wk"], precision).reshape(B, S, KV, D).transpose(1, 2)
    v = mm(x, w["wv"], precision).reshape(B, S, KV, D).transpose(1, 2)
    k = k.repeat_interleave(H // KV, dim=1)
    v = v.repeat_interleave(H // KV, dim=1)
    s = mm(q, k.transpose(2, 3), precision) / math.sqrt(D)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    o = mm(p, v, precision).transpose(1, 2).reshape(B, S, H * D)
    return mm(o, w["wo"], precision)


def moe(w: Dict[str, Tensor], x: Tensor, cfg: Dict, precision: str,
        route: Optional[Tensor] = None):
    """(out, stats): the held experts' part of the layer, and the router's
    probabilities (T, E), its own top-k (T, K) and the choices used."""
    B, S, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(mm(xt, w["router"], precision), dim=-1)
    own = torch.topk(probs, cfg["top_k"], dim=-1).indices
    used = own if route is None else route.to(own.device).long()
    gates = probs.gather(-1, used)
    out = torch.zeros_like(xt)
    first, stop = cfg["held"]
    for e in range(first, stop):
        tok, k = torch.where(used == e)
        if tok.numel() == 0:
            continue
        j = e - first
        ye = swiglu(xt[tok], w["gate"][j], w["up"][j], w["down"][j], precision)
        out = out.index_add(0, tok, ye * gates[tok, k, None])
    return out.reshape(B, S, d), {"probs": probs, "own": own, "used": used}


def layer_fwd(w: Dict[str, Tensor], i: int, h: Tensor, cfg: Dict, precision: str,
              route: Optional[Tensor] = None):
    """Layer ``i`` (its weights ``w`` by leaf, without the ``{i}.``):
    (h_out, stats), stats holding the scan output ``y`` of a Mamba layer
    and the router's of an MoE layer."""
    mixer, ffn = cfg["kinds"][i]
    x = rms(h, w["ln1"], cfg["eps"])
    stats: Dict = {}
    if mixer == "mamba":
        r, stats["y"] = mamba(w, x, cfg, precision)
    else:
        r = attention(w, x, cfg, precision)
    h = h + r
    x = rms(h, w["ln2"], cfg["eps"])
    if ffn == "moe":
        f, ms = moe(w, x, cfg, precision, route)
        stats.update(ms)
    else:
        f = swiglu(x, w["gate"], w["up"], w["down"], precision)
    return h + f, stats


def moe_counts(stats: Dict, cfg: Dict) -> Tuple[Tensor, Tensor, int]:
    """(F (K, E) routed entries, P (E) summed probabilities, tokens)."""
    f = F.one_hot(stats["used"], cfg["n_experts"]).float().sum(0)
    return f, stats["probs"].sum(0), stats["probs"].shape[0]


def pooled_aux(counts, cfg: Dict) -> Tensor:
    """``router_aux_loss_coef * load_balancing_loss_func`` of the MoE
    layers' router logits pooled (``attention_mask`` None)."""
    n = sum(c[2] for c in counts)
    fe = sum(c[0] for c in counts) / n
    pe = sum(c[1] for c in counts) / n
    return cfg["aux_coef"] * cfg["n_experts"] * torch.sum(fe * pe[None])


def xent(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean cross-entropy over the labels that are not -1."""
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, labels.clamp(min=0)[..., None])[..., 0]
    return torch.where(valid, lse - gold, 0.0).sum() / valid.sum().clamp(min=1)


def _layer_weights(w: Dict[str, Tensor], cfg: Dict, i: int, device) -> Dict[str, Tensor]:
    return {n.split(".", 1)[1]: w[n].to(device=device, dtype=torch.float32, copy=True)
            for n in layer_leaves(cfg, i)}


def forward(w: Dict[str, Tensor], tokens: Tensor, cfg: Dict, precision: str = "f32",
            routes: Optional[List[Tensor]] = None):
    """The whole forward at once (small sizes; autograd may record):
    (logits, aux, stats of each layer)."""
    h = w["embed"][tokens]
    counts, all_stats, m = [], [], 0
    for i, (_, ffn) in enumerate(cfg["kinds"]):
        route = routes[m] if (routes is not None and ffn == "moe") else None
        h, st = layer_fwd({n.split(".", 1)[1]: w[n] for n in layer_leaves(cfg, i)}, i, h, cfg,
                          precision, route)
        if ffn == "moe":
            counts.append(moe_counts(st, cfg))
            m += 1
        all_stats.append(st)
    h = rms(h, w["final_norm"], cfg["eps"])
    logits = mm(h, w["unembed"], precision)
    aux = pooled_aux(counts, cfg) if counts else logits.new_zeros(())
    return logits, aux, all_stats


def loss_and_grads(w: Dict[str, Tensor], tokens: Tensor, labels: Tensor, cfg: Dict, *,
                   device, precision: str = "f32", routes: Optional[List[Tensor]] = None,
                   on_grad: Callable[[str, Tensor], None]) -> Dict:
    """The step's loss and every weight's gradient, layer by layer (see the
    module's docstring). ``w``: name -> tensor, anywhere, any float dtype;
    each layer's weights are moved to ``device`` in f32 when it runs.
    ``on_grad(name, grad)`` receives each gradient (f32, on ``device``) as
    it is made. Returns the cross-entropy ``loss``, the ``aux`` loss, each
    MoE layer's own top-k (``own``, on the host) and the first Mamba
    layer's scan output ``y0`` (on the host)."""
    tokens, labels = tokens.to(device), labels.to(device)
    n_layers = len(cfg["kinds"])
    out: Dict = {"own": []}
    with torch.no_grad():
        table = w["embed"].to(device=device, dtype=torch.float32)
        h = table[tokens]
        del table
        inputs, counts, m = [], [], 0
        for i, (mixer, ffn) in enumerate(cfg["kinds"]):
            inputs.append(h)
            route = routes[m] if (routes is not None and ffn == "moe") else None
            h, st = layer_fwd(_layer_weights(w, cfg, i, device), i, h, cfg, precision, route)
            if ffn == "moe":
                counts.append(moe_counts(st, cfg))
                out["own"].append(st["own"].cpu())
                m += 1
            if mixer == "mamba" and "y0" not in out:
                out["y0"] = st["y"].cpu()
            del st
    # the head: final norm, unembedding, cross-entropy
    hL = h.detach().requires_grad_(True)
    fn = w["final_norm"].to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)
    un = w["unembed"].to(device=device, dtype=torch.float32, copy=True).requires_grad_(True)
    loss = xent(mm(rms(hL, fn, cfg["eps"]), un, precision), labels)
    g, g_fn, g_un = torch.autograd.grad(loss, [hL, fn, un])
    on_grad("final_norm", g_fn)
    on_grad("unembed", g_un)
    del fn, un, g_fn, g_un, hL
    aux = pooled_aux(counts, cfg) if counts else torch.zeros((), device=device)
    if counts:  # d aux / d (a layer's summed probabilities), the same for every layer
        n = sum(c[2] for c in counts)
        coef = cfg["aux_coef"] * cfg["n_experts"] * sum(c[0] for c in counts).sum(0) / n ** 2
    m = len(counts)
    for i in reversed(range(n_layers)):
        mixer, ffn = cfg["kinds"][i]
        lw = _layer_weights(w, cfg, i, device)
        for t in lw.values():
            t.requires_grad_(True)
        x = inputs[i].requires_grad_(True)
        if ffn == "moe":
            m -= 1
        route = routes[m] if (routes is not None and ffn == "moe") else None
        h_out, st = layer_fwd(lw, i, x, cfg, precision, route)
        obj = (h_out * g).sum()
        if ffn == "moe":
            obj = obj + (coef * st["probs"].sum(0)).sum()
        names = list(lw)
        grads = torch.autograd.grad(obj, [x] + [lw[k] for k in names])
        g = grads[0]
        for k, gk in zip(names, grads[1:]):
            on_grad(f"{i}.{k}", gk)
        del lw, h_out, st, obj, grads, x
        inputs[i] = None
    g_table = torch.zeros(tuple(w["embed"].shape), dtype=torch.float32, device=device)
    g_table.index_add_(0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    on_grad("embed", g_table)
    out.update(loss=float(loss.detach()), aux=float(aux.detach()))
    return out
