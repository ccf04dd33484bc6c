"""Step functions: the SET-MLP training loop, and the LM's prefill and
decode steps. Twin of ``repro.launch.steps``; the LM's train step
(``make_train_step``) and the Whisper steps come with the LM training slice
(ROADMAP Queue 1, item 7).

A step is loss -> gradients (autograd; on a block model the backward runs
kernels D and E) -> momentum-SGD update. PyTorch runs eagerly, so the
reference's jitted ``lax.scan`` over an epoch becomes a Python loop that
keeps every per-step loss on the device: an epoch costs the host one
synchronisation, when it reads the losses.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.mlp import SparseMLPConfig, cross_entropy_loss, mlp_forward
from repro_torch.models.transformer import PatternLM
from repro_torch.optim.sgd import MomentumSGD, SGDState
from repro_torch.tree import tree_map

__all__ = ["make_decode_step", "make_mlp_step_core", "make_mlp_train_step",
           "make_prefill_step", "scan_masked_segment", "scan_segment"]


def make_mlp_step_core(config: SparseMLPConfig, opt: MomentumSGD, topo_arrays,
                       x_all: Optional[torch.Tensor] = None,
                       y_all: Optional[torch.Tensor] = None):
    """The one SET-MLP minibatch step body (loss -> gradients -> momentum-SGD
    update), shaped for :func:`scan_segment`.

    With ``x_all``/``y_all`` (the dataset, resident on the device) the step
    input is ``(idx, lr)`` and the batch is gathered on the device; without
    them the input is ``(x, y, lr)``. ``rng`` is the ``torch.Generator`` the
    dropout masks draw from.
    """

    def step_core(p, s: SGDState, inp, rng: Optional[torch.Generator]):
        if x_all is None:
            xb, yb, lr = inp
        else:
            idx, lr = inp
            xb = x_all.index_select(0, idx)
            yb = y_all.index_select(0, idx)
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), p)
        logits = mlp_forward(leaves, topo_arrays, xb, config, train=True, rng=rng)
        loss = cross_entropy_loss(logits, yb)
        flat = [t for k in leaves for t in leaves[k]]
        grads_flat = torch.autograd.grad(loss, flat)
        grads, i = {}, 0
        for k in leaves:
            n = len(leaves[k])
            grads[k] = tuple(grads_flat[i:i + n])
            i += n
        p, s = opt.update(grads, s, p, lr)
        return p, s, loss.detach()

    return step_core


def make_mlp_train_step(config: SparseMLPConfig, opt: MomentumSGD):
    """Single-minibatch SET-MLP train step: ``step(params, opt_state,
    topo_arrays, x, y, lr, rng) -> (params, opt_state, loss)``. Topology
    arrays are inputs, so SET evolution between calls changes nothing
    here."""

    def step(params, opt_state, topo_arrays, x, y, lr, rng):
        core = make_mlp_step_core(config, opt, topo_arrays)
        return core(params, opt_state, (x, y, lr), rng)

    return step


def scan_segment(
    step_core: Callable, params, opt_state, key: Any, step_inputs: Tuple[torch.Tensor, ...]
):
    """Run a multi-step train segment: thread (params, opt_state) through
    ``step_core`` once per leading index of ``step_inputs`` and stack the
    per-step metrics on the device (no host sync). ``key`` is the
    ``torch.Generator`` every step draws from; it advances in place and is
    returned, as the reference returns its split key."""
    metrics = []
    for i in range(step_inputs[0].shape[0]):
        params, opt_state, m = step_core(params, opt_state, tuple(t[i] for t in step_inputs), key)
        metrics.append(m)
    return params, opt_state, key, torch.stack(metrics)


def scan_masked_segment(step_core: Callable, params, opt_state, key: Any,
                        step_inputs: Tuple[torch.Tensor, ...], valid: torch.Tensor):
    """:func:`scan_segment` with per-step validity weights.

    ``valid`` is a float (steps,) tensor on the device: a step whose weight
    is 0 still runs (so a padded tail keeps every shape fixed) but leaves
    the (params, opt_state) carry bit for bit as it was, by a select on the
    device (nothing reads ``valid`` on the host), and adds ``metric * 0``
    to the stacked metrics. ``step_core`` must return a scalar metric (it
    is scaled by the weight). The WASAP phase-1 rounds use it: their tail
    rounds pad the local-step axis to a fixed H."""
    metrics = []
    for i in range(valid.shape[0]):
        new_p, new_s, m = step_core(params, opt_state, tuple(t[i] for t in step_inputs), key)
        keep = valid[i] > 0
        params = tree_map(lambda n, o: torch.where(keep, n, o), new_p, params)
        opt_state = tree_map(lambda n, o: torch.where(keep, n, o), new_s, opt_state)
        metrics.append(m * valid[i])
    return params, opt_state, key, torch.stack(metrics)


def _require_lm(model) -> None:
    if not isinstance(model, PatternLM):
        raise NotImplementedError(
            f"steps for {type(model).__name__} (the Whisper encoder-decoder) come with the "
            "LM training slice (ROADMAP Queue 1, item 7)")


def make_prefill_step(model: PatternLM):
    """``prefill(params, batch, topo) -> logits[:, -1:, :]`` over
    ``batch["tokens"]`` (and ``batch["patch_embeds"]``, a VLM prefix),
    without gradients."""
    _require_lm(model)

    @torch.inference_mode()
    def prefill(params, batch, topo):
        logits, _, _ = model.forward(params, batch["tokens"], topo=topo,
                                     prefix_embeds=batch.get("patch_embeds"))
        return logits[:, -1:, :]

    return prefill


def make_decode_step(model: PatternLM):
    """``decode(params, batch, topo) -> (logits, caches)``: one token at
    ``batch["position"]`` (a scalar), the caches updated in place."""
    _require_lm(model)

    @torch.inference_mode()
    def decode(params, batch, topo):
        position = torch.as_tensor(batch["position"]).reshape(1)
        logits, new_caches, _ = model.forward(
            params, batch["tokens"], topo=topo,
            positions=position.to(batch["tokens"].device), mode="decode",
            caches=batch["caches"])
        return logits, new_caches

    return decode
