"""Step functions: the SET-MLP training loop, and the LM's and Whisper's
train, prefill and decode steps. Twin of ``repro.launch.steps``.

A step is loss -> gradients (autograd; on a block model, and on the LM's
sparse FFN, the backward runs kernels D and E) -> momentum-SGD update.
PyTorch runs eagerly, so the reference's jitted ``lax.scan`` over an epoch
becomes a Python loop that keeps every per-step loss on the device: an
epoch costs the host one synchronisation, when it reads the losses. The
LM's step (:func:`make_train_step`) keeps its loss on the device too.
"""
from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

from repro_torch.models.mlp import SparseMLPConfig, cross_entropy_loss, mlp_forward
from repro_torch.models.transformer import PatternLM, chunked_softmax_xent
from repro_torch.models.whisper import WhisperModel
from repro_torch.optim.sgd import MomentumSGD, SGDState
from repro_torch.tree import tree_flatten, tree_map

__all__ = ["lm_loss_fn", "make_decode_step", "make_mlp_step_core", "make_mlp_train_step",
           "make_prefill_step", "make_train_step", "scan_masked_segment", "scan_segment",
           "whisper_loss_fn"]


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


def _microbatched_grad(loss_fn: Callable, params, batch, microbatches: int):
    """``(total, loss, grads)`` of ``loss_fn(params, batch) -> (total,
    loss)``, the batch cut along its leading axis into ``microbatches``
    that run one after another (activation memory scales 1/microbatches).
    With more than one, the gradients accumulate in f32 and every result is
    the mean over the microbatches, as the reference's scan computes it."""
    leaves, unflatten = tree_flatten(params)

    def grad_of(b):
        ps = [p.detach().requires_grad_(True) for p in leaves]
        total, loss = loss_fn(unflatten(ps), b)
        grads = torch.autograd.grad(total, ps, allow_unused=True)
        return total.detach(), loss.detach(), [
            torch.zeros_like(p) if g is None else g for p, g in zip(ps, grads)]

    if microbatches <= 1:
        total, loss, grads = grad_of(batch)
        return total, loss, unflatten(grads)
    mb = tree_map(lambda a: a.reshape(microbatches, a.shape[0] // microbatches, *a.shape[1:]),
                  batch)
    g_acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves]
    t_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    l_acc = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    for i in range(microbatches):
        total, loss, grads = grad_of(tree_map(lambda a, i=i: a[i], mb))
        g_acc = [a + g.float() for a, g in zip(g_acc, grads)]
        t_acc, l_acc = t_acc + total, l_acc + loss
    inv = 1.0 / microbatches
    return t_acc * inv, l_acc * inv, unflatten([a * inv for a in g_acc])


def make_train_step(model, *, lr: float = 1e-2, momentum: float = 0.9,
                    microbatches: int = 1):
    """The train step and its optimizer, ``(train_step, opt)``; momentum
    SGD with weight decay 1e-4, gradients by :func:`_microbatched_grad`,
    every metric kept on the device.

    A ``PatternLM``'s: ``train_step(params, opt_state, batch, topo) ->
    (params, opt_state, {"loss", "total"})``, with ``batch["tokens"]`` and
    ``batch["labels"]`` (B, S) (and ``batch["patch_embeds"]``, a VLM prefix
    whose positions carry no loss). The loss is :func:`chunked_softmax_xent`
    of the final hidden states, plus the MoE auxiliary loss summed over the
    layers (:func:`lm_loss_fn`).

    A ``WhisperModel``'s: ``train_step(params, opt_state, batch) ->
    (params, opt_state, {"loss"})``, with ``batch["frames"]`` (B, frames,
    d_model), ``batch["tokens"]`` and ``batch["labels"]`` (B, S): the
    encoder, the teacher-forced decoder, the logits cast to f32, then the
    mean NLL under ``log_softmax``."""
    opt = MomentumSGD(momentum=momentum, weight_decay=1e-4)

    if isinstance(model, WhisperModel):
        loss_fn_w = whisper_loss_fn(model)

        def train_step_w(params, opt_state, batch):
            _, loss, grads = _microbatched_grad(loss_fn_w, params, batch, microbatches)
            params, opt_state = opt.update(grads, opt_state, params, lr)
            return params, opt_state, {"loss": loss}

        return train_step_w, opt

    def train_step(params, opt_state, batch, topo):
        total, loss, grads = _microbatched_grad(lm_loss_fn(model, topo), params, batch,
                                                microbatches)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, {"loss": loss, "total": total}

    return train_step, opt


def lm_loss_fn(model: PatternLM, topo, chunk: int = 512) -> Callable:
    """The train step's loss, ``loss_fn(params, batch) -> (total, loss)``:
    :func:`chunked_softmax_xent` (``chunk`` positions at a time) of the
    final hidden states against ``batch["labels"]``, and ``total`` = loss +
    the MoE auxiliary loss (0 without an MoE FFN), whose gradient the step
    takes."""

    def loss_fn(p, b):
        h, _, aux = model.forward(p, b["tokens"], topo=topo,
                                  prefix_embeds=b.get("patch_embeds"), return_hidden=True)
        labels = b["labels"]
        if "patch_embeds" in b:
            h = h[:, b["patch_embeds"].shape[1]:]
            labels = labels[:, : h.shape[1]]
        loss = chunked_softmax_xent(model, p, h, labels, chunk=chunk)
        return loss + aux, loss

    return loss_fn


def whisper_loss_fn(model: WhisperModel) -> Callable:
    """Whisper's train-step loss, ``loss_fn(params, batch) -> (loss,
    loss)``: the encoder on ``batch["frames"]``, the teacher-forced decoder
    on ``batch["tokens"]``, the logits cast to f32, and the mean NLL of
    ``batch["labels"]`` under ``log_softmax``."""

    def loss_fn(p, batch):
        mem = model.encode(p, batch["frames"])
        h = model.decode_train(p, batch["tokens"], mem)
        logp = torch.log_softmax(model.logits(p, h).float(), dim=-1)
        loss = -logp.gather(-1, batch["labels"].long().unsqueeze(-1)).mean()
        return loss, loss

    return loss_fn


def make_prefill_step(model):
    """A ``PatternLM``'s ``prefill(params, batch, topo) -> logits[:, -1:,
    :]`` over ``batch["tokens"]`` (and ``batch["patch_embeds"]``, a VLM
    prefix); a ``WhisperModel``'s ``prefill(params, batch)``, the logits at
    the last of ``batch["tokens"]`` after encoding ``batch["frames"]`` (it
    fills no cache, as the reference's does not). No gradients."""
    if isinstance(model, WhisperModel):

        @torch.inference_mode()
        def prefill_w(params, batch):
            mem = model.encode(params, batch["frames"])
            h = model.decode_train(params, batch["tokens"], mem)
            return model.logits(params, h[:, -1:, :])

        return prefill_w

    @torch.inference_mode()
    def prefill(params, batch, topo):
        logits, _, _ = model.forward(params, batch["tokens"], topo=topo,
                                     prefix_embeds=batch.get("patch_embeds"))
        return logits[:, -1:, :]

    return prefill


def make_decode_step(model):
    """One token at ``batch["position"]`` (a scalar), the caches updated in
    place: a ``PatternLM``'s ``decode(params, batch, topo) -> (logits,
    caches)``; a ``WhisperModel``'s ``decode(params, batch)``, which also
    reads the encoder's output ``batch["memory"]``."""
    if isinstance(model, WhisperModel):

        @torch.inference_mode()
        def decode_w(params, batch):
            return model.decode_step(params, batch["tokens"], batch["position"],
                                     batch["caches"], batch["memory"])

        return decode_w

    @torch.inference_mode()
    def decode(params, batch, topo):
        position = torch.as_tensor(batch["position"]).reshape(1)
        logits, new_caches, _ = model.forward(
            params, batch["tokens"], topo=topo,
            positions=position.to(batch["tokens"].device), mode="decode",
            caches=batch["caches"])
        return logits, new_caches

    return decode
