"""Plain PyTorch reference of a truly sparse SET-MLP's training steps.

Each layer is COO: connection j carries ``values[j]`` from input
``rows[j]`` to output ``cols[j]``; the layer computes
``z[b, c] = sum_{j: cols[j] = c} h[b, rows[j]] * values[j] + bias[c]``
by a gather, a product and an ``index_add``; a hidden layer applies
All-ReLU of the paper's 1-based parity (slope ``+alpha`` on odd layers,
``-alpha`` on even ones, identity above 0); the output layer is linear.
The loss is the mean cross-entropy; gradients come from autograd; the
optimizer is momentum SGD in velocity form with coupled weight decay:
``v = mu * v - lr * (g + wd * p); p = p + v``. Float32 throughout, TF32
off (no matmul is used anyway). ``precision="tf32"`` is the control:
every product's operands rounded to TF32.

It imports nothing of the program and nothing of JAX.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import torch
import torch.nn.functional as F

from bench.reference.precision import rounded


def forward(x: torch.Tensor, layers: Sequence[Dict], alpha: float,
            precision: str = "f32") -> torch.Tensor:
    """``layers``: per layer ``rows``, ``cols`` (int64), ``values``,
    ``bias`` and ``out_dim``."""
    h = x
    n = len(layers)
    for l, layer in enumerate(layers):
        contrib = rounded(rounded(h[:, layer["rows"]], precision)
                          * rounded(layer["values"], precision), precision)
        z = torch.zeros((h.shape[0], layer["out_dim"]), dtype=torch.float32,
                        device=h.device).index_add(1, layer["cols"], contrib)
        z = z + layer["bias"]
        if l < n - 1:
            slope = -alpha if (l + 1) % 2 == 0 else alpha
            z = torch.where(z > 0, z, slope * z)
        h = z
    return h


def logits_in_blocks(x, layers: Sequence[Dict], alpha: float, block: int, device,
                     precision: str = "f32") -> torch.Tensor:
    """The forward's logits over the host rows ``x``, ``block`` rows at a
    time on ``device`` (a gather of a wide layer's connections at many rows
    does not fit), on the CPU."""
    out = []
    with torch.no_grad():
        for s in range(0, x.shape[0], block):
            xb = torch.as_tensor(x[s : s + block], device=device)
            out.append(forward(xb, layers, alpha, precision).cpu())
    return torch.cat(out)


def train_steps(layers: List[Dict], batches, *, alpha: float, lr: float, momentum: float,
                weight_decay: float, precision: str = "f32") -> Dict:
    """Run ``len(batches)`` steps from ``layers``' values and biases on the
    ``(x, y)`` batches. Returns the snapshot ``compare.numbers`` reads:
    the losses, step 1's gradient per leaf and each leaf's change after
    the last step (on the CPU)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    names = [f"values.{l}" for l in range(len(layers))] + [f"biases.{l}"
                                                           for l in range(len(layers))]
    params = [layer["values"].float().clone() for layer in layers] + [
        layer["bias"].float().clone() for layer in layers]
    start = [p.detach().cpu().clone() for p in params]
    vel = [torch.zeros_like(p) for p in params]
    losses, first_grad = [], None
    n = len(layers)
    for x, y in batches:
        leaves = [p.detach().requires_grad_(True) for p in params]
        view = [dict(layer, values=leaves[l], bias=leaves[n + l])
                for l, layer in enumerate(layers)]
        loss = F.cross_entropy(forward(x, view, alpha, precision), y)
        grads = torch.autograd.grad(loss, leaves)
        losses.append(float(loss.detach()))
        if first_grad is None:
            first_grad = {k: g.detach().cpu() for k, g in zip(names, grads)}
        with torch.no_grad():
            vel = [momentum * v - lr * (g + weight_decay * p)
                   for v, g, p in zip(vel, grads, params)]
            params = [p + v for p, v in zip(params, vel)]
    delta = {k: p.detach().cpu() - s for k, p, s in zip(names, params, start)}
    return {"loss": losses, "grad": first_grad, "delta": delta}
