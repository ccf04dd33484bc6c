"""Momentum SGD, AdamW and LR schedules. Twin of ``repro.optim.sgd``.

Momentum SGD implements paper Eq. (1):

    W_{t+1} = W_t + mu * (W_t - W_{t-1}) - eta * grad_t

in velocity form (v_t = W_t - W_{t-1}):  v <- mu*v - eta*g;  W <- W + v.
Weight decay is added to the gradient (coupled, the paper's classic
formulation). It operates on any tree of tensors (``repro_torch.tree``):
the SET-MLP's ``{"values": (...), "biases": (...)}``, the LM's nested
parameter dict; it returns new tensors, and ``lr`` may be a float or a 0-d
tensor on the device.

AdamW (decoupled weight decay) is the reference's, which no caller there
uses either: its moments in f32, its order of operations, and the decay
term ``weight_decay * p`` computed in p's dtype, the scalar rounded to it
first (``kernels.ref.scalar_in``), as JAX rounds a weakly typed scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels.ref import scalar_in
from repro_torch.tree import tree_leaves, tree_map

__all__ = [
    "AdamWState",
    "MomentumSGD",
    "SGDState",
    "constant_lr",
    "cosine_lr",
    "adamw",
    "large_then_fixed_lr",
    "replace_values_velocity",
    "step_decay_lr",
    "warmup_linear_scaled_lr",
]

Params = Dict[str, Tuple[torch.Tensor, ...]]


class SGDState(NamedTuple):
    velocity: Params
    step: torch.Tensor  # int32, 0-d


def replace_values_velocity(state: SGDState, new_values_vel: Sequence[torch.Tensor]) -> SGDState:
    """Rebuild an SGDState whose ``velocity['values']`` entries were remapped
    by a topology change (SET evolution / importance pruning): momentum is
    kept on surviving connections and reset on regrown ones, paper Alg. 1."""
    velocity = dict(state.velocity)
    velocity["values"] = tuple(new_values_vel)
    return SGDState(velocity=velocity, step=state.step)


@dataclasses.dataclass(frozen=True)
class MomentumSGD:
    momentum: float = 0.9
    weight_decay: float = 0.0
    # write the velocity and the parameters in place (the same bits): a
    # model whose f32 velocity fills most of the card has no room for a
    # second copy of it
    inplace: bool = False

    def init(self, params: Params) -> SGDState:
        vel = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        device = tree_leaves(params)[0].device
        return SGDState(velocity=vel, step=torch.zeros((), dtype=torch.int32, device=device))

    def update(
        self, grads: Params, state: SGDState, params: Params, lr: Any
    ) -> Tuple[Params, SGDState]:
        mu, wd = self.momentum, self.weight_decay

        def upd(v, g, p):
            g = g.float() + wd * p.float()
            return mu * v - lr * g

        if self.inplace:
            for v, g, p in zip(tree_leaves(state.velocity), tree_leaves(grads),
                               tree_leaves(params)):
                v.mul_(mu).sub_(lr * (g.float() + wd * p.float()) if wd else lr * g.float())
                p.copy_(p.float() + v)
            return params, SGDState(velocity=state.velocity, step=state.step + 1)
        vel = tree_map(upd, state.velocity, grads, params)
        new_params = tree_map(lambda p, v: (p.float() + v).to(p.dtype), params, vel)
        return new_params, SGDState(velocity=vel, step=state.step + 1)


# ---------------------------------------------------------------------------
# AdamW (for LM training; not used by the paper's MLP experiments)
# ---------------------------------------------------------------------------


class AdamWState(NamedTuple):
    mu: Any
    nu: Any
    step: torch.Tensor  # int32, 0-d


@dataclasses.dataclass(frozen=True)
class adamw:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1

    def init(self, params) -> AdamWState:
        zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)  # noqa: E731
        device = tree_leaves(params)[0].device
        return AdamWState(mu=tree_map(zeros, params), nu=tree_map(zeros, params),
                          step=torch.zeros((), dtype=torch.int32, device=device))

    def update(self, grads, state: AdamWState, params, lr: Any) -> Tuple[Any, AdamWState]:
        step = state.step + 1
        b1, b2 = self.b1, self.b2
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state.mu, grads)
        nu = tree_map(lambda n, g: b2 * n + (1 - b2) * g.float().square(), state.nu, grads)
        c1 = 1 - b1 ** step.float()
        c2 = 1 - b2 ** step.float()

        def upd(p, m, n):
            u = (m / c1) / (torch.sqrt(n / c2) + self.eps)
            decay = scalar_in(self.weight_decay, p.dtype) * p
            return (p.float() - lr * (u + decay)).to(p.dtype)

        return tree_map(upd, params, mu, nu), AdamWState(mu=mu, nu=nu, step=step)


# ---------------------------------------------------------------------------
# LR schedules: step -> lr, in float32 as the reference computes them
# ---------------------------------------------------------------------------


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def constant_lr(lr: float) -> Callable[[int], float]:
    return lambda step: lr


def warmup_linear_scaled_lr(
    base_lr: float, k_workers: int, warmup_steps: int
) -> Callable[[int], torch.Tensor]:
    """Goyal et al. (2017): linear scaling rule (lr * K) with gradual warmup.
    Used by WASSP-SGD (the synchronous variant) per paper §2.3."""
    target = base_lr * k_workers

    def sched(step):
        frac = torch.clamp((_f32(step) + 1) / max(1, warmup_steps), max=1.0)
        return base_lr + frac * (target - base_lr)

    return sched


def large_then_fixed_lr(
    base_lr: float, boost: float, boost_steps: int
) -> Callable[[int], torch.Tensor]:
    """WASAP-SGD's observed best recipe (paper §2.3): larger LR for the first
    few epochs of the async phase, then fixed."""

    def sched(step):
        return torch.where(_f32(step) < boost_steps, _f32(base_lr * boost), _f32(base_lr))

    return sched


def step_decay_lr(base_lr: float, decay: float, every: int) -> Callable[[int], float]:
    def sched(step):
        return base_lr * (decay ** (step // every))

    return sched


def cosine_lr(base_lr: float, total_steps: int, warmup: int = 0) -> Callable[[int], torch.Tensor]:
    def sched(step):
        step = _f32(step)
        warm = torch.clamp((step + 1) / max(1, warmup), max=1.0) if warmup else 1.0
        prog = torch.clamp((step - warmup) / max(1, total_steps - warmup), 0.0, 1.0)
        return base_lr * warm * 0.5 * (1 + torch.cos(torch.pi * prog))

    return sched
