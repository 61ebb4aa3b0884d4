"""Optimizers built from scratch: SGD (+ momentum), AdamW, schedules and
global-norm clipping, on trees of tensors — a torch copy of
`repro.optim.optimizers`.

    opt = adamw(lr=...)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Trees are `torch.utils._pytree` trees (dicts, lists, tuples of
tensors); optimizer state mirrors the parameter tree.  A schedule maps
a step — a Python int, a numpy array or a tensor — to a float32 tensor,
so it serves both an optimizer's step counter and
`repro_torch.solve.ScheduleSpec`, which applies it to the round indices
`np.arange(K)`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, NamedTuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

Params = Any
Schedule = Callable[[Any], torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Params], Any]
    update: Callable[[Params, Any, Params], tuple[Params, Any]]


def _steps(step) -> torch.Tensor:
    """A step (int, numpy array or tensor) as a float32 tensor."""
    return torch.as_tensor(step).to(torch.float32)


def apply_updates(params: Params, updates: Params) -> Params:
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def global_norm(tree: Params) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def clip_by_global_norm(grads: Params, max_norm: float) -> Params:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads)


# ---------------------------------------------------------------------------
# Schedules
# ---------------------------------------------------------------------------

def constant_schedule(lr: float) -> Schedule:
    return lambda step: torch.full_like(_steps(step), lr)


def cosine_schedule(lr: float, warmup: int, total: int,
                    final_frac: float = 0.1) -> Schedule:
    def sched(step):
        step = _steps(step)
        warm = lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = final_frac * lr + (1 - final_frac) * lr \
            * 0.5 * (1.0 + torch.cos(math.pi * t))
        return torch.where(step < warmup, warm, cos)
    return sched


def power_schedule(base: float, power: float,
                   offset: float = 1.0) -> Schedule:
    """base · ((step + offset)/offset)^power: negative powers give the
    decaying step sizes of the decentralized-bilevel theory, positive
    ones a growing penalty; `offset` > 0 starts the schedule at exactly
    `base`."""
    if offset <= 0:
        raise ValueError(f"power_schedule offset must be > 0 "
                         f"(got {offset})")

    def sched(step):
        t = (_steps(step) + offset) / offset
        return torch.tensor(base, dtype=torch.float32) * t ** power
    return sched


def inverse_sqrt_schedule(base: float, offset: float = 1.0) -> Schedule:
    """base / √((step + offset)/offset), the O(1/√k) decay."""
    return power_schedule(base, -0.5, offset)


# ---------------------------------------------------------------------------
# SGD (+ momentum)
# ---------------------------------------------------------------------------

class SGDState(NamedTuple):
    step: torch.Tensor
    momentum: Params | None


def _zeros_f32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros_like(p, dtype=torch.float32)


def _step0(params) -> torch.Tensor:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd(lr: float | Schedule, momentum: float = 0.0) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        mom = tree_map(_zeros_f32, params) if momentum else None
        return SGDState(_step0(params), mom)

    def update(grads, state, params):
        lr_t = sched(state.step).to(state.step.device)
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state.momentum, grads)
            upd = tree_map(lambda m: -lr_t * m, mom)
        else:
            mom = None
            upd = tree_map(lambda g: -lr_t * g.float(), grads)
        return upd, SGDState(state.step + 1, mom)

    return Optimizer(init, update)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

class AdamWState(NamedTuple):
    step: torch.Tensor
    mu: Params
    nu: Params


def adamw(lr: float | Schedule, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    sched = lr if callable(lr) else constant_schedule(lr)

    def init(params):
        return AdamWState(_step0(params), tree_map(_zeros_f32, params),
                          tree_map(_zeros_f32, params))

    def update(grads, state, params):
        step = state.step + 1
        lr_t = sched(state.step).to(state.step.device)
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2)
                      * torch.square(g.float()), state.nu, grads)
        bc1 = 1 - b1 ** step.float()
        bc2 = 1 - b2 ** step.float()

        def upd(m, v, p):
            mhat = m / bc1
            vhat = v / bc2
            return -lr_t * (mhat / (torch.sqrt(vhat) + eps)
                            + weight_decay * p.float())

        return tree_map(upd, mu, nu, params), AdamWState(step, mu, nu)

    return Optimizer(init, update)
