"""Carry `repro`'s state across into the port.

`load_problem` builds the port's `BilevelProblem` from the data arrays
of a `repro` problem (as numpy), so a run can start from the JAX
package's exact instance; `solve(..., x0=, y0=)` takes numpy arrays for
the iterates.  Together they let both packages run on identical inputs
without depending on either's random generators:

    from repro.core.problems import ho_regression
    jprob = ho_regression(8, 16)
    tprob = load_problem("ho_regression",
                         {k: np.asarray(v) for k, v in jprob.data.items()},
                         device="cpu")

`load_lm_params` does the same for a language model: it turns
`repro`'s `Model.init` parameter pytree (as numpy arrays) into the
port's state dict, so both packages run one model on identical weights:

    jparams = repro_model.init(jax.random.PRNGKey(0))
    state = load_lm_params(cfg, jax.tree.map(np.asarray, jparams),
                           device="cpu")
    params = build_model(cfg).init(device="meta")
    params.load_state_dict(state, assign=True)

`stack_layers` / `unstack_layers` convert a parameter tree
(`models.layers.param_tree`) to and from `repro`'s layout, the layers
of `blocks` / `enc_layers` / `dec_layers` stacked on a leading axis:
the trainer checkpoints the stacked tree, so `repro.checkpoint` restores
the port's files into `repro`'s own parameter template.

This module imports nothing of `repro`; the caller converts.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.problems import FAMILY_FROM_DATA, BilevelProblem

# `repro`'s parameter trees that stack their layers on a leading axis
_STACKED = ("blocks", "enc_layers", "dec_layers")


def load_problem(family: str, data: dict, *, device=None,
                 **family_kwargs) -> BilevelProblem:
    """The port's `family` problem on `data` ({name: array}, leading
    agent axis), on `device` (CUDA unless named).

    family_kwargs are the family's non-data settings: quadratic
    (mu_g, mu_f), ho_svm (smooth), ho_softmax (n_classes),
    hyper_representation (hidden, n_classes, ridge), fair_loss_tuning
    (n_classes, ridge)."""
    try:
        build = FAMILY_FROM_DATA[family]
    except KeyError:
        raise KeyError(f"unknown problem family {family!r}; expected one "
                       f"of {sorted(FAMILY_FROM_DATA)}") from None
    arrays = {k: np.asarray(v) for k, v in data.items()}
    return build(arrays, device=device, **family_kwargs)


def _tensor(a) -> torch.Tensor:
    """numpy → torch with the dtype kept (bfloat16 from ml_dtypes too)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _flatten(tree, prefix: str, out: dict, stacked: bool) -> None:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, dict):
            if key in _STACKED and not stacked:
                n = np.asarray(next(_leaves(value))).shape[0]
                for i in range(n):
                    _flatten(_index(value, i), f"{name}.{i}.", out, True)
            else:
                _flatten(value, f"{name}.", out, stacked)
        else:
            out[name] = value


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _index(tree, i: int):
    return {k: _index(v, i) if isinstance(v, dict) else np.asarray(v)[i]
            for k, v in tree.items()}


def stack_layers(tree: dict) -> dict:
    """`repro`'s layout of a port parameter tree: each per-layer list of
    `blocks` / `enc_layers` / `dec_layers` stacked on a leading axis."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([lay[k] for lay in layers]) for k in first}
        return torch.stack(layers)
    return {k: stack(v) if k in _STACKED and isinstance(v, list)
            else stack_layers(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


def unstack_layers(tree: dict) -> dict:
    """The inverse of `stack_layers`: the stacked layers as a list of
    per-layer trees (views of the stacked tensors)."""
    def take(t, i):
        return {k: take(v, i) for k, v in t.items()} \
            if isinstance(t, dict) else t[i]
    out = {}
    for k, v in tree.items():
        if k in _STACKED and isinstance(v, dict):
            out[k] = [take(v, i) for i in range(next(_leaves(v)).shape[0])]
        else:
            out[k] = unstack_layers(v) if isinstance(v, dict) else v
    return out


def load_lm_params(cfg, params: dict, *, device=None) -> dict:
    """The port model's state dict from `repro`'s `Model(cfg).init`
    pytree `params` (nested dicts of numpy arrays): the leading layer
    axis of `blocks` / `enc_layers` / `dec_layers` unstacked into the
    `nn.ModuleList`'s entries, every dtype kept, on `device` (CUDA
    unless named).  Raises ValueError where a name or shape differs from
    the port's model of `cfg`."""
    from .models import build_model
    device = resolve_device(device)
    flat: dict = {}
    _flatten(params, "", flat, False)
    want = {name: tuple(p.shape) for name, p in
            build_model(cfg).init(device="meta").named_parameters()}
    if set(flat) != set(want):
        raise ValueError(f"parameter names differ from the port's "
                         f"{cfg.name}: missing {sorted(set(want) - set(flat))}"
                         f", unexpected {sorted(set(flat) - set(want))}")
    state = {}
    for name, value in flat.items():
        t = _tensor(value)
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, the port's "
                             f"{cfg.name} has {want[name]}")
        state[name] = t.to(device)
    return state
