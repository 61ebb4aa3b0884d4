"""Step functions: training (gradient accumulation + clipping + the
optimizer) and serving (prefill / one-token decode, greedy sampling) —
the counterpart of `repro.models.steps`.  The launcher
(`repro_torch.launch.train`) and the dry run (`launch.dryrun`) drive
them.
"""
from __future__ import annotations

import torch
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from ..kernels import ops as kops
from ..optim import Optimizer, apply_updates, clip_by_global_norm
from .model_zoo import Model


def _all_reduce_mean(tensors, group, n: int) -> None:
    """In place: each tensor's mean over the group's ranks (an all-reduce
    SUM, then / n: gloo has no AVG)."""
    import torch.distributed as dist
    for t in tensors:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        t.div_(n)


def _mean_over(values: dict, group, n: int) -> dict:
    """{name: scalar} averaged over the group's ranks in one all-reduce."""
    keys = list(values)
    buf = torch.stack([values[k].float().reshape(()) for k in keys])
    _all_reduce_mean([buf], group, n)
    return {k: buf[i] for i, k in enumerate(keys)}


def make_train_step(model: Model, optimizer: Optimizer, *,
                    microbatches: int = 1, clip_norm: float = 1.0,
                    data_mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), on a parameter tree (`models.layers.param_tree`).

    With microbatches > 1 the global batch is split on its leading axis
    and the gradients are accumulated in f32 over the microbatches in
    order, then divided by `microbatches`; the loss and the aux metrics
    are meaned the same way.  The gradients are clipped to `clip_norm`
    by global norm, then `optimizer.update` and `apply_updates` run.
    Metrics are {"loss", "aux/<k>"}, as `repro`'s.

    The model's forward and backward run with the kernel switch off
    (`kernels.ops.kernel_mode(False)`), scoped to the model call: the
    attention and WKV kernels have no backward (their wrappers refuse
    operands that require grad), and `repro`'s models train on the same
    plain routes (its Pallas kernels have no VJP).  The switch is left as
    it was for everything else.

    data_mesh: a `DeviceMesh` with a "data" dim over which this process
    holds one slice of the global batch (the launcher's data
    parallelism): the loss, the metrics and the gradients are averaged
    over that dim (all-reduce SUM / n) before clipping, as `repro`'s jit
    reduces them over its mesh's data axis."""
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1 (got {microbatches})")
    group, n_data = None, 1
    if data_mesh is not None:
        group = data_mesh.get_group("data")
        n_data = data_mesh.size(data_mesh.mesh_dim_names.index("data"))

    def loss_and_grads(params, mb):
        leaves, spec = tree_flatten(params)
        live = [t.detach().requires_grad_() for t in leaves]
        with kops.kernel_mode(False):
            loss, metrics = model.loss(tree_unflatten(live, spec), mb)
            grads = torch.autograd.grad(loss, live, allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                tree_unflatten(list(grads), spec))

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, batch)
        else:
            B = next(iter(batch.values())).shape[0]
            if B % microbatches:
                raise ValueError(f"global batch {B} does not split into "
                                 f"{microbatches} microbatches")
            size = B // microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            loss = None
            per_mb = []
            for i in range(microbatches):
                mb = {k: v[i * size:(i + 1) * size]
                      for k, v in batch.items()}
                l, m, g = loss_and_grads(params, mb)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = l.float() if loss is None else loss + l
                per_mb.append(m)
                del g
            grads = tree_map(lambda g: g / microbatches, grads)
            loss = loss / microbatches
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        if group is not None:
            _all_reduce_mean(tree_flatten(grads)[0], group, n_data)
            means = _mean_over({"loss": loss, **metrics}, group, n_data)
            loss = means.pop("loss")
            metrics = means
        grads = clip_by_global_norm(grads, clip_norm)
        updates, new_opt = optimizer.update(grads, opt_state, params)
        new_params = apply_updates(params, updates)
        out_metrics = {"loss": loss, **{f"aux/{k}": v
                                        for k, v in metrics.items()}}
        return new_params, new_opt, out_metrics

    return train_step


def make_prefill_step(model: Model, cache_dtype=torch.float32):
    def prefill_step(params, batch, cache_len: int | None = None):
        return model.prefill(params, batch, cache_dtype=cache_dtype,
                             cache_len=cache_len)
    return prefill_step


def make_decode_step(model: Model):
    def decode_step(params, tokens, cache):
        return model.decode_step(params, tokens, cache)
    return decode_step


def sample_greedy(logits):
    """argmax over the vocabulary (int64, the port's token dtype)."""
    return torch.argmax(logits, dim=-1)
