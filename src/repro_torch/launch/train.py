"""Training launcher (counterpart of `repro.launch.train`).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --smoke --steps 20 --seq-len 128 --global-batch 8 [--device cpu]

Builds the mesh over the default process group's ranks (this process
alone where none exists; `torchrun` for more), takes the sharding rules,
streams the synthetic token pipeline, runs `make_train_step` under
AdamW with a cosine schedule, checkpoints and logs.  `--smoke` swaps in
the reduced config so the same launcher runs on the CPU.  The card is the
default device; `--device cpu` runs on the CPU (gloo).

Data parallelism is the mesh's "data" dim: each rank takes its rows of
the global batch, and the step averages the loss, the metrics and the
gradients over the dim (all-reduce SUM / n).  Model parallelism
(`--model-parallel > 1`, the parameters laid out by
`tree_param_sharding`'s placements as DTensors) is not ported and is
refused (ROADMAP item 12d).

Checkpoints hold the parameters in `repro`'s layout
(`interop.stack_layers`), so `repro.checkpoint` restores them into
`repro`'s model; as `repro`'s launcher, a resumed run starts its
optimizer state afresh.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..checkpoint import latest_step, restore_checkpoint, save_checkpoint
from ..configs import get_config
from ..data import TokenDataConfig, make_token_batch
from ..distributed.sharding import make_rules
from ..interop import stack_layers, unstack_layers
from ..models import build_model
from ..models.layers import param_tree
from ..models.steps import make_train_step
from ..optim import adamw, cosine_schedule
from .mesh import make_host_mesh


def _args(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def frames_for(cfg, step: int, batch: int, device) -> torch.Tensor:
    """Whisper's stub-frontend frames of step `step`: 0.02·N(0, 1) from a
    generator seeded with the step."""
    gen = torch.Generator(device=device).manual_seed(step)
    return 0.02 * torch.randn((batch, cfg.encoder_frames, cfg.d_model),
                              generator=gen, device=device)


def main(argv=None):
    """Run the launcher; returns 0 iff the last loss is finite.  A process
    group that this call creates (none existed) is destroyed on return."""
    import torch.distributed as dist
    args = _args(argv)
    device = resolve_device(args.device)
    if args.model_parallel > 1:
        raise ValueError(
            f"--model-parallel {args.model_parallel}: model parallelism "
            f"(parameters as DTensors on tree_param_sharding's placements) "
            f"is not ported; ROADMAP item 12d")
    own_group = not dist.is_initialized()
    try:
        return _run(args, device)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> int:
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    model = build_model(cfg)

    mesh = make_host_mesh(model=args.model_parallel,
                          device_type=device.type)
    rules = make_rules(cfg, mesh)
    axes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n_data = axes["data"]
    rank = mesh.get_local_rank("data")
    if args.global_batch % n_data:
        raise ValueError(f"global batch {args.global_batch} does not split "
                         f"over {n_data} data ranks")
    rows = slice(rank * args.global_batch // n_data,
                 (rank + 1) * args.global_batch // n_data)
    print(f"[train] {cfg.name}: {model.param_count() / 1e6:.1f}M params, "
          f"mesh {axes}, batch over {rules.resolve('batch')}, "
          f"device {device}")

    opt = adamw(cosine_schedule(args.lr, args.warmup, args.steps))
    data_cfg = TokenDataConfig(vocab_size=cfg.vocab_size,
                               seq_len=args.seq_len,
                               global_batch=args.global_batch,
                               seed=args.seed)
    params = param_tree(model.init(seed=args.seed, device=device))
    opt_state = opt.init(params)
    step_fn = make_train_step(model, opt, microbatches=args.microbatches,
                              data_mesh=mesh if n_data > 1 else None)

    start = 0
    if args.ckpt_dir and (s := latest_step(args.ckpt_dir)) is not None:
        params = unstack_layers(restore_checkpoint(
            args.ckpt_dir, s, stack_layers(params)))
        start = s
        print(f"[train] restored step {s}")

    def save(step):
        if rank == 0 and mesh.get_local_rank("model") == 0:
            save_checkpoint(args.ckpt_dir, step, stack_layers(params))

    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = make_token_batch(data_cfg, step, device=device)
        if cfg.encoder_decoder:
            batch["frames"] = frames_for(cfg, step, args.global_batch,
                                         device)
        batch = {k: v[rows] for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"[train] step {step:5d} loss {losses[-1]:.4f} "
                  f"({dt:.1f}s)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
    if args.ckpt_dir:
        save(args.steps)
    if not losses:
        print(f"[train] nothing to run: restored step {start} of "
              f"{args.steps}")
        return 0
    improved = losses[-1] < losses[0]
    print(f"[train] done: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"(improved={improved})")
    return 0 if np.isfinite(losses[-1]) else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
