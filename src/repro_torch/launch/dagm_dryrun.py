"""The paper's own technique at LM scale: one DAGM outer round (Algorithm
2 — M inner DGD steps, DIHGP, the outer step) of decentralized
loss-weight tuning, with the inner variable y a whole LM — the
counterpart of `repro.launch.dagm_dryrun`.

    outer x ∈ R^{N_DOMAINS+1}: per-domain loss weights + log weight decay
    inner y = the LM's parameters: g_i = the x-weighted CE on agent i's
              train shard + exp(clip(x_wd))·1e-5·‖y‖²/2
    outer f_i = the unweighted CE on agent i's validation shard

Every cross-agent exchange is a gossip of parameter trees on a ring
(`repro_torch.distributed.make_sharded_dagm`).  On a `LocalRing` every
agent sits on one card, each leaf carries a leading agent axis, and each
leaf's gossip is one launch of a mixing kernel: the padded-gather
`sparse_mix_matvec` (rows 3 / 3f) at n < 6, where "auto" takes the
sparse tier, the circulant kernels (rows 1 / 1f) from n = 6.  Each leaf
of the port's tree is one layer's tensor, so a gossip sends one wire row
a layer where `repro` sends one row of the layers stacked: the same
rows on the identity wire, and per-layer quantization rows on a
compressed one.

`build_dagm_bilevel` gives the per-agent objectives, `agent_batches` the
agents' non-iid shards (`examples/train_lm_dagm.py`'s), and `init_agents`
their parameter trees.  `run` / `main` are the dry run: the round traced
on the meta device, which allocates nothing, at the two depths of
`costs.depth_pair` and fitted affine to the full depth
(`costs.affine_correct`; the full depth takes minutes to trace), with
the FLOPs, bytes and peak of `launch.dryrun`'s tracer and the wire bytes
of `sharded_comm_ledger`.

    PYTHONPATH=src python -m repro_torch.launch.dagm_dryrun \\
        --arch qwen3-4b [--agents 16] [--seq-len 4096] [--batch-per-agent 16]
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils._pytree import tree_leaves, tree_map

from ..kernels import ops as kops

N_DOMAINS = 8


def build_dagm_bilevel(cfg, *, seq_len: int, batch_per_agent: int,
                       dcfg=None):
    """Per-agent bilevel objectives (g_fn, f_fn) of decentralized
    loss-weight tuning: fn(x, y, batch) on one agent's x ((N_DOMAINS +
    1,) f32), parameter tree y (`models.layers.param_tree`) and batch
    {"train", "val"} of {"tokens", "labels" (B, S), "domain" (B,)}.

    The padded vocabulary is masked to −1e30 before the log-sum-exp;
    ‖y‖² is taken in f32 on a bf16 tree too.
    The model runs on a parameter tree, which `torch.func` maps over
    (vmap over the agents, grad, and the jvp of the HVPs), with the kernel
    switch off for the model call only: a CUDA kernel has no batching or
    forward-AD rule, and `repro`'s model differentiates its plain route
    too.  The gossips, outside these functions, keep the switch as the
    caller set it."""
    from ..models import transformer as tf

    D = N_DOMAINS

    def weighted_ce(x, y, batch, weighted: bool):
        with kops.kernel_mode(False):
            logits, _ = tf.forward(y, cfg, batch["tokens"])
        logits = logits.float()
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= cfg.vocab_size
        lse = torch.logsumexp(
            torch.where(pad, torch.full_like(logits, -1e30), logits),
            dim=-1)
        true = torch.gather(logits, -1, batch["labels"][..., None])[..., 0]
        ce = lse - true
        if weighted:
            wdom = torch.softmax(x[:D], dim=0)[batch["domain"]]
            ce = ce * wdom[:, None] * D
        return torch.mean(ce)

    def g_fn(x, y, batch):
        wd = 1e-5 * torch.exp(torch.clamp(x[D], -3.0, 3.0))
        # each leaf's norm in f32, as `repro` squares an f32 copy; the
        # norm's autodiff keeps the leaf itself, not an f32 copy of it
        l2 = sum(torch.linalg.vector_norm(p, dtype=torch.float32).square()
                 for p in tree_leaves(y))
        return weighted_ce(x, y, batch["train"], True) + 0.5 * wd * l2

    def f_fn(x, y, batch):
        return weighted_ce(x, y, batch["val"], False)

    return g_fn, f_fn


def batch_shapes(cfg, n_agents: int, seq_len: int, batch_per_agent: int):
    """Meta-device stand-ins of the ring's batch tree."""
    B, S = batch_per_agent, seq_len
    meta = lambda *shape: torch.empty(shape, dtype=torch.int64,
                                      device="meta")
    one = lambda: {"tokens": meta(n_agents, B, S),
                   "labels": meta(n_agents, B, S),
                   "domain": meta(n_agents, B)}
    return {"train": one(), "val": one()}


def agent_batches(cfg, n_agents: int, seq_len: int, batch_per_agent: int,
                  step: int, *, het_q: float = 0.5, device=None) -> dict:
    """The ring's batch of round `step`: each agent's non-iid shard of the
    synthetic token stream (`agent_domain_bias` at heterogeneity `het_q`),
    the train split from data seed 0 and the validation split from seed
    1, each sequence labelled with its agent's dominant domain, as
    `examples/train_lm_dagm.py` draws them."""
    from ..data import TokenDataConfig, make_token_batch
    from ..data.synthetic import agent_domain_bias
    bias = agent_domain_bias(n_agents, N_DOMAINS, het_q)

    def split(seed):
        data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=seq_len,
                               global_batch=batch_per_agent,
                               n_domains=N_DOMAINS, seed=seed)
        per = [make_token_batch(data, step * n_agents + i,
                                domain_bias=bias[i], device=device)
               for i in range(n_agents)]
        out = {k: torch.stack([p[k] for p in per]) for k in per[0]}
        dom = torch.as_tensor(np.argmax(bias, -1), device=out["tokens"].device)
        out["domain"] = dom[:, None].repeat(1, batch_per_agent)
        return out
    return {"train": split(0), "val": split(1)}


def init_agents(model, n_agents: int, *, seed: int = 0,
                dtype=torch.float32, device=None):
    """The ring's y: agent i's parameters drawn from seed + i
    (`Model.init`), stacked on a leading agent axis (one agent's draw
    alive at a time beside the stack)."""
    from ..models.layers import param_tree
    stacked = None
    for i in range(n_agents):
        one = param_tree(model.init(seed=seed + i, dtype=dtype,
                                    device=device))
        if stacked is None:
            stacked = tree_map(lambda t: t.new_empty((n_agents,) + t.shape),
                               one)
        tree_map(lambda s, t: s[i].copy_(t), stacked, one)
        del one
    return stacked


class _CountingRing:
    """A `LocalRing` with every exchange's per-agent payload bytes counted
    under its wire policy (identity: 4 bytes an element, as the ledger
    charges)."""

    def __init__(self, ring):
        self.ring, self.bytes = ring, []

    def __getattr__(self, name):
        return getattr(self.ring, name)

    def _count(self, leaves, policy):
        comp = policy.compressor
        self.bytes.append(sum(comp.payload_bytes(tuple(t.shape[1:]))
                              for t in leaves))

    def mix(self, leaves, **kw):
        from ..comm import parse_comm_spec
        wire = "identity" if kw.get("comm_dtype") is None else "bf16"
        self._count(leaves, parse_comm_spec(wire))
        return self.ring.mix(leaves, **kw)

    def mix_c(self, leaves, hats, policy, seeds, **kw):
        self._count(leaves, policy)
        return self.ring.mix_c(leaves, hats, policy, seeds, **kw)


def _trace_round(cfg, spec, n_agents, seq_len, batch_per_agent, dtype):
    """One round of `cfg` traced on the meta device: (`trace_costs`'s
    dict, the traced gossips' payload bytes per agent).  The round's last
    exchange is the consensus metric's full-precision mix of x, which the
    ledger does not charge, and is left out."""
    from ..distributed import LocalRing, make_sharded_dagm, round_channels
    from ..models import build_model
    from .dryrun import trace_costs
    g_fn, f_fn = build_dagm_bilevel(cfg, seq_len=seq_len,
                                    batch_per_agent=batch_per_agent,
                                    dcfg=spec)
    ring = _CountingRing(LocalRing(n_agents, device="meta"))
    step, _ = make_sharded_dagm(g_fn, f_fn, spec, ring)
    y = init_agents(build_model(cfg), n_agents, dtype=dtype, device="meta")
    x = torch.empty((n_agents, N_DOMAINS + 1), device="meta")
    batch = batch_shapes(cfg, n_agents, seq_len, batch_per_agent)
    cost = trace_costs(lambda: step(x, y, batch,
                                    round_channels(spec, x, y, 0, 0)))
    return cost, float(sum(ring.bytes[:-1]))


def run(arch: str, *, n_agents: int = 16, seq_len: int = 4096,
        batch_per_agent: int = 16, M: int = 2, U: int = 3,
        comm: str = "identity", param_dtype: str = "f32",
        mix_every: int = 1, verbose: bool = True) -> dict:
    """One DAGM round of decentralized loss-weight tuning on a ring of
    `n_agents` (the production mesh's data axis: 16), traced on the meta
    device at `costs.depth_pair`'s depths and fitted to the full one:
    FLOPs, bytes and peak a device (one agent a device: the ring's totals
    / n), the wire bytes per agent from `sharded_comm_ledger`, and the
    traced gossips' own payload bytes beside them."""
    from ..configs import get_config
    from ..models import build_model
    from ..distributed import sharded_comm_ledger
    from ..solve import sharded_spec
    from .costs import affine_correct, depth_pair, reduced_depth
    from .mesh import (H100_HBM_BYTES_PER_S, H100_NVLINK_BYTES_PER_S,
                       H100_PEAK_FLOPS_BF16)

    dtype = torch.bfloat16 if param_dtype == "bf16" else torch.float32
    cfg = get_config(arch)
    spec = sharded_spec(alpha=0.3, beta=0.1, M=M, U=U, curvature=8.0,
                        comm=comm, mix_every=mix_every)
    pair = depth_pair(cfg)
    traced = {L: _trace_round(reduced_depth(cfg, L), spec, n_agents,
                              seq_len, batch_per_agent, dtype)
              for L in pair}

    def fit(value):
        return affine_correct(*(value(*traced[L]) for L in pair), *pair,
                              cfg.num_layers)

    y = init_agents(build_model(cfg), 1, dtype=dtype, device="meta")
    one = [t[0] for t in tree_leaves(y)]
    ledger = sharded_comm_ledger(spec, torch.empty(N_DOMAINS + 1,
                                                   device="meta"), one)
    n = n_agents
    flops = fit(lambda cost, _: cost["flops"]) / n
    nbytes = fit(lambda cost, _: cost["bytes"]) / n
    trace_s = sum(cost["seconds"] for cost, _ in traced.values())
    terms = {"compute_s": flops / H100_PEAK_FLOPS_BF16,
             "memory_s": nbytes / H100_HBM_BYTES_PER_S,
             "collective_s": ledger.total_bytes / H100_NVLINK_BYTES_PER_S}
    bound = max(terms, key=terms.get)
    out = {"arch": arch, "agents": n, "layers": cfg.num_layers,
           "traced_layers": list(pair), "M": M, "U": U, "comm": comm,
           "param_dtype": param_dtype, "mix_every": mix_every,
           "seq_len": seq_len, "batch_per_agent": batch_per_agent,
           "params_per_agent": sum(t.numel() for t in one),
           "trace_s": trace_s, "flops": flops, "bytes": nbytes,
           "peak_memory_per_device":
               sum(t.numel() * t.element_size() for t in one)
               + fit(lambda cost, _: cost["peak_live"]) / n,
           "collective_bytes": float(ledger.total_bytes),
           "traced_gossip_bytes": fit(lambda _, wire: wire),
           "roofline": terms, "bottleneck": bound}
    if verbose:
        t = {k: f"{v * 1e3:.2f}ms" for k, v in terms.items()}
        print(f"[dagm-dryrun] OK {arch} ({n} agents, {cfg.num_layers} "
              f"layers, fitted from {pair}) M={M} U={U} comm={comm} "
              f"trace={trace_s:.1f}s "
              f"mem/dev={out['peak_memory_per_device'] / 1e9:.2f}GB "
              f"wire={ledger.total_bytes / 1e9:.3f}GB roofline={t} "
              f"bound={bound}")
    return out


def main(argv=None):
    import argparse
    import json
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--agents", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=4096)
    ap.add_argument("--batch-per-agent", type=int, default=16)
    ap.add_argument("--inner-steps", type=int, default=2)
    ap.add_argument("--neumann-u", type=int, default=3)
    ap.add_argument("--comm", default="identity",
                    help="repro_torch.comm gossip spec (identity, bf16, "
                         "int8+ef, ...)")
    ap.add_argument("--param-dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--mix-every", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.arch, n_agents=args.agents, seq_len=args.seq_len,
              batch_per_agent=args.batch_per_agent, M=args.inner_steps,
              U=args.neumann_u, comm=args.comm,
              param_dtype=args.param_dtype, mix_every=args.mix_every)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
