"""The LM trainer and the decentralized bilevel LM round on the card.
Every test needs a CUDA device and skips without one; on the H100 run

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu_train.py

* `make_train_step` on the reduced qwen3-4b, 2 AdamW steps on the card
  against the same steps on the CPU from the same draw, f32 with TF32
  off: losses, parameters and moments within rtol 1e-4 / atol 1e-5 (the
  tolerance of tests/test_torch_train.py against `repro`);
* the step launches no kernel at a kernel-route shape (S % 128 == 0),
  where the serving forward launches flash attention once a layer;
* one bilevel LM round (`launch.dagm_dryrun.build_dagm_bilevel` through
  `make_sharded_dagm`, reduced qwen3-4b at depth 1, f32) on
  LocalRing(4) — every leaf gossip on the padded gather (rows 3 / 3f) —
  and LocalRing(8) — on the circulant kernels (rows 1 / 1f) — with exact
  launch counts on the identity wire and int8+ef, and no flash-attention
  launch.
"""
from __future__ import annotations

import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_map

from repro_torch.configs import get_config
from repro_torch.data import TokenDataConfig, make_token_batch
from repro_torch.distributed import (LocalRing, make_sharded_dagm,
                                     round_channels)
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.launch import dagm_dryrun as dd
from repro_torch.launch.costs import reduced_depth
from repro_torch.models import build_model
from repro_torch.models.layers import param_tree
from repro_torch.models.steps import make_train_step
from repro_torch.optim import adamw, cosine_schedule
from repro_torch.solve import sharded_spec

pytestmark = pytest.mark.gpu

TOL = dict(rtol=1e-4, atol=1e-5)
SPEC = dict(alpha=0.3, beta=0.1, M=2, U=2, curvature=8.0)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    return torch.device("cuda")


def _batch(cfg, step, dev, seq=64, batch=4):
    data = TokenDataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                           global_batch=batch, seed=0)
    return make_token_batch(data, step, device=dev)


def test_train_step_on_the_card_matches_the_cpu(cuda):
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg)
    cpu = param_tree(model.init(seed=0, device="cpu"))
    runs = {}
    for dev in ("cpu", cuda):
        params = tree_map(lambda t: t.to(dev), cpu)
        opt = adamw(cosine_schedule(3e-4, 1, 4))
        state = opt.init(params)
        step = make_train_step(model, opt, microbatches=2)
        losses = []
        for s in range(2):
            params, state, m = step(params, state, _batch(cfg, s, dev))
            losses.append(m["loss"])
        runs[str(dev)] = (losses, params, state.mu, state.nu)
    for got, want in zip(runs["cuda"], runs["cpu"]):
        for g, w in zip(tree_flatten(got)[0], tree_flatten(want)[0]):
            torch.testing.assert_close(g.cpu(), w, **TOL)


def test_train_step_launches_no_kernel(cuda):
    cfg = get_config("qwen3-4b").reduced()
    model = build_model(cfg)
    params = param_tree(model.init(seed=0, device=cuda))
    opt = adamw(1e-3)
    batch = _batch(cfg, 0, cuda, seq=128, batch=2)
    reset_launch_counts()
    _, _, m = make_train_step(model, opt)(params, opt.init(params), batch)
    assert not any(launch_counts().values())
    assert torch.isfinite(m["loss"])
    with torch.no_grad():                    # the serving forward
        model.loss(params, batch)
    assert launch_counts()["flash_attention"] == cfg.num_layers


@pytest.mark.parametrize("comm", ["identity", "int8+ef"])
@pytest.mark.parametrize("n", [4, 8])
def test_lm_round_launches(cuda, n, comm):
    cfg = reduced_depth(get_config("qwen3-4b").reduced(), 1)
    spec = sharded_spec(comm=comm, **SPEC)
    g_fn, f_fn = dd.build_dagm_bilevel(cfg, seq_len=128, batch_per_agent=2,
                                       dcfg=spec)
    step, _ = make_sharded_dagm(g_fn, f_fn, spec, LocalRing(n, cuda))
    y = dd.init_agents(build_model(cfg), n, device=cuda)
    x = torch.zeros((n, dd.N_DOMAINS + 1), device=cuda)
    batch = dd.agent_batches(cfg, n, 128, 2, 0, device=cuda)
    L = len(tree_flatten(y)[0])
    reset_launch_counts()
    x1, y1, m, _ = step(x, y, batch, round_channels(spec, x, y, 0, 0))
    counts = {k: v for k, v in launch_counts().items() if v}
    gossips = (spec.M + spec.U) * L + 1          # y, h leaves and x
    kind = "sparse_mix_matvec" if n < 6 else "circulant_mix_matvec"
    if comm == "identity":
        want = {kind: gossips + 1}               # + the consensus mix
    else:
        want = {kind: 1, f"{kind}_comm": gossips}
    # the circulant mix's narrow leaves take its unstaged kernel
    got = {k.replace("_unstaged", ""): 0 for k in counts}
    for k, v in counts.items():
        got[k.replace("_unstaged", "")] += v
    assert got == want
    assert torch.isfinite(m["outer_loss"]) and torch.isfinite(x1).all()
