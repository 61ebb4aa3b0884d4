"""Synthetic token data pipeline (offline: no real corpora).

Generates deterministic, structured token streams — a mixture of
Zipf-distributed unigrams with first-order Markov structure per "domain"
— so that models can actually reduce loss and the decentralized LM runs
get *non-iid per-agent shards* (each agent is biased toward a subset of
domains, mirroring the paper's heterogeneity-q protocol at LM scale).

Counterpart of `repro.data.synthetic`.  The generator is `repro`'s numpy
code unchanged, so one (seed, step) gives the same tokens bit for bit in
both packages; the batch is then handed over as int64 tensors on the
named device (CUDA unless the caller names another).  `lm_batch_spec`
gives meta-device stand-ins of the same shapes and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class TokenDataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_domains: int = 8
    zipf_a: float = 1.2
    markov_weight: float = 0.5     # blend of markov vs unigram sampling
    seed: int = 0


def _domain_tables(cfg: TokenDataConfig):
    """Per-domain unigram dist + sparse markov successor table."""
    rng = np.random.default_rng(cfg.seed)
    V = cfg.vocab_size
    ranks = np.arange(1, V + 1, dtype=np.float64)
    tables = []
    for d in range(cfg.n_domains):
        perm = rng.permutation(V)
        uni = (ranks ** -cfg.zipf_a)
        uni /= uni.sum()
        uni = uni[np.argsort(perm)]            # domain-specific head words
        succ = rng.integers(0, V, size=(V, 4)) # 4 likely successors/token
        tables.append((uni, succ))
    return tables


def _token_ids(cfg: TokenDataConfig, step: int,
                   domain_bias: np.ndarray | None = None) -> np.ndarray:
    """The (B, S + 1) int32 token stream of one batch, as `repro` draws
    it; deterministic in (cfg.seed, step)."""
    rng = np.random.default_rng((cfg.seed, step))
    tables = _domain_tables(cfg)
    B, S = cfg.global_batch, cfg.seq_len
    bias = (np.full(cfg.n_domains, 1.0 / cfg.n_domains)
            if domain_bias is None else domain_bias)
    doms = rng.choice(cfg.n_domains, size=B, p=bias / bias.sum())
    toks = np.empty((B, S + 1), np.int32)
    for b in range(B):
        uni, succ = tables[doms[b]]
        seq = rng.choice(cfg.vocab_size, size=S + 1, p=uni)
        # overlay markov structure: with prob markov_weight, next token is
        # a fixed successor of the previous one
        use_markov = rng.random(S) < cfg.markov_weight
        pick = rng.integers(0, succ.shape[1], size=S)
        for t in range(1, S + 1):
            if use_markov[t - 1]:
                seq[t] = succ[seq[t - 1], pick[t - 1]]
        toks[b] = seq
    return toks


def make_token_batch(cfg: TokenDataConfig, step: int,
                     domain_bias: np.ndarray | None = None, *,
                     device=None) -> dict[str, torch.Tensor]:
    """One {"tokens", "labels"} batch of (B, S) int64 tensors on `device`;
    deterministic in (cfg.seed, step).

    domain_bias: optional (n_domains,) probabilities — used to make
    per-agent non-iid shards for decentralized training."""
    dev = resolve_device(device)
    toks = torch.from_numpy(_token_ids(cfg, step, domain_bias)
                            .astype(np.int64))
    return {"tokens": toks[:, :-1].contiguous().to(dev),
            "labels": toks[:, 1:].contiguous().to(dev)}


def token_batches(cfg: TokenDataConfig, num_steps: int,
                  domain_bias: np.ndarray | None = None, *,
                  device=None) -> Iterator[dict]:
    for step in range(num_steps):
        yield make_token_batch(cfg, step, domain_bias, device=device)


def agent_domain_bias(n_agents: int, n_domains: int, q: float) -> np.ndarray:
    """Heterogeneity-q bias per agent (paper §6.3 protocol, LM version):
    agent i puts mass q on domain i mod D, the rest uniform."""
    bias = np.full((n_agents, n_domains), (1.0 - q) / n_domains)
    for i in range(n_agents):
        bias[i, i % n_domains] += q
    return bias


def lm_batch_spec(seq_len: int, global_batch: int,
                  with_labels: bool = True) -> dict[str, torch.Tensor]:
    """Meta-device stand-ins (shape and dtype, no storage) of a batch."""
    spec = {"tokens": torch.empty((global_batch, seq_len),
                                  dtype=torch.int64, device="meta")}
    if with_labels:
        spec["labels"] = torch.empty((global_batch, seq_len),
                                     dtype=torch.int64, device="meta")
    return spec
