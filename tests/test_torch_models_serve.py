"""Serving on the port's model zoo against `repro.models` on the CPU,
for every architecture at its `reduced()` size in f32, on `repro`'s
parameters carried across by `repro_torch.interop.load_lm_params`: a
prefill followed by 4 greedy decode steps (`models.steps`).

Tolerance: logits as test_torch_models.py (atol 2e-5 / rtol 1e-5).
Greedy tokens must be equal wherever `repro`'s top-2 logit margin is
above that tolerance; both decode from `repro`'s tokens, so the two
streams stay aligned.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS
from repro_torch.models import steps

from test_torch_models import ALL_ARCHS, LOGIT_TOL, _batch, _close, carried

DECODE_STEPS = 4


@pytest.fixture(scope="module", params=ALL_ARCHS)
def pair(request):
    arch = request.param
    # MoE: a capacity no token overflows, so prefill and decode route alike
    extra = {"capacity_factor": 8.0} if ARCHS[arch].num_experts else {}
    return (arch, *carried(arch, **extra))


def test_prefill_then_greedy_decode_matches_repro(pair):
    arch, jm, jparams, tm, tparams = pair
    B, S = 2, 12
    jb, tb = _batch(tm.cfg, B, S, seed=2)
    del jb["labels"], tb["labels"]
    want, jcache = jax.jit(lambda p, b: jm.prefill(
        p, b, cache_len=S + DECODE_STEPS))(jparams, jb)
    j_decode = jax.jit(jm.decode_step)
    prefill = steps.make_prefill_step(tm)
    decode = steps.make_decode_step(tm)
    got, cache = prefill(tparams, tb, cache_len=S + DECODE_STEPS)
    assert got.shape == (B, tm.cfg.padded_vocab)
    for step in range(DECODE_STEPS + 1):
        _close(got, want)
        top2 = np.sort(np.asarray(want), axis=-1)[:, -2:]
        margin = top2[:, 1] - top2[:, 0]
        ours = steps.sample_greedy(got).numpy()
        theirs = np.array(jnp.argmax(want, -1))
        assert ours.dtype == np.int64
        clear = margin > LOGIT_TOL["atol"]
        np.testing.assert_array_equal(ours[clear], theirs[clear])
        if step == DECODE_STEPS:
            break
        tok = theirs[:, None]
        want, jcache = j_decode(jparams, jnp.asarray(tok, jnp.int32), jcache)
        got, cache = decode(tparams, torch.as_tensor(tok), cache)
    assert cache["pos"] == int(jcache["pos"]) == S + DECODE_STEPS
