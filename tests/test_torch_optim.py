"""`repro_torch.optim` against `repro.optim`, step for step, on the same
numpy trees.  Both run float32; the schedules' powers and cosines and
AdamW's square roots round per library, so values hold to rtol 1e-6
(atol 1e-7 near zero)."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro import optim as jopt

from repro_torch import optim as topt
from repro_torch.solve import ScheduleSpec

RTOL, ATOL = 1e-6, 1e-7
STEPS = 6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=RTOL, atol=ATOL)


SCHEDULES = {
    "constant": lambda m: m.constant_schedule(0.3),
    "cosine": lambda m: m.cosine_schedule(0.1, warmup=3, total=10),
    "power": lambda m: m.power_schedule(0.2, 0.7, offset=2.0),
    "inverse_sqrt": lambda m: m.inverse_sqrt_schedule(0.05),
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_repro(name):
    t, j = SCHEDULES[name](topt), SCHEDULES[name](jopt)
    steps = np.arange(12, dtype=np.int32)
    _close(t(steps), j(jnp.asarray(steps)))
    _close(t(torch.tensor(5, dtype=torch.int32)),
           j(jnp.asarray(5, jnp.int32)))
    # ScheduleSpec takes the port's schedules as it takes repro's (the
    # cosine warm-up starts at 0, which a step-size schedule refuses)
    if name != "cosine":
        _close(ScheduleSpec(alpha=t).materialize(12).alpha,
               j(jnp.asarray(steps)))


def test_power_schedule_refuses_nonpositive_offset():
    for m in (topt, jopt):
        with pytest.raises(ValueError, match="offset must be > 0"):
            m.power_schedule(1.0, -0.5, offset=0.0)


def _trees(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
    grads = [{"w": rng.standard_normal((3, 4)).astype(np.float32),
              "b": rng.standard_normal(4).astype(np.float32)}
             for _ in range(STEPS)]
    return params, grads


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _j(tree):
    return {k: jnp.asarray(v) for k, v in tree.items()}


OPTIMIZERS = {
    "sgd": lambda m: m.sgd(0.1),
    "sgd_momentum": lambda m: m.sgd(0.1, momentum=0.9),
    "sgd_schedule": lambda m: m.sgd(m.inverse_sqrt_schedule(0.1)),
    "adamw": lambda m: m.adamw(1e-2),
    "adamw_cosine": lambda m: m.adamw(m.cosine_schedule(1e-2, 2, 6),
                                      weight_decay=0.05),
}


@pytest.mark.parametrize("name", list(OPTIMIZERS))
def test_optimizers_match_repro_step_for_step(name):
    params, grads = _trees()
    t_opt, j_opt = OPTIMIZERS[name](topt), OPTIMIZERS[name](jopt)
    tp, jp = _t(params), _j(params)
    ts, js = t_opt.init(tp), j_opt.init(jp)
    for g in grads:
        tu, ts = t_opt.update(_t(g), ts, tp)
        ju, js = j_opt.update(_j(g), js, jp)
        tp, jp = topt.apply_updates(tp, tu), jopt.apply_updates(jp, ju)
        for k in params:
            _close(tu[k], ju[k])
            _close(tp[k], jp[k])
            assert tp[k].dtype == torch.float32
    assert int(ts.step) == int(js.step) == STEPS


def test_global_norm_and_clipping_match_repro():
    _, grads = _trees(1)
    tg, jg = _t(grads[0]), _j(grads[0])
    _close(topt.global_norm(tg), jopt.global_norm(jg))
    for max_norm in (0.5, 1e6):
        tc = topt.clip_by_global_norm(tg, max_norm)
        jc = jopt.clip_by_global_norm(jg, max_norm)
        for k in tc:
            _close(tc[k], jc[k])
    assert torch.equal(topt.clip_by_global_norm(tg, 1e6)["w"], tg["w"])


def test_apply_updates_keeps_the_parameter_dtype():
    p = {"w": torch.ones(3, dtype=torch.bfloat16)}
    u = {"w": torch.full((3,), 0.5)}
    out = topt.apply_updates(p, u)
    assert out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"].float(), torch.full((3,), 1.5))
