"""The port's topology subsystem against `repro.topology` on the CPU:
the numpy graph/weight/structure copies must agree exactly, and
`MixingOp` must compute what `repro`'s `MixingOp` computes on the same
inputs (f32: 1e-6 absolute, other operation order; bf16 storage: one
bf16 ulp, 2⁻⁷ relative).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm import CommLedger as JLedger
from repro.topology import make_mixing_op as j_make_mixing_op
from repro.topology import make_network as j_make_network
from repro.topology import structure as jstructure

from repro_torch.comm import CommLedger, parse_comm_spec
from repro_torch.topology import make_mixing_op, make_network
from repro_torch.topology import structure as tstructure

GRAPHS = [("ring", {}), ("circulant", {"offsets": (1, 2)}),
          ("erdos_renyi", {"r": 0.5, "seed": 0}), ("star", {})]
# 18 neighbors per agent: the circulant tier at n = 64 (2(k+1) ≤ n)
MANY_OFFSETS = {"offsets": tuple(range(1, 10))}


@pytest.mark.parametrize("kind,kw", GRAPHS + [("complete", {}),
                                              ("uniform", {})])
def test_networks_match_exactly(kind, kw):
    jn, tn = j_make_network(kind, 12, **kw), make_network(kind, 12, **kw)
    assert jn.name == tn.name
    np.testing.assert_array_equal(jn.adj, tn.adj)
    np.testing.assert_array_equal(jn.W, tn.W)
    assert jn.sigma == tn.sigma and jn.num_edges == tn.num_edges
    jc, tc = (jstructure.circulant_structure(jn.W),
              tstructure.circulant_structure(tn.W))
    assert (jc is None) == (tc is None)
    if jc is not None:
        assert dataclasses.astuple(jc) == dataclasses.astuple(tc)
    js, ts = (jstructure.sparse_structure(jn.W),
              tstructure.sparse_structure(tn.W))
    for field in ("w_self", "rowptr", "col", "val", "row", "neighbors",
                  "weights"):
        np.testing.assert_array_equal(getattr(js, field), getattr(ts, field))
    assert (js.n, js.k, js.nnz) == (ts.n, ts.k, ts.nnz)


@pytest.mark.parametrize("kind,kw", GRAPHS)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("laplacian", [False, True])
def test_mixing_op_matches_repro(kind, kw, dtype, laplacian):
    n = 16
    jop = j_make_mixing_op(j_make_network(kind, n, **kw), dtype=dtype)
    top = make_mixing_op(make_network(kind, n, **kw), dtype=dtype,
                         device="cpu")
    assert jop.backend == top.backend
    y = np.random.default_rng(0).standard_normal((n, 3, 40)).astype(
        np.float32)
    want = np.asarray(jop._apply(jnp.asarray(y), laplacian))
    got = top._apply(torch.as_tensor(y), laplacian).numpy()
    assert got.shape == y.shape and got.dtype == np.float32
    if dtype == "f32":
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    else:
        assert np.abs(got - want).max() <= 2.0 ** -7 * np.abs(want).max()


@pytest.mark.parametrize("kind,kw", GRAPHS)
def test_neumann_step_matches_repro(kind, kw):
    n, d = 16, 50
    jop = j_make_mixing_op(j_make_network(kind, n, **kw))
    top = make_mixing_op(make_network(kind, n, **kw), device="cpu")
    rng = np.random.default_rng(1)
    h, hvp, p = (rng.standard_normal((n, d)).astype(np.float32)
                 for _ in range(3))
    dsc = rng.uniform(1.5, 3.0, (n, 1)).astype(np.float32)
    want = jop.neumann_step(*(jnp.asarray(a) for a in (h, hvp, p, dsc)),
                            0.3)
    got = top.neumann_step(*(torch.as_tensor(a) for a in (h, hvp, p, dsc)),
                           0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("laplacian", [False, True])
def test_many_offsets_circulant_matches_repro(laplacian):
    """A circulant graph with 18 neighbors per agent takes the circulant
    tier on both sides, for the mix and the fused Neumann step."""
    n, d = 64, 40
    jop = j_make_mixing_op(j_make_network("circulant", n, **MANY_OFFSETS))
    top = make_mixing_op(make_network("circulant", n, **MANY_OFFSETS),
                         device="cpu")
    assert jop.backend.startswith("circulant") and top.backend == "circulant"
    rng = np.random.default_rng(2)
    h, hvp, p = (rng.standard_normal((n, d)).astype(np.float32)
                 for _ in range(3))
    dsc = rng.uniform(1.5, 3.0, (n, 1)).astype(np.float32)
    np.testing.assert_allclose(
        top._apply(torch.as_tensor(h), laplacian).numpy(),
        np.asarray(jop._apply(jnp.asarray(h), laplacian)), atol=1e-6,
        rtol=0)
    np.testing.assert_allclose(
        top.neumann_step(*(torch.as_tensor(a) for a in (h, hvp, p, dsc)),
                         0.3).numpy(),
        np.asarray(jop.neumann_step(*(jnp.asarray(a)
                                      for a in (h, hvp, p, dsc)), 0.3)),
        atol=1e-6, rtol=0)


def test_auto_rules_and_pallas_aliases():
    """circulant when 2(k+1) ≤ n; padded gather when n·k ≤ 2·nnz, CSR
    otherwise (star); dense when nnz + n = n²; `*_pallas` names alias
    the port's kernel tiers."""
    ring = make_network("ring", 8)
    assert make_mixing_op(ring, device="cpu").backend == "circulant"
    assert make_mixing_op(make_network("ring", 4),
                          device="cpu").backend == "sparse_gather"
    er = make_mixing_op(make_network("erdos_renyi", 16, r=0.5, seed=0),
                        device="cpu")
    assert er.backend == "sparse_gather" and er._sp_use_padded
    star = make_mixing_op(make_network("star", 16), device="cpu")
    assert star.backend == "sparse_gather" and not star._sp_use_padded
    assert make_mixing_op(make_network("complete", 6),
                          device="cpu").backend == "dense"
    wide = make_mixing_op(make_network("circulant", 64, **MANY_OFFSETS),
                          device="cpu")
    assert wide.backend == "circulant" and wide._circ_off.shape == (18,)
    assert make_mixing_op(ring, "circulant_pallas",
                          device="cpu").backend == "circulant"
    assert make_mixing_op(ring, "sparse_gather_pallas",
                          device="cpu").backend == "sparse_gather"
    with pytest.raises(ValueError, match="requires a circulant W"):
        make_mixing_op(make_network("star", 6), "circulant", device="cpu")
    with pytest.raises(ValueError, match="unknown mixing backend"):
        make_mixing_op(ring, "halo", device="cpu")


def test_queued_features_raise_naming_their_roadmap_item():
    """Nothing of the op is queued any more: the ledger's obs hook (item
    10) publishes into a registry, fault masks (item 7) run — an
    all-ones mask mixes as the op itself — and every comm spec `repro`
    accepts builds (compressed gossip, item 5)."""
    from repro_torch import obs
    op = make_mixing_op(make_network("ring", 8), device="cpu")
    reg = obs.MetricsRegistry()
    op.ledger.observe(reg)
    # no channel opened yet: the families, no samples
    assert obs.parse_prometheus(obs.prometheus_text(reg)) == {}
    y = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (8, 5)).astype(np.float32))
    torch.testing.assert_close(op.masked(np.ones((8, 2))).mix(y), op.mix(y),
                               rtol=0, atol=1e-6)
    for spec in ("int8+ef", "int4", "bf16", "top_k:0.1", "rand_k:0.25+ef"):
        assert make_mixing_op(make_network("ring", 8), comm=spec,
                              device="cpu").comm.spec == spec
    with pytest.raises(ValueError, match="meaningless"):
        parse_comm_spec("identity+ef")


def test_identity_channels_count_sends_and_ledger_matches_repro():
    top = make_mixing_op(make_network("ring", 8), device="cpu")
    y = torch.zeros(8, 6)
    st = top.comm_channel("inner_y", y)
    for _ in range(3):
        _, st = top.mix_c(y, st)
    _, st = top.laplacian_c(y, st)
    assert st.sends == 4 and st.hat is None
    top.ledger.charge_states([st])
    from repro.comm import parse_comm_spec as j_parse
    led = JLedger(top.ledger.name)
    led.register("inner_y", (6,), j_parse("identity"))
    led.charge("inner_y", 4)
    assert top.ledger.total_bytes == led.total_bytes == 4 * 6 * 4
    assert top.ledger.summary(rounds=2) == led.summary(rounds=2)
    from repro import obs as jobs_obs
    from repro_torch import obs
    treg, jreg = obs.MetricsRegistry(), jobs_obs.MetricsRegistry()
    top.ledger.observe(treg, run="a")
    jobs_obs.observe_ledger(led, jreg, run="a")
    assert obs.prometheus_text(treg) == jobs_obs.prometheus_text(jreg)
    CommLedger().observe(obs.MetricsRegistry())


def test_entry_points_need_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mixing_op(make_network("ring", 8))
    assert make_mixing_op(make_network("ring", 8),
                          device="cpu").W.device.type == "cpu"
