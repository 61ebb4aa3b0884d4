"""The port's sharded tier (`repro_torch.distributed`, `solve(tier=
"sharded")` on a `LocalRing`) against `repro`'s on the CPU.

`repro`'s tier runs `shard_map` over 8 devices, which jax grants only
through XLA_FLAGS at process start, so one module-scoped subprocess
runs every `repro` case and writes an .npz; the port runs here on the
same numpy inputs.  `repro` draws its y0 from `jax.random`, so the
subprocess draws it once and both packages take it as y0.

Stochastic compression: `repro` splits a `jax.random` key per agent,
channel, send and leaf; the port keys its hash uniforms on (stream, agent
row, column).  The int8+ef cases hand the port `repro`'s uniforms: each
leaf's send seed (`collectives.leaf_send_seed`) becomes a token for its
(stream, send, leaf), and the port's quantizers look the token's (n, F)
uniforms up in place of `hash_uniform`, rows by agent, as
tests/test_torch_faults.py does for the masked gossip.

Tolerances: gossips 1e-6 absolute (a few f32 terms, summed in another
order); solves rtol = atol = 1e-5 on x, y and every metric; the flight
rows' gap and penalty 1e-4 relative to their largest value (as
`repro`'s own recorder test holds them against its reference tier), the
wire column exact; the port's tier against its own reference tier 1e-4
absolute (`tests/test_sharded.py`'s bound).
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.comm import channel_init, parse_comm_spec
from repro_torch.comm import compressors
from repro_torch.core import problems as tp
from repro_torch.distributed import (LocalRing, RingWeights,
                                     collectives, dagm_sharded,
                                     open_sharded_channels, ring_laplacian,
                                     ring_laplacian_c, ring_mix, ring_mix_c,
                                     round_channels, sharded_comm_ledger)
from repro_torch.faults import FaultSpec
from repro_torch.kernels import ref
from repro_torch.optim import inverse_sqrt_schedule
from repro_torch.solve import ScheduleSpec, dagm_spec, sharded_spec, solve
from repro_torch.topology import make_network

SRC = Path(__file__).resolve().parents[1] / "src"
N, D1, D2, K, M, U = 8, 3, 4, 12, 10, 5
GOSSIP_ATOL = 1e-6
SOLVE_TOL = 1e-5
FLIGHT_RTOL = 1e-4
REF_TIER_ATOL = 1e-4
GOSSIP_COMMS = ("identity", "bf16", "top_k:0.5+ef", "int8+ef")
SOLVE_CASES = {
    "identity": dict(),
    "bf16": dict(comm="bf16"),
    "top_k": dict(comm="top_k:0.5+ef"),
    "mix_every2": dict(mix_every=2),
    "decay": dict(decay=True),
    "int8ef": dict(comm="int8+ef"),
    "int8ef_persist": dict(comm="int8+ef", persist_ef=True),
}

SCRIPT = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import dataclasses
import jax, jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import obs
from repro.comm import channel_init, parse_comm_spec
from repro.core import quadratic_bilevel
from repro.distributed import shard_map
from repro.distributed.collectives import (RingWeights, ring_laplacian,
                                           ring_laplacian_c, ring_mix,
                                           ring_mix_c)
from repro.optim import inverse_sqrt_schedule
from repro.solve import ScheduleSpec, sharded_spec, solve

out = {{}}
devs = jax.devices()

def mesh_of(n):
    return Mesh(np.array(devs[:n]).reshape(n), ("data",))

def curv_of(prob, n):
    return float(max(np.linalg.eigvalsh(np.asarray(prob.data["A"][i])).max()
                     for i in range(n)))

# --- gossips on (8, 5) and on a two-leaf tree ---
rng = np.random.default_rng(0)
z = rng.standard_normal((8, 5)).astype(np.float32)
tree = {{"a": rng.standard_normal((8, 5)).astype(np.float32),
        "b": rng.standard_normal((8, 2, 3)).astype(np.float32)}}
w = RingWeights.metropolis_ring(8)
mesh = mesh_of(8)
sq = lambda t: jax.tree.map(lambda a: a[0], t)
ex = lambda t: jax.tree.map(lambda a: a[None], t)
for tag, val in (("z", z), ("tree", tree)):
    def plain(zz):
        zz = sq(zz)
        return (ex(ring_mix(zz, "data", w)), ex(ring_laplacian(zz, "data", w)),
                ex(ring_mix(zz, "data", w, jnp.bfloat16)))
    res = jax.jit(shard_map(plain, mesh=mesh, in_specs=P("data"),
                            out_specs=P("data"), check_vma=False))(val)
    for name, r in zip(("mix", "lap", "mixbf16"), res):
        for i, leaf in enumerate(jax.tree.leaves(r)):
            out[f"g_{{tag}}_{{name}}_{{i}}"] = np.asarray(leaf)
    for spec in {comms!r}:
        pol = parse_comm_spec(spec)
        def chan(zz, key):
            zz = sq(zz)
            key = jax.random.fold_in(key, jax.lax.axis_index("data"))
            st = channel_init(pol, "ch", zz, key)
            m1, st = ring_mix_c(zz, "data", w, pol, st)
            l2, st = ring_laplacian_c(zz, "data", w, pol, st)
            return ex(m1), ex(l2), st.sends
        m1, l2, sends = jax.jit(shard_map(
            chan, mesh=mesh, in_specs=(P("data"), P()),
            out_specs=(P("data"), P("data"), P()), check_vma=False))(
                val, jax.random.PRNGKey(7))
        for name, r in (("mixc", m1), ("lapc", l2)):
            for i, leaf in enumerate(jax.tree.leaves(r)):
                out[f"g_{{tag}}_{{spec}}_{{name}}_{{i}}"] = np.asarray(leaf)
        out[f"g_{{tag}}_{{spec}}_sends"] = np.asarray(sends)

# --- solve(tier="sharded") ---
for n, cases in ((8, {cases!r}), (2, {{"identity": {{}}}}),
                 (3, {{"identity": {{}}}})):
    prob = quadratic_bilevel(n, {d1}, {d2}, seed=0)
    curv = curv_of(prob, n)
    out[f"curv_{{n}}"] = np.float64(curv)
    x0 = jnp.zeros((n, {d1}), jnp.float32)
    y0 = 0.01 * jax.random.normal(jax.random.PRNGKey(0), (n, {d2}),
                                  jnp.float32)
    out[f"y0_{{n}}"] = np.asarray(y0)
    for case, kw in cases.items():
        kw = dict(kw)
        decay = kw.pop("decay", False)
        spec = sharded_spec(alpha=0.05, beta=0.1, M={M}, U={U},
                            curvature=curv, K={K}, **kw)
        if decay:
            spec = dataclasses.replace(spec, schedule=ScheduleSpec(
                alpha=inverse_sqrt_schedule(0.05), beta=0.1))
        rec = obs.RecorderSpec(capacity=32) if case == "identity" else None
        res = solve(prob, None, spec, mesh=mesh_of(n), x0=x0, y0=y0,
                    seed=0, recorder=rec)
        tag = f"s{{n}}_{{case}}"
        out[tag + "_x"] = np.asarray(res.x)
        out[tag + "_y"] = np.asarray(res.y)
        for key, val in res.metrics.items():
            out[tag + "_m_" + key] = np.asarray(val)
        out[tag + "_bytes"] = np.float64(res.ledger.total_bytes)
        if rec is not None:
            out[tag + "_flight"] = np.asarray(res.extras["flight"])
np.savez({path!r}, **out)
print("OK")
"""


@pytest.fixture(scope="module")
def jr(tmp_path_factory):
    """`repro`'s outputs (module-scoped: one subprocess)."""
    path = str(tmp_path_factory.mktemp("sharded") / "repro.npz")
    cases = {k: {kk: vv for kk, vv in v.items()}
             for k, v in SOLVE_CASES.items()}
    script = SCRIPT.format(src=str(SRC), comms=GOSSIP_COMMS, cases=cases,
                           d1=D1, d2=D2, M=M, U=U, K=K, path=path)
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-3000:]
    return dict(np.load(path))


def _gossip_inputs():
    rng = np.random.default_rng(0)
    z = rng.standard_normal((8, 5)).astype(np.float32)
    tree = {"a": rng.standard_normal((8, 5)).astype(np.float32),
            "b": rng.standard_normal((8, 2, 3)).astype(np.float32)}
    return {"z": torch.as_tensor(z),
            "tree": {k: torch.as_tensor(v) for k, v in tree.items()}}


def _leaves(t):
    return [t] if isinstance(t, torch.Tensor) else [t["a"], t["b"]]


class Tokens:
    """`repro`'s per-agent uniforms for the port's quantizers: a token per
    (stream, send, leaf), looked up in place of `hash_uniform`."""

    def __init__(self):
        self.token, self.table = {}, {}

    def add(self, seed: int, send: int, leaf: int, u: np.ndarray) -> None:
        tok = len(self.table)
        self.token[(seed, send, leaf)] = tok
        self.table[tok] = torch.tensor(np.asarray(u, np.float32))

    def patch(self, monkeypatch):
        monkeypatch.setattr(collectives, "leaf_send_seed",
                            lambda st, leaf: self.token[(st.seed, st.sends,
                                                         leaf)])
        lookup = lambda seed, rows, cols: self.table[seed][rows, cols]
        monkeypatch.setattr(ref, "hash_uniform", lookup)
        monkeypatch.setattr(compressors, "hash_uniform", lookup)


def _agent_uniforms(keys, widths, sends):
    """[send][leaf] -> (n, F) uniforms: each agent's key split once per
    send into (key, one subkey per leaf), as `repro`'s `ring_mix_c`."""
    split = jax.vmap(lambda k: jax.random.split(k, len(widths) + 1))
    out = []
    for _ in range(sends):
        parts = split(keys)
        keys = parts[:, 0]
        out.append([np.asarray(jax.vmap(
            lambda k, f=f: jax.random.uniform(k, (1, f), jnp.float32)[0])(
                parts[:, 1 + i])) for i, f in enumerate(widths)])
    return out


# ---------------------------------------------------------------------------
# gossips
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tag", ["z", "tree"])
def test_ring_mix_and_laplacian_match_repro(jr, tag):
    ring = LocalRing(N, device="cpu")
    val = _gossip_inputs()[tag]
    for name, fn in (("mix", lambda t: ring_mix(t, ring)),
                     ("lap", lambda t: ring_laplacian(t, ring)),
                     ("mixbf16", lambda t: ring_mix(t, ring,
                                                    torch.bfloat16))):
        for i, leaf in enumerate(_leaves(fn(val))):
            np.testing.assert_allclose(leaf.numpy(),
                                       jr[f"g_{tag}_{name}_{i}"],
                                       rtol=0, atol=GOSSIP_ATOL)


@pytest.mark.parametrize("comm", GOSSIP_COMMS)
@pytest.mark.parametrize("tag", ["z", "tree"])
def test_channel_gossips_match_repro(jr, tag, comm, monkeypatch):
    """ring_mix_c then ring_laplacian_c on one channel (the second send
    reads the first's EF replica); int8+ef on `repro`'s uniforms."""
    ring = LocalRing(N, device="cpu")
    val = _gossip_inputs()[tag]
    pol = parse_comm_spec(comm)
    st = channel_init(pol, "ch", val, 1234)
    if pol.stochastic:
        widths = [int(np.prod(leaf.shape[1:])) for leaf in _leaves(val)]
        keys = jax.vmap(lambda a: jax.random.fold_in(
            jax.random.PRNGKey(7), a))(jnp.arange(N))
        tokens = Tokens()
        for s, us in enumerate(_agent_uniforms(keys, widths, 2)):
            for leaf, u in enumerate(us):
                tokens.add(st.seed, s, leaf, u)
        tokens.patch(monkeypatch)
    m1, st = ring_mix_c(val, ring, pol, st)
    l2, st = ring_laplacian_c(val, ring, pol, st)
    assert st.sends == int(jr[f"g_{tag}_{comm}_sends"]) == 2
    for name, res in (("mixc", m1), ("lapc", l2)):
        for i, leaf in enumerate(_leaves(res)):
            np.testing.assert_allclose(leaf.numpy(),
                                       jr[f"g_{tag}_{comm}_{name}_{i}"],
                                       rtol=0, atol=GOSSIP_ATOL)


# ---------------------------------------------------------------------------
# solve(tier="sharded")
# ---------------------------------------------------------------------------

def _spec(n_curv, **kw):
    kw = dict(kw)
    decay = kw.pop("decay", False)
    spec = sharded_spec(alpha=0.05, beta=0.1, M=M, U=U, curvature=n_curv,
                        K=K, **kw)
    if decay:
        spec = dataclasses.replace(spec, schedule=ScheduleSpec(
            alpha=inverse_sqrt_schedule(0.05), beta=0.1))
    return spec


def _solve_tokens(spec, n, seed=0):
    """`repro`'s uniforms of a stochastic sharded solve, keyed by the
    port's (stream, send, leaf) of the same send."""
    tokens = Tokens()
    widths = {"inner_y": D2, "dihgp_h": D2, "outer_x": D1}
    sends = {"inner_y": M, "dihgp_h": U, "outer_x": 1}
    tpl_x, tpl_y = torch.zeros((n, D1)), torch.zeros((n, D2))
    agents = jnp.arange(n)
    if spec.comm.persist_ef:
        keys = jax.vmap(lambda i: jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(seed), i), 3))(agents)
        streams = open_sharded_channels(spec, tpl_x, tpl_y, seed)
        for c, name in enumerate(("inner_y", "dihgp_h", "outer_x")):
            us = _agent_uniforms(keys[:, c], [widths[name]],
                                 sends[name] * K)
            for s, (u,) in enumerate(us):
                tokens.add(streams[name].seed, s, 0, u)
        return tokens
    for k in range(K):
        rk = jax.random.fold_in(jax.random.PRNGKey(seed ^ 0x5eed), k)
        keys = jax.vmap(lambda a: jax.random.split(
            jax.random.fold_in(rk, a), 3))(agents)
        streams = round_channels(spec, tpl_x, tpl_y, seed, k)
        for c, name in enumerate(("inner_y", "dihgp_h", "outer_x")):
            for s, (u,) in enumerate(_agent_uniforms(
                    keys[:, c], [widths[name]], sends[name])):
                tokens.add(streams[name].seed, s, 0, u)
    return tokens


def _port_solve(jr, n, spec, recorder=None):
    prob = tp.quadratic_bilevel(n, D1, D2, seed=0, device="cpu")
    return solve(prob, None, spec, mesh=LocalRing(n, device="cpu"),
                 y0=jr[f"y0_{n}"], seed=0, recorder=recorder)


def _close(res, jr, tag):
    for name in ("x", "y"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   jr[f"{tag}_{name}"], rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL)
    keys = {k[len(tag) + 3:] for k in jr if k.startswith(tag + "_m_")}
    assert keys == set(res.metrics)
    for key in keys:
        np.testing.assert_allclose(res.metrics[key].numpy(),
                                   jr[f"{tag}_m_{key}"], rtol=SOLVE_TOL,
                                   atol=SOLVE_TOL)


@pytest.mark.parametrize("case", list(SOLVE_CASES))
def test_solve_sharded_matches_repro(jr, case, monkeypatch):
    spec = _spec(float(jr["curv_8"]), **SOLVE_CASES[case])
    if dagm_sharded.sharded_policy(spec).stochastic:
        _solve_tokens(spec, N).patch(monkeypatch)
    res = _port_solve(jr, N, spec)
    assert res.tier == "sharded" and res.metrics["outer_loss"].shape == (K,)
    _close(res, jr, f"s8_{case}")
    assert res.ledger.total_bytes == jr[f"s8_{case}_bytes"]
    sends = res.metrics["comm_sends"]
    per_round = res.ledger.total_sends() // K
    want = per_round * (torch.arange(K) + 1) if spec.comm.persist_ef \
        else torch.full((K,), per_round)
    assert torch.equal(sends, want.float())


@pytest.mark.parametrize("n,hops", [(8, 1), (2, 1), (9, 2), (4, 2)])
def test_ring_weights_match_repro(n, hops):
    """`RingWeights` as `repro`'s; `matrix()` (what the gossip applies)
    equals `to_network().W` unless offsets ±o coincide (n ≤ 2·hops)."""
    from repro.distributed.collectives import RingWeights as JWeights
    if hops == 1:
        t, j = RingWeights.metropolis_ring(n), JWeights.metropolis_ring(n)
    else:
        t = RingWeights.metropolis_circulant(n, hops)
        j = JWeights.metropolis_circulant(n, hops)
    assert (t.n, t.w_self, t.offsets) == (j.n, j.w_self, j.offsets)
    net = t.to_network().W
    np.testing.assert_allclose(net, np.asarray(j.to_network().W), atol=0)
    W = t.matrix()
    np.testing.assert_allclose(W.sum(axis=1), 1.0, atol=1e-15)
    if n > 2 * hops:
        np.testing.assert_allclose(W, net, rtol=0, atol=1e-15)
    else:
        assert not np.allclose(W, net)


@pytest.mark.parametrize("n", [2, 3])
def test_small_rings_match_repro(jr, n):
    """n = 2: both offsets reach the one neighbour (W₀₁ = 2/3, not
    `to_network`'s 1/2); n = 3: a complete graph."""
    w = RingWeights.metropolis_ring(n)
    assert w.matrix()[0, 1] == pytest.approx(2 / 3 if n == 2 else 1 / 3)
    if n == 2:
        assert w.to_network().W[0, 1] == pytest.approx(0.5)
    res = _port_solve(jr, n, _spec(float(jr[f"curv_{n}"])))
    _close(res, jr, f"s{n}_identity")


def test_flight_rows_match_repro(jr):
    spec = _spec(float(jr["curv_8"]))
    before = obs.counter_value("jit_traces_total", name="sharded_dagm_step")
    base = _port_solve(jr, N, spec)
    res = _port_solve(jr, N, spec, recorder=obs.RecorderSpec(capacity=32))
    after = obs.counter_value("jit_traces_total", name="sharded_dagm_step")
    assert after - before == 2          # one step build per solve
    assert torch.equal(base.x, res.x) and torch.equal(base.y, res.y)
    assert set(base.metrics) == set(res.metrics)
    fl, jfl = res.extras["flight"], jr["s8_identity_flight"]
    assert fl.shape == jfl.shape == (K, len(obs.FIELDS))
    np.testing.assert_array_equal(fl[:, 0], np.arange(K))
    iw = obs.FIELDS.index("wire_bytes")
    led = [sharded_comm_ledger(spec, torch.zeros(D1), torch.zeros(D2),
                               rounds=k + 1).total_bytes for k in range(K)]
    np.testing.assert_array_equal(fl[:, iw], np.asarray(led, np.float32))
    np.testing.assert_array_equal(fl[:, iw], jfl[:, iw])
    for field in ("outer_gap_sq", "penalty"):
        i = obs.FIELDS.index(field)
        err = np.max(np.abs(fl[:, i] - jfl[:, i])) / np.max(np.abs(jfl[:, i]))
        assert err < FLIGHT_RTOL, (field, err)
    assert np.all(fl[:, obs.FIELDS.index("alive_fraction")] == 1.0)


def test_sharded_tier_matches_the_reference_tier(jr):
    """The same ring, init and curvature through the port's reference
    tier (matrix-free DIHGP): one algorithm, two algebras."""
    curv = float(jr["curv_8"])
    res = _port_solve(jr, N, _spec(curv))
    prob = tp.quadratic_bilevel(N, D1, D2, seed=0, device="cpu")
    rres = solve(prob, make_network("ring", N),
                 dagm_spec(alpha=0.05, beta=0.1, K=K, M=M, U=U,
                           dihgp="matrix_free", curvature=curv),
                 y0=jr["y0_8"], device="cpu")
    for name in ("x", "y"):
        err = (getattr(res, name) - getattr(rres, name)).abs().max().item()
        assert err < REF_TIER_ATOL, (name, err)
    torch.testing.assert_close(res.metrics["outer_loss"],
                               rres.metrics["outer_obj"], rtol=0,
                               atol=REF_TIER_ATOL)


def test_tree_state_and_raw_objectives():
    """Raw g_fn/f_fn over dict trees: one wire row per leaf per agent
    (ledger), the same trajectory as the flat problem's."""
    prob = tp.quadratic_bilevel(N, D1, D2, seed=0, device="cpu")
    curv = 6.0
    y0 = 0.01 * np.random.default_rng(1).standard_normal(
        (N, D2)).astype(np.float32)

    def g(x, y, b):
        return prob.g(torch.cat([x["u"], x["v"]]), torch.cat(
            [y["p"], y["q"]]), b)

    def f(x, y, b):
        return prob.f(torch.cat([x["u"], x["v"]]), torch.cat(
            [y["p"], y["q"]]), b)
    ring = LocalRing(N, device="cpu")
    for comm in ("identity", "int8+ef"):
        spec = sharded_spec(alpha=0.05, beta=0.1, M=4, U=3, K=4,
                            curvature=curv, comm=comm)
        flat = solve(prob, None, spec, mesh=ring, y0=y0)
        x0 = {"u": torch.zeros(N, 1), "v": torch.zeros(N, 2)}
        yt = {"p": torch.as_tensor(y0[:, :1]), "q": torch.as_tensor(y0[:, 1:])}
        res = solve(None, None, spec, mesh=ring, g_fn=g, f_fn=f,
                    batch=prob.data, x0=x0, y0=yt)
        led = sharded_comm_ledger(spec, {"u": torch.zeros(1),
                                         "v": torch.zeros(2)},
                                  {"p": torch.zeros(1), "q": torch.zeros(3)},
                                  rounds=4)
        assert res.ledger.total_bytes == led.total_bytes
        if comm == "identity":
            assert led.total_bytes == flat.ledger.total_bytes
            torch.testing.assert_close(
                torch.cat([res.x["u"], res.x["v"]], 1), flat.x,
                rtol=1e-6, atol=1e-6)
        else:     # one 4-byte (zp, scale) header per leaf row
            assert led.total_bytes == flat.ledger.total_bytes + 4 * 4 * (
                4 + 3) + 4 * 4
        assert all(torch.isfinite(v).all() for v in res.metrics.values())


def test_persisted_channels_carry_across_rounds():
    prob = tp.quadratic_bilevel(N, D1, D2, seed=0, device="cpu")
    ring = LocalRing(N, device="cpu")
    spec = sharded_spec(alpha=0.05, beta=0.1, M=4, U=3, K=3, curvature=6.0,
                        comm="int8+ef", persist_ef=True)
    res = solve(prob, None, spec, mesh=ring)
    cs = res.channels
    assert [cs[c].sends for c in ("inner_y", "dihgp_h", "outer_x")] == \
        [12, 9, 3]
    assert cs["inner_y"].hat.abs().sum() > 0
    assert res.ledger.total_sends() == 24
    assert float(res.metrics["comm_sends"][-1]) == 24.0


# ---------------------------------------------------------------------------
# validation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("change,match", [
    (dict(schedule=ScheduleSpec(alpha=0.05, beta=0.1, gamma=3.0)),
     "gamma schedule"),
    (dict(comm=dataclasses.replace(sharded_spec().comm, persist_ef=True)),
     "identity wire has no error-feedback"),
    (dict(tier="reference", comm=dataclasses.replace(
        sharded_spec(comm="int8+ef").comm, persist_ef=True)),
     "sharded-tier knob"),
    (dict(faults=FaultSpec(drop_prob=0.1)), "reference-tier feature"),
    (dict(curvature=None), "curvature"),
    (dict(method="dgbo"), "only executes method='dagm'"),
    (dict(sharded=dataclasses.replace(sharded_spec().sharded,
                                      mix_every=0)), "mix_every"),
])
def test_validation_errors(change, match):
    prob = tp.quadratic_bilevel(N, D1, D2, device="cpu")
    spec = dataclasses.replace(sharded_spec(K=2), **change)
    with pytest.raises(ValueError, match=match):
        solve(prob, None, spec, mesh=LocalRing(N, device="cpu"))


def test_sharded_solve_refusals():
    prob = tp.quadratic_bilevel(N, D1, D2, device="cpu")
    spec = sharded_spec(K=1, curvature=6.0)
    ring = LocalRing(N, device="cpu")
    with pytest.raises(ValueError, match="mesh=LocalRing"):
        solve(prob, None, spec, device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve(prob, None, spec, mesh="data")
    with pytest.raises(ValueError, match="metrics_fn"):
        solve(prob, None, spec, mesh=ring, metrics_fn=lambda *a: {})
    with pytest.raises(ValueError, match="batch"):
        solve(None, None, spec, mesh=ring, g_fn=prob.g, f_fn=prob.f)
    with pytest.raises(ValueError, match="x0/y0"):
        solve(None, None, spec, mesh=ring, g_fn=prob.g, f_fn=prob.f,
              batch=prob.data)
    with pytest.raises(ValueError, match="agent axis"):
        solve(prob, None, spec, mesh=LocalRing(4, device="cpu"))
    with pytest.raises(TypeError, match="SolverSpec"):
        dagm_sharded.make_sharded_dagm(prob.g, prob.f, object(), ring)
