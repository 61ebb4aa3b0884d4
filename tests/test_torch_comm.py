"""The port's gossip compressors, error feedback and ledger on the CPU,
against `repro.comm` on the same numpy inputs.

Bitwise where the two compute the same thing: the quantizer's wire
metadata (`row_quant_params`), the counter-hash uniforms, bf16 and
top-k roundtrips, payload sizes and ledgers.  The stochastic
compressors draw their randomness from other generators than `repro`
(hash uniforms and a CPU torch.Generator instead of jax.random), so
there the port is held to the compressors' own contracts.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from repro.comm import parse_comm_spec as j_parse
from repro.comm import row_quant_params as j_row_quant_params
from repro.comm import static_ledger as j_static_ledger
from repro.kernels.mixing_matvec import _hash_uniform as j_hash_uniform
from repro.solve import CommSpec as JCommSpec
from repro.solve import SolverSpec as JSpec

from repro_torch.comm import (channel_init, channel_seeds,
                              compressed_payload, parse_comm_spec,
                              row_quant_params, send_seed, static_ledger)
from repro_torch.kernels.ref import hash_uniform, quantize
from repro_torch.solve import CommSpec, SolverSpec

SPECS = ["identity", "bf16", "int8", "int4", "int8+ef", "int4+ef",
         "top_k:0.1", "top_k:0.1+ef", "rand_k:0.25", "rand_k:0.25+ef"]


def _rows(shape, seed=0, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("scale", [1e-3, 1.0, 3.0, 250.0])
def test_row_quant_params_bitwise(bits, scale):
    x = _rows((16, 1000), seed=int(scale * 10), scale=scale)
    x[3] = 0.5                     # a constant row: span 0, scale 1
    x[5, :7] = -x[5, :7]
    zj, sj = j_row_quant_params(jnp.asarray(x), bits)
    zt, st = row_quant_params(torch.as_tensor(x), bits)
    assert zt.shape == st.shape == (16, 1) and zt.dtype == torch.float32
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


@pytest.mark.parametrize("seed", [0, 1, 13, 77, 123456789, 2 ** 31 - 2])
def test_hash_uniform_bitwise(seed):
    rows = jax.lax.broadcasted_iota(jnp.int32, (256, 512), 0)
    cols = jax.lax.broadcasted_iota(jnp.int32, (256, 512), 1)
    want = np.asarray(j_hash_uniform(jnp.int32(seed), rows, cols))
    got = hash_uniform(seed, torch.arange(256)[:, None],
                       torch.arange(512)[None, :])
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0.0 <= float(got.min()) and float(got.max()) < 1.0


@pytest.mark.parametrize("spec", SPECS)
@pytest.mark.parametrize("shape", [(64,), (65,), (8, 8), (2010,),
                                   (157000,)])
def test_payload_sizes_match_repro(spec, shape):
    got, want = parse_comm_spec(spec), j_parse(spec)
    assert got.compressor.payload_bytes(shape) \
        == want.compressor.payload_bytes(shape)
    assert got.compressor.payload_floats(shape) \
        == want.compressor.payload_floats(shape)
    assert (got.ef, got.stochastic, got.fusable, got.is_identity) \
        == (want.ef, want.stochastic, want.fusable, want.is_identity)


@pytest.mark.parametrize("spec", ["identity+ef", "int8+foo", "gzip",
                                  "top_k:1.5", "rand_k:0", "int16"])
def test_parse_comm_spec_refuses_what_repro_refuses(spec):
    with pytest.raises(ValueError):
        j_parse(spec)
    with pytest.raises(ValueError):
        parse_comm_spec(spec)


def test_rand_k_scaling_follows_error_feedback():
    assert parse_comm_spec("rand_k:0.25+ef").compressor.scale is False
    assert parse_comm_spec("rand_k:0.25").compressor.scale is True


@pytest.mark.parametrize("spec", SPECS)
def test_ledger_matches_repro_for_every_spec(spec):
    chans = [("inner_y", (2010,), 25), ("dihgp_h", (2010,), 15),
             ("outer_x", (157000,), 5)]
    got = static_ledger(spec, chans, name="dagm")
    want = j_static_ledger(spec, chans, name="dagm")
    assert got.total_bytes == want.total_bytes
    assert got.summary(rounds=5) == want.summary(rounds=5)
    kw = dict(K=5, M=5, U=3, dihgp="matrix_free")
    assert SolverSpec(comm=CommSpec(spec), **kw).comm_ledger(
        157000, 2010).summary() == JSpec(
        comm=JCommSpec(spec), **kw).comm_ledger(157000, 2010).summary()


def test_full_width_ledger_bytes():
    """The §6.2 widths (d1 = 157,000, d2 = 2,010) at K=5, M=5, U=3."""
    spec = dict(K=5, M=5, U=3, dihgp="matrix_free")
    totals = {c: SolverSpec(comm=CommSpec(c), **spec).comm_ledger(
        157000, 2010).total_bytes for c in ("identity", "int8", "int8+ef",
                                            "int4", "int4+ef")}
    assert totals == {"identity": 3461600, "int8": 865580,
                      "int8+ef": 865580, "int4": 432880,
                      "int4+ef": 432880}


@pytest.mark.parametrize("spec", ["bf16", "top_k:0.1"])
def test_deterministic_roundtrips_bitwise(spec):
    x = _rows((6, 3, 40), seed=2)
    want = j_parse(spec).compressor.roundtrip(jnp.asarray(x))
    got = parse_comm_spec(spec).compressor.roundtrip(torch.as_tensor(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("bits", [4, 8])
def test_stochastic_quant_roundtrip_is_the_kernel_quantizer(bits):
    """The compressor draws the kernels' hash uniforms: its decode is
    `quantize` with `row_quant_params` and `hash_uniform(seed, r, c)`,
    every decoded value lies on its row's zp + k·scale grid, and within
    one level of x."""
    x = torch.as_tensor(_rows((5, 300), seed=3, scale=2.0))
    comp = parse_comm_spec(f"int{bits}").compressor
    dec = comp.roundtrip(x, 41)
    zp, sc = row_quant_params(x, bits)
    u = hash_uniform(41, torch.arange(5)[:, None],
                     torch.arange(300)[None, :])
    assert torch.equal(dec, quantize(x, zp, sc, u, 2.0 ** bits - 1))
    k = (dec - zp) / sc
    assert float((k - k.round()).abs().max()) < 1e-3
    assert float((dec - x).abs().max()) <= float(sc.max()) + 1e-6
    assert not torch.equal(dec, comp.roundtrip(x, 42))


def test_rand_k_keeps_k_coordinates_per_row_on_a_cpu_stream():
    x = torch.as_tensor(_rows((4, 40), seed=4))
    comp = parse_comm_spec("rand_k:0.25").compressor
    dec = comp.roundtrip(x, 9)
    assert ((dec != 0).sum(1) == 10).all()
    kept = dec != 0
    torch.testing.assert_close(dec[kept], 4.0 * x[kept])
    assert torch.equal(dec, comp.roundtrip(x, 9))
    unscaled = parse_comm_spec("rand_k:0.25+ef").compressor.roundtrip(x, 9)
    assert torch.equal(unscaled[kept], x[kept])


@pytest.mark.parametrize("spec", ["int8+ef", "top_k:0.2+ef"])
def test_ef_payload_is_hat_plus_compressed_innovation(spec):
    """CHOCO: payload = hat + C(x − hat), hat ← payload, one send; the
    replica converges to a static state (contraction)."""
    policy = parse_comm_spec(spec)
    x = torch.as_tensor(_rows((6, 128), seed=5))
    st = channel_init(policy, "x", x, seed=3)
    assert torch.equal(st.hat, torch.zeros_like(x)) and st.sends == 0
    pay, st1 = compressed_payload(policy, x, st)
    want = st.hat + policy.compressor.roundtrip(
        x - st.hat, send_seed(3, 0))
    assert torch.equal(pay, want) and torch.equal(st1.hat, pay)
    assert st1.sends == 1 and st1.seed == 3
    errs = []
    for _ in range(40):
        _, st1 = compressed_payload(policy, x, st1)
        errs.append(float((x - st1.hat).norm()))
    assert errs[-1] < 1e-2 * errs[0]
    assert st1.reset_hat().sends == st1.sends
    assert torch.equal(st1.reset_hat().hat, torch.zeros_like(x))


def test_identity_and_non_ef_channels_keep_no_replica():
    x = torch.ones(3, 4)
    for spec in ("identity", "int8", "bf16"):
        policy = parse_comm_spec(spec)
        st = channel_init(policy, "c", x)
        pay, st = compressed_payload(policy, x, st)
        assert st.hat is None and st.sends == 1
    assert torch.equal(compressed_payload(parse_comm_spec("identity"), x,
                                          st)[0], x)


def test_seed_streams_are_host_integers():
    """Channel and send seeds are plain Python ints in [0, 2³¹ − 1):
    distinct per channel and per send, repeatable, and needing no
    device."""
    seeds = channel_seeds(0, ["inner_y", "dihgp_h", "outer_x"])
    assert len(set(seeds.values())) == 3
    assert seeds == channel_seeds(0, ["inner_y", "dihgp_h", "outer_x"])
    assert seeds != channel_seeds(1, ["inner_y", "dihgp_h", "outer_x"])
    draws = [send_seed(seeds["inner_y"], s) for s in range(1000)]
    assert all(isinstance(s, int) and 0 <= s < 2 ** 31 - 1 for s in draws)
    assert len(set(draws)) == 1000


@pytest.mark.parametrize("data_seed,bits", [(202, 8), (202, 4), (0, 8),
                                            (7, 4), (31, 8)])
def test_quantizer_unbiased_above_zp_and_biased_by_zp_below(data_seed,
                                                             bits):
    """Over 400 seeds the decoded mean matches x within the Monte-Carlo
    bound (4 standard errors, each ≤ scale/(2·√400)) wherever x ≥ zp.
    The row minimum can lie below zp, because zp = min rounded to the
    nearest bf16: there the code clips at 0, the decode is exactly zp,
    and the bias is zp − x, at most half a bf16 ulp of |min|.  This is
    `repro`'s quantizer too (bitwise metadata), and the cause of its
    `test_in_kernel_quantizer_unbiased` failure at data_seed=202, bits=8
    (x = −8.7711, zp = −8.75)."""
    x_j = 3.0 * jax.random.normal(jax.random.PRNGKey(data_seed), (4, 64),
                                  jnp.float32)
    x = torch.as_tensor(np.array(x_j))
    zp, scale = row_quant_params(x, bits)
    rows, cols = torch.arange(4)[:, None], torch.arange(64)[None, :]
    levels = float(2 ** bits - 1)
    mean = torch.stack([
        quantize(x, zp, scale, hash_uniform(s, rows, cols), levels)
        for s in range(3, 3 + 7919 * 400, 7919)]).mean(0)
    above = x >= zp
    tol = (scale * 4.0 / (2.0 * np.sqrt(400))).expand_as(x)
    assert bool(((mean - x).abs() <= tol + 1e-6)[above].all())
    below = ~above
    assert torch.equal(mean[below], zp.expand_as(x)[below])
    m = x.amin(1, keepdim=True)
    half_ulp = 2.0 ** (torch.floor(torch.log2(m.abs())) - 8)
    assert bool(((zp - m) <= half_ulp).all())
    if data_seed == 202 and bits == 8:
        i, j = divmod(int(torch.argmax((mean - x).abs())), 64)
        assert bool(below[i, j])
        assert abs(float(x[i, j]) + 8.7711) < 1e-4
        assert float(zp[i, 0]) == -8.75
        assert abs(float(mean[i, j] - x[i, j]) - 0.0211) < 1e-4


def test_exact_dihgp_refuses_compression():
    from repro_torch.solve.spec import validate_spec
    with pytest.raises(ValueError, match="no gossip to compress"):
        validate_spec(SolverSpec(dihgp="exact", comm=CommSpec("int8")))
    with pytest.raises(ValueError, match="unknown compressor"):
        validate_spec(SolverSpec(comm=CommSpec("int3")))
    validate_spec(dataclasses.replace(SolverSpec(),
                                      comm=CommSpec("top_k:0.1+ef")))
