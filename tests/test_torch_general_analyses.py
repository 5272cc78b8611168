"""The port's general engine OP, DC sweep and AC on the CPU, called
directly (``engine/op.make_op``, ``engine/dc.make_dc``,
``engine/ac.make_ac``), against the JAX package's general engine on the
same numpy inputs:

* the OP (plain NR from the linear-devices-only estimate, the gmin ladder,
  source stepping): the 3-stage Cockcroft-Walton multiplier, the CE
  amplifier's bias and the diode stack HARD_V with V1 drawn per lane, so
  that lanes end at stages 0 and 2; converged and stage equal per lane, x
  and jv within rtol 1e-9;
* the DC sweep of the multiplier's Vin (each point warm-started from the
  last, the DC convergence test): conv equal per point, xs within rtol
  1e-9;
* the general AC (the general OP's bias, the dense (2np1, 2np1) system of
  every lane and frequency, one dense solve) on ce_amplifier_ac.cir and a
  4-section LC ladder, held to the JAX package's make_ac_batch, which on
  the CPU takes its general branch (assemble_system_ac at each frequency):
  xr and xi within rtol 1e-9 of their scale."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.ac import frequency_points as jax_frequency_points
from toyspice_tpu.engine.ac import make_ac_batch as jax_make_ac_batch
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.dc import make_dc as jax_make_dc
from toyspice_tpu.engine.dc import sweep_values as jax_sweep_values
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.ac import make_ac
from toyspice_tpu_torch.engine.dc import make_dc
from toyspice_tpu_torch.engine.op import make_op

from test_torch_general import _deck, cockcroft_walton
from test_torch_op import (HARD_V, RTOL, assert_matches, r_spread,
                           reference, v1_draw)

LANES = 4


def c_spread(cc, b, rng):
    c = np.asarray(cc.params["C"]["value"])
    return {"C": {"value": c[None] * np.exp(rng.normal(0, 0.1,
                                                       (b, len(c))))}}


def lc_ladder(sections):
    """A doubly terminated 50 Ω LC low-pass of ``sections`` sections."""
    lines = [f"* {sections}-section 50 ohm LC ladder low-pass",
             ".ac dec 21 10k 100meg", "Vin in 0 AC 1 0", "Rs in n0 50"]
    for k in range(1, sections + 1):
        lines += [f"L{k} n{k - 1} n{k} 1u", f"C{k} n{k} 0 400p"]
    lines += [f"Rl n{sections} 0 50", ""]
    return "\n".join(lines)


CW3 = cockcroft_walton(3, "0.2m")


def port_tree(params_np):
    return params_from_numpy(params_np, device="cpu")


@pytest.mark.parametrize("deck,draw", [
    (CW3, c_spread), (_deck("ce_amplifier_op.cir"), r_spread),
    (HARD_V, v1_draw)], ids=["cw3", "ce_amplifier_bjt", "hard_v"])
def test_general_op_matches_jax(deck, draw):
    cc = jax_compile(jax_parse(deck))
    params_np, ref = reference(deck, draw(cc, 6 if deck is HARD_V
                                          else LANES,
                                          np.random.default_rng(0)))
    pc = ts.compile_circuit(ts.parse(deck))
    out = make_op(pc)(port_tree(params_np), ts.init_state(pc, device="cpu"))
    assert_matches(out, ref)
    assert bool(out.converged.all())
    if deck is HARD_V:
        assert out.stage.tolist() == [2, 0, 0, 0, 2, 2]


def test_general_dc_sweep_matches_jax():
    deck = CW3
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, c_spread(cc, LANES,
                                                 np.random.default_rng(1)))
    pts = np.asarray(jax_sweep_values(-5.0, 5.0, 0.5))
    slot = (cc.names["V"].index("Vin"),)
    s0 = jax_init_state(cc)
    xs_ref, conv_ref = jax.jit(jax.vmap(
        lambda p: jax_make_dc(cc, slot)(p, s0, jnp.asarray(pts)),
        in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pc = ts.compile_circuit(ts.parse(deck))
    xs, conv = make_dc(pc, slot)(port_tree(params_np),
                                 ts.init_state(pc, device="cpu"), pts)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    want = np.asarray(xs_ref)
    np.testing.assert_allclose(xs.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("deck,kind", [(_deck("ce_amplifier_ac.cir"), "R"),
                                       (lc_ladder(4), "C")],
                         ids=["ce_amplifier_ac", "lc_ladder4"])
def test_general_ac_matches_jax(deck, kind):
    cc = jax_compile(jax_parse(deck))
    ap = cc.netlist.ac
    freqs = jax_frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    rng = np.random.default_rng(2)
    base = np.asarray(cc.params[kind]["value"])[None, :]
    params, axes = jax_batch_params(cc, {kind: {"value": base * np.exp(
        rng.normal(0, 0.1, (LANES, base.shape[1])))}})
    xr_ref, xi_ref, opr = jax.jit(jax_make_ac_batch(cc, axes))(
        params, jax_init_state(cc), jnp.asarray(freqs))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pc = ts.compile_circuit(ts.parse(deck))
    xr, xi, out = make_ac(pc)(port_tree(params_np),
                              ts.init_state(pc, device="cpu"), freqs)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(opr.converged))
    xr_ref, xi_ref = np.asarray(xr_ref), np.asarray(xi_ref)
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max())
    np.testing.assert_allclose(xr.numpy(), xr_ref, rtol=RTOL,
                               atol=RTOL * scale)
    np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=RTOL,
                               atol=RTOL * scale)
    assert float(np.abs(xi_ref).max()) > 0
