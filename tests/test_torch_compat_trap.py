"""Compat semantics with ``integration="trap"`` in the port's OP, DC sweep
and AC on the CPU, against the JAX package's same calls.

The JAX package refuses trap under compat in the transient only
(ops/pallas_tran.py, engine/tran.py: compat reproduces the reference's
backward Euler); its ``run_op_batch``, ``run_dc_batch`` and
``run_ac_batch`` take the deck, and ``ops/assemble.py`` stamps backward
Euler under compat whatever ``integration`` says.  The port serves these
analyses the same way: the OP kernel, the DC sweep kernel and the AC
kernel through their compat instantiations (plain versions here), the
linear OP and the linear sweep through ``ops/assemble.py``.

Decks: the half-wave rectifier (OP and DC: the OP kernel's and the DC
sweep kernel's path) and ce_amplifier_ac.cir (AC), both nonlinear; the
resistive divider (OP and DC) and an inline RC low-pass (AC), both linear.
Lanes spread R (and C) from ``numpy.random.default_rng``.  The bar:
``converged``/``stage``/``conv`` equal, x, xs, xr and xi within rtol 1e-9
(compat/trap is compat/BE here, so the port also equals its own BE
call), and the transient still refuses compat/trap as the JAX package
does."""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine import batch as jax_batch
from toyspice_tpu.engine.ac import frequency_points as jax_frequency_points
from toyspice_tpu.engine.dc import sweep_values as jax_sweep_values
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 3
RTOL = 1e-9
TRAP = {"integration": "trap"}
# the JAX package's words for the transient's refusal (ops/pallas_tran.py)
REFUSAL = ("requires semantics='physics' (compat reproduces the "
           "reference's backward Euler)")


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


RC_AC = """* RC low-pass
.ac DEC 5 10 100k
Vin in 0 AC 1
R1 in out 1k
C1 out 0 100n
Rl out 0 10k
"""

RECTIFIER = _deck("half_wave_rectifier.cir")
DIVIDER = _deck("divider_op.cir")
CE_AC = _deck("ce_amplifier_ac.cir")


def _overrides(cc, seed):
    rng = np.random.default_rng(seed)
    return {kind: {"value": np.asarray(cc.params[kind]["value"])[None]
                   * np.exp(rng.normal(0, 0.1, (
                       LANES, len(cc.params[kind]["value"]))))}
            for kind in ("R", "C") if kind in cc.params}


def _both(deck, seed):
    """(JAX cc, params, axes; the port's cc and params) on the same
    numpy lanes."""
    jcc = jax_compile(jax_parse(deck))
    params, axes = jax_batch.batch_params(jcc, _overrides(jcc, seed))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    cc = ts.compile_circuit(ts.parse(deck))
    return jcc, params, axes, cc, params_from_numpy(params_np, device="cpu")


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=RTOL * max(np.abs(want).max(), 1e-12))


@pytest.mark.parametrize("deck,engine", [(RECTIFIER, "fused"),
                                         (DIVIDER, "linear")],
                         ids=["rectifier", "divider"])
def test_op_compat_trap_matches_jax(deck, engine):
    jcc, params, axes, cc, tparams = _both(deck, 0)
    want = jax_batch.run_op_batch(jcc, params, axes,
                                  opts=JaxOptions(**TRAP))
    assert select_op_engine(cc, "compat", ts.SimOptions(**TRAP))[0] == engine
    got = ts.run_op_batch(cc, tparams, opts=ts.SimOptions(**TRAP))
    np.testing.assert_array_equal(got.converged.numpy(),
                                  np.asarray(want.converged))
    np.testing.assert_array_equal(got.stage.numpy(), np.asarray(want.stage))
    assert bool(got.converged.all())
    _close(got.x.numpy(), want.x)
    be = ts.run_op_batch(cc, tparams)
    np.testing.assert_array_equal(got.x.numpy(), be.x.numpy())


@pytest.mark.parametrize("deck,points", [
    (RECTIFIER, jax_sweep_values(-2.0, 2.0, 0.5)),
    (DIVIDER, jax_sweep_values(0.0, 12.0, 3.0))],
    ids=["rectifier", "divider"])
def test_dc_compat_trap_matches_jax(deck, points):
    jcc, params, axes, cc, tparams = _both(deck, 1)
    xs_ref, conv_ref = jax_batch.run_dc_batch(
        jcc, (0,), params, axes, jnp.asarray(points),
        opts=JaxOptions(**TRAP))
    xs, conv = ts.run_dc_batch(cc, (0,), tparams, None, points,
                               opts=ts.SimOptions(**TRAP))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    _close(xs.numpy(), xs_ref)
    xs_be, _ = ts.run_dc_batch(cc, (0,), tparams, None, points)
    np.testing.assert_array_equal(xs.numpy(), xs_be.numpy())


@pytest.mark.parametrize("deck", [CE_AC, RC_AC], ids=["ce_amplifier", "rc"])
def test_ac_compat_trap_matches_jax(deck):
    jcc, params, axes, cc, tparams = _both(deck, 2)
    ap = jcc.netlist.ac
    freqs = jax_frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    xr_ref, xi_ref, opr = jax_batch.run_ac_batch(
        jcc, params, axes, jnp.asarray(freqs), opts=JaxOptions(**TRAP))
    xr, xi, out = ts.run_ac_batch(cc, tparams, None, freqs,
                                  opts=ts.SimOptions(**TRAP))
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(opr.converged))
    assert bool(out.converged.all())
    _close(xr.numpy(), xr_ref)
    _close(xi.numpy(), xi_ref)
    xr_be, xi_be, _ = ts.run_ac_batch(cc, tparams, None, freqs)
    np.testing.assert_array_equal(xr.numpy(), xr_be.numpy())
    np.testing.assert_array_equal(xi.numpy(), xi_be.numpy())


def test_transient_still_refuses_compat_trap():
    jcc = jax_compile(jax_parse(RECTIFIER))
    tp = jcc.netlist.tran
    jcfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    with pytest.raises(ValueError) as jax_err:
        jax_batch.make_tran_batch(jcc, jcfg, None, opts=JaxOptions(**TRAP))
    assert REFUSAL in str(jax_err.value)
    cc = ts.compile_circuit(ts.parse(RECTIFIER))
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    with pytest.raises(NotImplementedError, match="no transient engine") as e:
        ts.make_tran_batch(cc, cfg, None, opts=ts.SimOptions(**TRAP))
    assert REFUSAL in str(e.value)
