"""A 12-cell version of chip_smoke.py phase 38's PV module (``pv_module``
of tests/test_torch_past_caps.py: a photocurrent, a diode and a shunt a
cell, a bypass diode across every 4 cells; 13 sources, np1 = 15), 3 lanes
with the photocurrents spread log-normally by 0.1 from numpy seed 0: its
OP through ``run_op_batch`` (engine "fused": the OP kernel's plain version
on the CPU) against the JAX package's general OP, and its I-V sweep
through ``run_dc_batch`` (the DC sweep kernel's plain version) against the
JAX package's general sweep, at the standing bar (converged and stage
equal, x and jv within rtol 1e-9).

Then the one lane of chip_smoke.py phase 38's 72-cell module at 8192
lanes (R then the photocurrents spread log-normally by 0.1 from numpy seed
0, ``pv_spread``) whose sweep has a point that does not converge: lane
6232 at 18 V, the 37th point, where the JAX package's general sweep does
not converge either.  Its sweep to that point is held to the JAX
package's, the converged flags equal and every point's x within rtol
1e-9."""

import numpy as np

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine

from test_torch_past_caps import pv_module

LANES = 3
RTOL = 1e-9
DECK = pv_module(12, 4, ".dc VLOAD 0 10 0.5")
# phase 38's lane with a point that does not converge, of its 8192, and
# that point (0.5 V apart from 0 V)
PV72_LANE, PV72_POINT = 6232, 36


def photocurrents(cc, lanes=LANES, seed=0, rng=None):
    """Each cell's photocurrent (the I sources' dc) spread log-normally by
    0.1, (lanes, nI), drawn from ``rng`` or numpy seed ``seed``."""
    dc = np.asarray(cc.params["I"]["dc"])
    rng = np.random.default_rng(seed) if rng is None else rng
    return {"I": {"dc": dc[None] * np.exp(rng.normal(0, 0.1,
                                                     (lanes, len(dc))))}}


def test_pv12_op_runs_on_the_op_kernel_and_matches_jax():
    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.netlist.parser import parse as jax_parse

    from test_torch_op import assert_matches, reference

    params_np, ref = reference(DECK, photocurrents(jax_compile(jax_parse(
        DECK))))
    cc = ts.compile_circuit(ts.parse(DECK))
    assert select_op_engine(cc)[0] == "fused"
    out = ts.run_op_batch(cc, params_from_numpy(params_np, device="cpu"))
    assert_matches(out, ref)
    assert bool(out.converged.all())


def _jax_sweep(jcc, overrides, pts):
    """The JAX package's general sweep of the first source: (params as
    numpy, xs, converged)."""
    import jax
    import jax.numpy as jnp

    from toyspice_tpu.engine.batch import batch_params as jax_batch_params
    from toyspice_tpu.engine.dc import make_dc as jax_make_dc
    from toyspice_tpu.engine.state import init_state as jax_init_state

    params, axes = jax_batch_params(jcc, overrides)
    s0 = jax_init_state(jcc)
    xs, conv = jax.jit(jax.vmap(
        lambda p: jax_make_dc(jcc, (0,))(p, s0, jnp.asarray(pts)),
        in_axes=(axes,)))(params)
    return ({k: {kk: np.asarray(v) for kk, v in t.items()}
             for k, t in params.items()}, np.asarray(xs), np.asarray(conv))


def test_pv12_sweep_runs_on_the_dc_kernel_and_matches_jax():
    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.netlist.parser import parse as jax_parse

    jcc = jax_compile(jax_parse(DECK))
    pts = np.arange(0.0, 10.25, 0.5)
    params_np, want, conv_ref = _jax_sweep(jcc, photocurrents(jcc), pts)
    cc = ts.compile_circuit(ts.parse(DECK))
    assert cc.np1 == 15 and select_op_engine(cc)[0] == "fused"
    xs, conv = ts.run_dc_batch(cc, (0,), params_from_numpy(
        params_np, device="cpu"), None, pts)
    np.testing.assert_array_equal(conv.numpy(), conv_ref)
    assert bool(conv.all())
    np.testing.assert_allclose(xs.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_pv72_lane_whose_point_does_not_converge_matches_jax():
    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.netlist.parser import parse as jax_parse

    deck = pv_module(72)
    jcc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(0)
    r = np.asarray(jcc.params["R"]["value"])
    ov = {"R": {"value": r[None] * np.exp(rng.normal(0, 0.1,
                                                     (8192, len(r))))}}
    ov.update(photocurrents(jcc, 8192, rng=rng))
    ov = {k: {kk: v[[PV72_LANE]] for kk, v in t.items()}
          for k, t in ov.items()}
    pts = np.arange(PV72_POINT + 1) * 0.5
    params_np, want, conv_ref = _jax_sweep(jcc, ov, pts)
    cc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(cc)[0] == "fused"
    xs, conv = ts.run_dc_batch(cc, (0,), params_from_numpy(
        params_np, device="cpu"), None, pts)
    np.testing.assert_array_equal(conv.numpy(), conv_ref)
    assert conv_ref[0, :-1].all() and not conv_ref[0, -1]
    np.testing.assert_allclose(xs.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
