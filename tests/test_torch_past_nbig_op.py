"""The linear OP and the linear DC sweep past n = 128 on the CPU: a 127-stage
resistive ladder (np1 = 130, 100 Ω series, 1 kΩ and 1 nF shunts, a DC
source), 3 lanes with R spread log-normally by 0.1, through
``run_op_batch`` and ``run_dc_batch`` (engine "linear": one stamped solve
of every lane, of every lane and point for the sweep, the plain version
here), against the JAX package's MNA entries of the same systems
(``ops/assemble.assemble_entries``, mode "op", status gmin 0, the swept
source's dc set at each point) built densely with the ground row and
solved by its ``ops/solve.py::_solve_batched``: converged everywhere, x
within rtol 1e-9 of its scale."""

import numpy as np

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse
from toyspice_tpu.ops.assemble import assemble_entries as jax_entries
from toyspice_tpu.ops.solve import _solve_batched

import toyspice_tpu_torch as ts

from test_torch_run import RTOL

LANES = 3
POINTS = np.asarray([-2.0, 0.5, 3.0])


def r_ladder(stages):
    """A resistive ladder of ``stages`` sections from a DC source: np1 =
    stages + 3."""
    lines = [f"* {stages}-stage resistive ladder", ".op", "Vin 1 0 DC 1"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 100", f"Rs{k} {k + 1} 0 1k",
                  f"C{k} {k + 1} 0 1n"]
    return "\n".join(lines) + "\n"


def jax_dense_solve(cc, overrides):
    """x (B, np1) of the JAX package's OP systems of the lanes in
    ``overrides``: the stamp entries summed into dense matrices, row 0 the
    ground identity row, no gmin (status gmin 0), then _solve_batched."""
    params, axes = jax_batch_params(cc, overrides)
    s0 = jax_init_state(cc)
    rows, cols, _, rrows, _ = jax_entries(
        cc, jax.tree_util.tree_map(lambda v, a: v if a is None else v[0],
                                   params, axes), s0, {}, 0.0, 0.0, "op",
        0.0)
    vals, rvals = jax.jit(jax.vmap(
        lambda p: jax_entries(cc, p, s0, {}, 0.0, 0.0, "op", 0.0)[2::2],
        in_axes=(axes,)))(params)
    vals, rvals = np.asarray(vals), np.asarray(rvals)
    b, n = vals.shape[0], cc.np1
    a = np.zeros((b, n, n))
    np.add.at(a, (slice(None), rows, cols), vals)
    rhs = np.zeros((b, n))
    np.add.at(rhs, (slice(None), rrows), rvals)
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    rhs[:, 0] = 0.0
    return np.asarray(jax.jit(_solve_batched)(jnp.asarray(a),
                                              jnp.asarray(rhs)))


def assert_close(x, want):
    np.testing.assert_allclose(x, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_past_nbig_linear_op_and_dc_sweep_match_jax():
    deck = r_ladder(127)
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(4)
    r = np.asarray(cc.params["R"]["value"])[None] * np.exp(
        rng.normal(0.0, 0.1, (LANES, cc.params["R"]["value"].shape[0])))
    dc = np.asarray(cc.params["V"]["dc"])
    # the sweep's lanes: lane b at point p is row b * P + p, as the port's
    swept = np.repeat(dc[None], LANES * POINTS.size, axis=0)
    swept[:, 0] = np.tile(POINTS, LANES)
    want = jax_dense_solve(cc, {
        "R": {"value": np.concatenate([r, np.repeat(r, POINTS.size,
                                                    axis=0)])},
        "V": {"dc": np.concatenate([np.repeat(dc[None], LANES, axis=0),
                                    swept])}})

    pc = ts.compile_circuit(ts.parse(deck))
    assert pc.np1 == 130
    params, _ = ts.batch_params(pc, {"R": {"value": r}}, device="cpu")
    opr = ts.run_op_batch(pc, params)
    assert bool(opr.converged.all()) and opr.stage.tolist() == [0] * LANES
    assert_close(opr.x.numpy(), want[:LANES])
    xs, conv = ts.run_dc_batch(pc, (0,), params, None, POINTS)
    assert xs.shape == (LANES, POINTS.size, 130) and bool(conv.all())
    assert_close(xs.reshape(-1, 130).numpy(), want[LANES:])
    # node 1, the source's, at the last point
    assert float(np.abs(xs[:, -1, 1].numpy() - POINTS[-1]).max()) < 1e-12
