"""The port's batched OP of a linear deck on the CPU (engine/op.make_op:
one plain-version solve of csrc/stamped_solve.cu, which is what the
reference's rescue ladder gives on a linear deck) against the JAX package's general engine (engine/op.py ``make_op``,
vmapped), on divider_op.cir with R spread per lane and on a deck whose
node 3 is fed by a current source alone on the lanes where its resistor
is open, a singular system that the JAX package takes through the whole
ladder.

``converged`` and ``stage`` must be equal per lane, x within rtol 1e-9,
atol 1e-12 on the lanes that converge (both sides f64); a lane that does
not converge has a non-finite x on both sides.  Inputs are made with
numpy from a seed and handed to both packages."""

import os

import numpy as np
import pytest
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.op import make_op as jax_make_op
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.engine.newton import make_nr
from toyspice_tpu_torch.engine.op import make_op
from toyspice_tpu_torch.engine.options import SimOptions
from toyspice_tpu_torch.ops import solve_stamped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# node 3 hangs on I1 and R3 only: R3 = inf leaves it a zero row
OPEN_NODE = """* current source into a resistor that may be open
.op
V1 1 0 DC 5
R1 1 2 1k
R2 2 0 2k
L1 2 4 1m
C1 4 0 1u
I1 0 3 DC 1m
R3 3 0 1k
"""


def reference(deck, overrides):
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, overrides)
    op_g, _ = jax_make_op(cc)
    s0 = jax_init_state(cc)
    ref = jax.jit(jax.vmap(lambda p: op_g(p, s0), in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return params_np, ref


def port_op(deck, params_np):
    cc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(cc)[0] == "linear"
    return ts.run_op_batch(cc, params_from_numpy(params_np, device="cpu"))


def assert_matches(out, ref):
    conv = np.asarray(ref.converged)
    np.testing.assert_array_equal(out.converged.numpy(), conv)
    np.testing.assert_array_equal(out.stage.numpy(), np.asarray(ref.stage))
    x, want = out.x.numpy(), np.asarray(ref.x)
    assert x.shape == want.shape
    np.testing.assert_allclose(x[conv], want[conv], rtol=RTOL, atol=ATOL)
    assert not np.isfinite(x[~conv]).all(axis=1).any()
    assert not np.isfinite(want[~conv]).all(axis=1).any()
    assert out.jv == {}


def r_spread(cc, b, rng):
    r = np.asarray(cc.params["R"]["value"])
    return {"R": {"value": r[None] * np.exp(rng.normal(0, 0.1,
                                                       (b, len(r))))}}


def test_divider_matches_general_engine():
    deck = _deck("divider_op.cir")
    cc = jax_compile(jax_parse(deck))
    params_np, ref = reference(deck, r_spread(cc, 4,
                                              np.random.default_rng(5)))
    out = port_op(deck, params_np)
    assert_matches(out, ref)
    assert out.converged.tolist() == [True] * 4
    assert out.stage.tolist() == [0] * 4
    # the divider: V(mid) = 12·Rb/(Ra + Rb) per lane
    r = params_np["R"]["value"]
    np.testing.assert_allclose(out.x[:, 2].numpy(),
                               12.0 * r[:, 1] / (r[:, 0] + r[:, 1]),
                               rtol=1e-12)


def test_singular_lanes_take_the_whole_ladder():
    cc = jax_compile(jax_parse(OPEN_NODE))
    r = np.asarray(cc.params["R"]["value"])
    rv = np.repeat(r[None], 4, axis=0) * np.exp(
        np.random.default_rng(9).normal(0, 0.1, (4, len(r))))
    rv[1, 2] = np.inf
    rv[3, 2] = np.inf
    params_np, ref = reference(OPEN_NODE, {"R": {"value": rv}})
    out = port_op(OPEN_NODE, params_np)
    assert_matches(out, ref)
    assert out.converged.tolist() == [True, False, True, False]
    assert out.stage.tolist() == [0, 2, 0, 2]


def test_rungs_launch_once_each_on_every_lane():
    """One solve of every lane, singular lanes included: the reference's
    ladder ends with polishes that solve plain NR's system again (the gmin
    rungs, which gmin on the diagonal makes solvable, and the source steps
    do not reach a linear lane's result), so the port runs no rung."""
    cc = ts.compile_circuit(ts.parse(OPEN_NODE))
    params, _ = ts.batch_params(
        cc, {"R": {"value": np.array([[1e3, 2e3, np.inf]] * 2)}},
        device="cpu")
    calls = []

    def counting(pat, vals, rvals, gmin):
        calls.append(vals.shape[0])
        return solve_stamped.solve_plain(pat, vals, rvals, gmin)

    out = make_op(cc, solve=counting)(params, ts.init_state(cc,
                                                            device="cpu"))
    assert calls == [2]
    assert out.stage.tolist() == [2, 2]


def test_gmin_floor_and_status_gmin_reach_the_stamps():
    """The capacitor leaks max(status gmin, floor), and the status gmin
    goes onto the diagonals too (node 4 hangs on C1 and R2): held to the
    JAX package's assemble_system and load_gmin, solved densely."""
    from toyspice_tpu.engine.options import SimOptions as JaxOptions
    from toyspice_tpu.ops.assemble import assemble_system, load_gmin

    deck = """* capacitor-only node
.op
V1 1 0 DC 2
R1 1 2 1k
C1 2 4 1u
R2 4 3 1k
I1 0 3 DC 1u
"""
    jcc = jax_compile(jax_parse(deck))
    jparams, _ = jax_batch_params(jcc, {})
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, {}, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    got = []
    for floor, gmin in ((1e-12, 0.0), (1e-9, 0.0), (1e-12, 1e-6)):
        a, b = assemble_system(jcc, jparams, jax_init_state(jcc), None, 0.0,
                               0.0, "op", gmin, gmin_floor=floor)
        want = np.linalg.solve(np.asarray(load_gmin(a, gmin)), np.asarray(b))
        assert JaxOptions(gmin=floor).gmin == SimOptions(gmin=floor).gmin
        nr = make_nr(cc, "op", False, opts=SimOptions(gmin=floor))
        r = nr(params, state0, {}, None, 0.0, 0.0, gmin, 1.0)
        np.testing.assert_allclose(r.x[0].numpy(), want, rtol=1e-9,
                                   atol=1e-15)
        assert r.converged.tolist() == [True]
        got.append(r.x[0, 4].item())
    assert len(set(got)) == 3  # each setting moves node 4


def test_cpu_tensors_take_the_plain_version():
    cc = ts.compile_circuit(ts.parse(_deck("divider_op.cir")))
    params, _ = ts.batch_params(cc, {}, device="cpu")
    before = solve_stamped.launch_stamped.launches
    out = ts.run_op_batch(cc, params)
    assert solve_stamped.launch_stamped.launches == before
    assert out.converged.tolist() == [True]
    pat = solve_stamped.StampPattern(2, np.array([1]), np.array([1]),
                                     np.array([1]))
    one = torch.ones((1, 1), dtype=torch.float64)
    with pytest.raises(ValueError, match="CUDA"):
        solve_stamped.launch_stamped(pat, one, one, one[0])
