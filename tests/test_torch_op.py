"""The port's batched operating point on the CPU (ops/op.py: the plain
version of csrc/op_kernel.cu under ``make_op_fused``'s rescue ladders)
against the JAX package's general engine (engine/op.py ``make_op``,
vmapped), on a BJT bias deck, a diode divider, a MOSFET bias deck and the
diode stacks that only source stepping rescues (HARD_V) or nothing rescues
(HARD_I).

``converged`` and ``stage`` must be equal per lane, x and the junction
voltages within rtol 1e-9, atol 1e-12 (both sides f64; they differ only
where XLA and PyTorch round differently).  Inputs are made with numpy from
a seed and handed to both packages."""

import os

import numpy as np
import pytest
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.op import make_op
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.engine.op import GMIN_STEPS, SOURCE_FACTORS
from toyspice_tpu_torch.engine.options import DEFAULTS, SimOptions
from toyspice_tpu_torch.ops import op, run_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# tests/test_fused_op.py's bias decks and tests/test_rescue.py's stacks
D_DIV = """* diode divider
.op
Vin 1 0 DC 2
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2)
"""

M_BIAS = """* MOSFET bias
.op
VDD 1 0 DC 5
VG 2 0 DC 2
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01)
"""

HARD_V = """diode stack
.op
V1 1 0 DC 100
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-15 N=1.0)
"""

HARD_I = """i-driven stack
.op
I1 0 1 DC 1
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-18 N=0.7)
"""


def r_spread(cc, b, rng):
    r = np.asarray(cc.params["R"]["value"])
    return {"R": {"value": r[None] * np.exp(rng.normal(0, 0.1,
                                                       (b, len(r))))}}


def v1_draw(cc, b, rng):
    return {"V": {"dc": rng.uniform(2.0, 100.0, (b, 1))}}


def i_batch(cc, b, rng):
    return {"I": {"dc": np.ones((b, 1))}}


def reference(deck, overrides):
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, overrides)
    op_g, _ = make_op(cc)
    s0 = jax_init_state(cc)
    ref = jax.jit(jax.vmap(lambda p: op_g(p, s0), in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return params_np, ref


def port_op(deck, params_np):
    cc = ts.compile_circuit(ts.parse(deck))
    return ts.run_op_batch(cc, params_from_numpy(params_np, device="cpu"))


def assert_matches(out, ref):
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.stage.numpy(), np.asarray(ref.stage))
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)
    assert set(out.jv) == set(ref.jv)
    for kind in ref.jv:
        for key in ref.jv[kind]:
            np.testing.assert_allclose(
                out.jv[kind][key].numpy(), np.asarray(ref.jv[kind][key]),
                rtol=RTOL, atol=ATOL, err_msg=f"jv.{kind}.{key}")


@pytest.mark.parametrize("deck,draw,lanes", [
    (_deck("ce_amplifier_op.cir"), r_spread, 4),
    (D_DIV, r_spread, 4),
    (M_BIAS, r_spread, 4),
], ids=["ce_amplifier_bjt", "diode_divider", "mosfet_bias"])
def test_plain_op_matches_general_engine(deck, draw, lanes):
    cc = jax_compile(jax_parse(deck))
    params_np, ref = reference(deck, draw(cc, lanes,
                                          np.random.default_rng(7)))
    out = port_op(deck, params_np)
    assert_matches(out, ref)
    assert bool(out.converged.all())


def test_rescue_stages_match_general_engine():
    """V1 drawn per lane: low drives converge plainly (stage 0), high ones
    need the gmin ladder to fail first and source stepping to win
    (stage 2)."""
    cc = jax_compile(jax_parse(HARD_V))
    params_np, ref = reference(HARD_V, v1_draw(cc, 6,
                                               np.random.default_rng(0)))
    out = port_op(HARD_V, params_np)
    assert_matches(out, ref)
    assert out.stage.tolist() == [2, 0, 0, 0, 2, 2]
    assert bool(out.converged.all())
    assert bool((out.iters_all >= out.iters).all())


def test_current_driven_stack_ends_unconverged():
    cc = jax_compile(jax_parse(HARD_I))
    params_np, ref = reference(HARD_I, i_batch(cc, 2, None))
    out = port_op(HARD_I, params_np)
    assert_matches(out, ref)
    assert out.converged.tolist() == [False, False]
    assert out.stage.tolist() == [2, 2]


def test_constants_match_the_reference():
    from toyspice_tpu.engine import op as jop

    assert SOURCE_FACTORS == jop.SOURCE_FACTORS
    assert SOURCE_FACTORS[-1] == 0.9999999999999999
    assert len(SOURCE_FACTORS) == 10
    assert GMIN_STEPS == jop.GMIN_STEPS == 10


def test_engine_selection_and_reasons():
    cc = ts.compile_circuit(ts.parse(_deck("ce_amplifier_op.cir")))
    assert select_op_engine(cc) == ("fused", "OP kernel eligible (compat)")
    # a linear deck takes the stamped solve (tests/test_torch_op_linear.py)
    lin = ts.compile_circuit(ts.parse(_deck("divider_op.cir")))
    assert select_op_engine(lin)[0] == "linear"
    assert "linear circuit" in op.op_fused_ineligible_reason(lin)
    # a magnetic deck's OP stamps each winding's +1e-3 branch diagonal
    # (tests/test_torch_physics_magnetic_op.py)
    mag = ts.compile_circuit(ts.parse(_deck("saturating_transformer.cir")))
    assert select_op_engine(mag)[0] == "linear"
    # physics is served (tests/test_torch_physics_op.py); trap under
    # compat takes compat's engines, as the JAX package's OP takes the deck
    # and stamps BE (tests/test_torch_compat_trap.py); a semantics the
    # port does not run is refused
    trap = SimOptions(integration="trap")
    for text, engine in ((_deck("divider_op.cir"), "linear"),
                         (_deck("ce_amplifier_op.cir"), "fused"),
                         (_deck("saturating_transformer.cir"), "linear")):
        cc = ts.compile_circuit(ts.parse(text))
        assert select_op_engine(cc, opts=trap)[0] == engine
        with pytest.raises(NotImplementedError, match="no OP engine") as e:
            select_op_engine(cc, "bogus")
        assert "semantics='bogus'" in str(e.value)
        with pytest.raises(NotImplementedError, match="semantics='bogus'"):
            ts.run_op_batch(cc, ts.batch_params(cc, {}, device="cpu")[0],
                            semantics="bogus")


def _op_inputs(deck, lanes):
    cc = ts.compile_circuit(ts.parse(deck))
    rng = np.random.default_rng(3)
    params, _ = ts.batch_params(cc, r_spread(cc, lanes, rng), device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    plan = run_plan.make_plan(cc, "op")
    dev = run_plan.const_stack(plan, params, lanes, "cpu", DEFAULTS.temp,
                               state0)
    dyn = torch.zeros((lanes, op.dyn_width(plan)), dtype=torch.float64)
    dyn[:, 1] = 1.0  # from the linear estimate
    dyn[:, 2] = 1.0  # every lane active
    dyn[:, 3] = 2.0  # Vin
    x0 = torch.zeros((lanes, plan.np1), dtype=torch.float64)
    jv0 = torch.zeros((lanes, plan.kj), dtype=torch.float64)
    sc = op.OPScalars(DEFAULTS.reltol, DEFAULTS.abstol, DEFAULTS.max_iter,
                      DEFAULTS.gmin)
    return plan, dev, dyn, x0, jv0, sc


def test_cpu_tensors_take_the_plain_version():
    plan, dev, dyn, x0, jv0, sc = _op_inputs(D_DIV, 3)
    before = op.launch_op_kernel.launches
    got = op.op_lanes(plan, dev, dyn, x0, jv0, sc)
    want = op.op_plain(plan, dev, dyn, x0, jv0, sc)
    assert op.launch_op_kernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool(got.conv.all()) and bool((got.iters > 1).all())
    with pytest.raises(ValueError, match="CUDA"):
        op.launch_op_kernel(plan, dev, dyn, x0, jv0, sc)


def test_inactive_lanes_keep_their_inputs():
    plan, dev, dyn, x0, jv0, sc = _op_inputs(D_DIV, 3)
    dyn[:, 1] = 0.0
    dyn[1, 2] = 0.0
    x0[1] = 0.25
    jv0[1] = 0.5
    got = op.op_plain(plan, dev, dyn, x0, jv0, sc)
    assert got.iters.tolist()[1] == 0 and not bool(got.conv[1])
    assert torch.equal(got.x[1], x0[1]) and torch.equal(got.jv[1], jv0[1])
    assert bool(got.conv[0]) and bool(got.conv[2])


def test_wrapper_checks_plan_dtype_and_shape():
    plan, dev, dyn, x0, jv0, sc = _op_inputs(D_DIV, 2)
    with pytest.raises(TypeError, match="float64"):
        op.op_lanes(plan, dev, dyn.float(), x0, jv0, sc)
    with pytest.raises(ValueError, match="must be"):
        op.op_lanes(plan, dev, dyn[:, :2], x0, jv0, sc)
    tran = run_plan.make_plan(ts.compile_circuit(ts.parse(D_DIV)))
    with pytest.raises(ValueError, match="mode 'op'"):
        op.op_lanes(tran, dev, dyn, x0, jv0, sc)


def test_gmin_floor_option_reaches_the_capacitor_leak():
    """A capacitor-only node: the OP leak is max(status gmin, floor)."""
    deck = """* floating cap node
.op
V1 1 0 DC 1
R1 1 2 1k
C1 2 3 1u
D1 3 0 DM
.model DM D (Is=1e-14)
"""
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, {})
    from toyspice_tpu.engine.options import SimOptions as JaxOptions

    jopts = JaxOptions(gmin=1e-9)
    op_g, _ = make_op(cc, jopts)
    ref = jax.jit(op_g)(params, jax_init_state(cc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pcc = ts.compile_circuit(ts.parse(deck))
    out = op.make_op_fused(pcc, SimOptions(gmin=1e-9))(
        params_from_numpy(params_np, device="cpu"),
        ts.init_state(pcc, device="cpu"))
    assert out.converged.tolist() == [bool(ref.converged)]
    assert out.stage.tolist() == [int(ref.stage)]
    np.testing.assert_allclose(out.x.numpy()[0], np.asarray(ref.x),
                               rtol=RTOL, atol=ATOL)
