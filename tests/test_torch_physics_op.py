"""The port's physics-semantics OP, DC sweep and AC on the CPU against the
JAX package's general engine under physics (engine/op.py ``make_op``,
engine/dc.py ``make_dc`` and engine/ac.py ``make_ac_batch``, vmapped):

* ``run_op_batch(semantics="physics")``: the plain version of the OP
  kernel's physics flavour under the rescue ladders on the Rs and Bv
  diodes of tests/test_physics_mode.py, ce_amplifier_op.cir and a level-1
  MOSFET bias; the stamped solve on divider_op.cir (a linear deck's OP
  stamps do not depend on the semantics).  ``converged``, ``stage`` and
  the plain-NR iterations equal per lane, x and jv within rtol 1e-9,
  atol 1e-12;
* ``run_dc_batch(semantics="physics")``: diode_iv_sweep.cir with the
  diode's Rs drawn per lane (the plain version of the DC sweep kernel's
  physics flavour), the bar of tests/test_torch_dc.py;
* ``run_ac_batch(semantics="physics")``: ce_amplifier_ac.cir and a diode
  with Rs, whose small-signal gd at the physics bias includes Rs, the bar
  of tests/test_torch_ac.py.

Inputs are made with numpy from a seed and handed to both packages."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.ac import frequency_points as jax_freqs
from toyspice_tpu.engine.ac import make_ac_batch as jax_make_ac_batch
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.dc import make_dc as jax_make_dc
from toyspice_tpu.engine.dc import sweep_values as jax_sweep_values
from toyspice_tpu.engine.newton import make_nr
from toyspice_tpu.engine.nlstate import init_jv as jax_init_jv
from toyspice_tpu.engine.op import make_op
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12
AC_TOL = 2e-9  # tests/test_torch_ac.py's bar


def deck_file(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# tests/test_physics_mode.py's Rs and Bv diodes
D_RS = """* forward diode with series resistance
.tran 0.05m 0.5m
Vin 1 0 DC 5
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Rs=100)
"""

D_BV = """* reverse diode into breakdown
.tran 0.05m 0.5m
Vin 1 0 DC -200
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Bv=100)
"""

# tests/test_fused_op.py's MOSFET bias deck
M_BIAS = """* MOSFET bias
.op
VDD 1 0 DC 5
VG 2 0 DC 2
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01)
"""

# a diode with Rs and a junction capacitance biased forward
D_RS_AC = """* diode with Rs, AC at its bias
.ac DEC 8 100 1meg
Vdc 5 0 DC 0.8
Vin 1 5 AC 0.01
R1 1 2 500
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2 Rs=20 Cj0=4p Vj=0.8 M=0.4)
"""


def r_spread(cc, b, seed=7):
    rng = np.random.default_rng(seed)
    r = np.asarray(cc.params["R"]["value"])
    return {"R": {"value": r[None] * np.exp(rng.normal(0, 0.1,
                                                       (b, len(r))))}}


def numpy_tree(params):
    return {k: {kk: np.asarray(v) for kk, v in t.items()}
            for k, t in params.items()}


def op_reference(deck, overrides):
    """The general engine's physics OP and its plain-NR iterations from the
    linear estimate (the stage-0 Newton the port counts)."""
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, overrides)
    opts = JaxOptions()
    op_g, estimate = make_op(cc, opts, semantics="physics")
    nr = make_nr(cc, mode="op", warm_start=False, conv="op",
                 semantics="physics", opts=opts)
    s0 = jax_init_state(cc)

    def lane(p):
        r0 = nr(p, s0, jax_init_jv(cc), estimate(p, s0, 1.0), t=0.0, dt=0.0,
                gmin=0.0, dc_scale=1.0)
        return op_g(p, s0), r0.iters

    ref, iters = jax.jit(jax.vmap(lane, in_axes=(axes,)))(params)
    return numpy_tree(params), ref, np.asarray(iters)


@pytest.mark.parametrize("deck,engine", [
    (D_RS, "fused"), (D_BV, "fused"),
    (deck_file("ce_amplifier_op.cir"), "fused"), (M_BIAS, "fused"),
    (deck_file("divider_op.cir"), "linear")],
    ids=["d_rs", "d_bv", "ce_amplifier_op", "mosfet_bias", "divider_op"])
def test_physics_op_matches_general_engine(deck, engine):
    cc = jax_compile(jax_parse(deck))
    params_np, ref, iters = op_reference(deck, r_spread(cc, 4))
    pcc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(pcc, "physics")[0] == engine
    out = ts.run_op_batch(pcc, params_from_numpy(params_np, device="cpu"),
                          semantics="physics")
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.stage.numpy(), np.asarray(ref.stage))
    assert bool(out.converged.all()) and not bool(out.stage.any())
    if engine == "fused":
        np.testing.assert_array_equal(out.iters.numpy(), iters)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)
    assert set(out.jv) == set(ref.jv)
    for kind in ref.jv:
        for key in ref.jv[kind]:
            np.testing.assert_allclose(
                out.jv[kind][key].numpy(), np.asarray(ref.jv[kind][key]),
                rtol=RTOL, atol=ATOL, err_msg=f"jv.{kind}.{key}")


def test_physics_changes_the_diode_bias():
    """Rs lowers the forward current against compat, which ignores it;
    Bv clamps the reverse diode near -Bv where compat leaves it at -Vin."""
    for deck, check in ((D_RS, lambda c, p: p[3] > c[3]),
                        (D_BV, lambda c, p: p[2] > -101 and c[2] < -199)):
        cc = ts.compile_circuit(ts.parse(deck))
        params, _ = ts.batch_params(cc, {}, device="cpu")
        xc = ts.run_op_batch(cc, params).x[0].tolist()
        xp = ts.run_op_batch(cc, params, semantics="physics").x[0].tolist()
        # x[3] is the source's branch row (-I); x[2] the diode's anode
        assert check(xc, xp), (xc, xp)


def test_physics_dc_sweep_matches_general_engine():
    deck = deck_file("diode_iv_sweep.cir")
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(9)
    b = 3
    ov = {"R": {"value": np.asarray(cc.params["R"]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (b, 1)))},
          "D": {"rs": rng.uniform(1.0, 20.0, (b, 1))}}
    params, axes = jax_batch_params(cc, ov)
    d = cc.netlist.dc
    pts = np.asarray(jax_sweep_values(d.start1, d.stop1, d.increment1))
    slot = (cc.names["V"].index(d.source1),)
    dc = jax_make_dc(cc, slot, JaxOptions(), semantics="physics")
    s0 = jax_init_state(cc)
    xs_ref, conv_ref = jax.jit(jax.vmap(lambda p: dc(p, s0, jnp.asarray(pts)),
                                        in_axes=(axes,)))(params)
    pcc = ts.compile_circuit(ts.parse(deck))
    xs, conv = ts.run_dc_batch(pcc, slot, params_from_numpy(
        numpy_tree(params), device="cpu"), None, pts, semantics="physics")
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_ref), rtol=RTOL,
                               atol=ATOL)
    # Rs shifts the curve against compat's at the top of the sweep
    xc, _ = ts.run_dc_batch(pcc, slot, params_from_numpy(
        numpy_tree(params), device="cpu"), None, pts)
    assert float((xc[:, -1, -1] - xs[:, -1, -1]).abs().min()) > 1e-6


@pytest.mark.parametrize("deck", [deck_file("ce_amplifier_ac.cir"),
                                  D_RS_AC], ids=["ce_amplifier_ac",
                                                 "diode_rs"])
def test_physics_ac_matches_general_engine(deck):
    cc = jax_compile(jax_parse(deck))
    ap = cc.netlist.ac
    freqs = jax_freqs(ap.sweep, ap.fstart, ap.fstop, ap.points)
    params, axes = jax_batch_params(cc, r_spread(cc, 3, 2))
    xr_ref, xi_ref, opr = jax.jit(jax_make_ac_batch(
        cc, axes, JaxOptions(), semantics="physics"))(
        params, jax_init_state(cc), jnp.asarray(freqs))
    pcc = ts.compile_circuit(ts.parse(deck))
    xr, xi, out = ts.run_ac_batch(pcc, params_from_numpy(
        numpy_tree(params), device="cpu"), None, freqs, semantics="physics")
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(opr.converged))
    assert bool(out.converged.all())
    xr_ref, xi_ref = np.asarray(xr_ref), np.asarray(xi_ref)
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max(), 1e-12)
    np.testing.assert_allclose(xr.numpy(), xr_ref, rtol=AC_TOL,
                               atol=AC_TOL * scale)
    np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=AC_TOL,
                               atol=AC_TOL * scale)
