"""The port's batched DC sweep on the CPU (``run_dc_batch``: the plain
version of csrc/dc_sweep_kernel.cu on a nonlinear deck, of
csrc/stamped_solve.cu on a linear one) against the JAX package's general
engine (engine/dc.py ``make_dc``, vmapped), on diode_iv_sweep.cir (all 35
points of ``sweep_values``), tests/test_fused_op.py's diode sweep, a BJT
and a level-1 MOSFET deck, a nested two-source sweep, per-lane PWL knots on
an unswept source, the linear divider sweep, and the card tests'
level-2/3 CMOS pair, single and nested.

``conv`` must be equal per point, xs within rtol 1e-9, atol 1e-12 (both
sides f64; the level-2/3 pair meets the bar written above its test).
Inputs are made with numpy from a seed and handed to both packages."""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.dc import make_dc as jax_make_dc
from toyspice_tpu.engine.dc import sweep_values as jax_sweep_values
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.engine.options import DEFAULTS
from toyspice_tpu_torch.ops import dc as dc_ops
from toyspice_tpu_torch.ops import solve_stamped

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# tests/test_fused_op.py's sweeps
D_DC = """* diode dc sweep (diode3-like)
.dc Vin 0 1.0 0.2
Vin 1 0 DC 0
D1 1 2 DM
R1 2 0 1k
.model DM D (Is=1e-14)
"""

D_PWL_DC = """* dc sweep with a pwl aux source
.dc Vs 0 1 0.25
Vs 1 0 DC 0
Vaux 3 0 PWL(0 0.2 1m 1)
R1 1 2 1k
Raux 3 2 2k
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2)
"""

BJT_DC = """* BJT base sweep
.dc Vb 0 1.2 0.05
Vcc 1 0 DC 5
Vb 2 0 DC 0
Rb 2 3 10k
Rc 1 4 1k
Re 5 0 100
Q1 4 3 5 QN
.model QN NPN(Bf=120 Vaf=60)
"""

MOS_DC = """* MOSFET gate sweep
.dc VG 0 4 0.25
VDD 1 0 DC 5
VG 2 0 DC 0
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01)
"""

# tests/test_torch_cuda.py's level-2/3 CMOS pair
MOS23_DC = """* MOSFET gate sweep, levels 2 and 3 and a PMOS load
.dc VG 0 4 0.25
VDD 1 0 DC 5
VG 2 0 DC 0
Mp 3 2 1 1 PM2 L=2u W=20u
Mn 3 2 0 0 NM3 L=2u W=10u
RL 3 0 100k
.model PM2 PMOS(Level=2 VTO=-0.8 KP=15u UCRIT=1e4 UEXP=0.1)
.model NM3 NMOS(Level=3 VTO=0.7 KP=30u THETA=0.05 KAPPA=0.3)
"""

# tests/test_analytic_ac_dc.py's linear sweep
DIVIDER_DC = """divider sweep
.dc Vin 0 10 0.5
Vin in 0 DC 0
R1 in mid 3k
R2 mid 0 1k
"""


def sweep_points(cc):
    d = cc.netlist.dc
    return np.asarray(jax_sweep_values(d.start1, d.stop1, d.increment1))


def reference(deck, overrides, slots, points):
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, overrides)
    dc = jax_make_dc(cc, slots)
    s0 = jax_init_state(cc)
    pts = jnp.asarray(points)
    xs, conv = jax.jit(jax.vmap(lambda p: dc(p, s0, pts),
                                in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return params_np, np.asarray(xs), np.asarray(conv)


def check(deck, overrides, slots, points, engine, xs_bar=None):
    """conv equal per point, xs within RTOL and ATOL (or held by
    ``xs_bar(xs, xs_ref, conv)``)."""
    params_np, xs_ref, conv_ref = reference(deck, overrides, slots, points)
    cc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(cc)[0] == engine
    xs, conv = ts.run_dc_batch(cc, slots,
                               params_from_numpy(params_np, device="cpu"),
                               None, points)
    np.testing.assert_array_equal(conv.numpy(), conv_ref)
    assert xs.shape == xs_ref.shape
    if xs_bar is None:
        np.testing.assert_allclose(xs.numpy(), xs_ref, rtol=RTOL, atol=ATOL)
    else:
        xs_bar(xs.numpy(), xs_ref, conv_ref)
    return xs, conv


def spread(cc, keys, b, seed):
    rng = np.random.default_rng(seed)
    return {kind: {key: np.asarray(cc.params[kind][key])[None] * np.exp(
        rng.normal(0, 0.1, (b, len(cc.params[kind][key]))))}
        for kind, key in keys}


def test_sweep_values_match_the_reference():
    for args in ((0.2, 0.9, 0.02), (0, 1.0, 0.2), (0, 10, 0.5),
                 (-1, 1, 0.1)):
        assert ts.sweep_values(*args) == jax_sweep_values(*args)
    assert len(ts.sweep_values(0.2, 0.9, 0.02)) == 35


def test_diode_iv_sweep():
    deck = _deck("diode_iv_sweep.cir")
    cc = jax_compile(jax_parse(deck))
    pts = sweep_points(cc)
    assert len(pts) == 35
    xs, conv = check(deck, spread(cc, (("R", "value"), ("D", "is_")), 4, 0),
                     (0,), pts, "fused")
    assert bool(conv.all())


def test_diode_sweep_two_lanes():
    cc = jax_compile(jax_parse(D_DC))
    ov = {"R": {"value": np.asarray(cc.params["R"]["value"])[None]
                * [[1.0], [0.8]]}}
    check(D_DC, ov, (0,), np.arange(0.0, 1.01, 0.2), "fused")


def test_bjt_sweep_with_a_batched_supply():
    cc = jax_compile(jax_parse(BJT_DC))
    ov = spread(cc, (("R", "value"),), 3, 1)
    ov["V"] = {"dc": np.array([[5.0, 0.0], [4.0, 0.0], [6.0, 0.0]])}
    slot = cc.names["V"].index("Vb")
    xs, conv = check(BJT_DC, ov, (slot,), sweep_points(cc), "fused")
    # a point near the knee may run out of iterations: on both engines
    assert int(conv.sum()) >= conv.numel() - 3


def test_mosfet_nested_sweep():
    """VDD outer, VG inner: the (P, 2) points of engine's run_dc."""
    cc = jax_compile(jax_parse(MOS_DC))
    vdd = jax_sweep_values(0.0, 5.0, 1.0)
    vg = jax_sweep_values(0.0, 3.0, 0.5)
    pts = np.array([(a, b) for a in vdd for b in vg], dtype=np.float64)
    slots = (cc.names["V"].index("VDD"), cc.names["V"].index("VG"))
    xs, conv = check(MOS_DC, spread(cc, (("R", "value"),), 2, 2), slots,
                     pts, "fused")
    assert xs.shape == (2, len(pts), cc.np1)
    assert bool(conv.all())


def test_mosfet_single_sweep():
    cc = jax_compile(jax_parse(MOS_DC))
    check(MOS_DC, spread(cc, (("R", "value"),), 2, 3),
          (cc.names["V"].index("VG"),), sweep_points(cc), "fused")


# The bar the level-2/3 pair meets.  Its conductances differ from the JAX
# package's by about 1e-9 relative (ROADMAP Queue 3), so at a point whose
# solution lies within the 5 V rails xs is held to 1e-8 absolute (2e-9 of
# the supply; 3.8e-9 measured).  The nested sweep's VDD = 5 half starts
# from the junction voltages of the VDD = 3 half's last point and accepts
# three points far outside the rails (node 3 near -900 V), where the DC
# test passes on a last step within reltol (1e-6) of |x| on each engine:
# there xs is held to 1e-5 relative (1.6e-6 measured), and every later
# point of the lane fails on both engines.
RAILS_ATOL, OUTSIDE_RTOL = 1e-8, 1e-5


def level23_bar(xs, xs_ref, conv):
    np.testing.assert_array_equal(np.isfinite(xs), np.isfinite(xs_ref))
    size = np.abs(np.where(np.isfinite(xs_ref), xs_ref, 0.0)).max(-1)
    rails = (conv & (size <= 5.0))[..., None]
    outside = (conv & (size > 5.0))[..., None]
    np.testing.assert_allclose(np.where(rails, xs, 0.0),
                               np.where(rails, xs_ref, 0.0),
                               rtol=0, atol=RAILS_ATOL)
    np.testing.assert_allclose(np.where(outside, xs, 0.0),
                               np.where(outside, xs_ref, 0.0),
                               rtol=OUTSIDE_RTOL, atol=0)


@pytest.mark.parametrize("nested", [False, True], ids=["single", "nested"])
def test_level23_cmos_sweep(nested):
    """The card test's deck, sweeps and R spread (its first 4 lanes):
    conv equal per point."""
    cc = jax_compile(jax_parse(MOS23_DC))
    pts = sweep_points(cc)
    slots = (cc.names["V"].index("VG"),)
    if nested:
        pts = np.array([(a, b) for a in (3.0, 5.0) for b in pts])
        slots = (cc.names["V"].index("VDD"),) + slots
    xs, conv = check(MOS23_DC, spread(cc, (("R", "value"),), 4, 4), slots,
                     pts, "fused", xs_bar=level23_bar)
    if nested:  # VDD = 3 throughout, VDD = 5 on its first three points
        assert bool(conv[:, :20].all()) and not bool(conv[:, 20:].any())
    else:
        assert bool(conv.all())


def test_batched_pwl_knots_on_the_unswept_source():
    cc = jax_compile(jax_parse(D_PWL_DC))
    pt = np.asarray(cc.params["V"]["pwl_t"])[None]
    pv = np.asarray(cc.params["V"]["pwl_v"])[None]
    ov = {"V": {"pwl_t": np.concatenate([pt, pt * 2.0]),
                "pwl_v": np.concatenate([pv, pv * 0.6])}}
    xs, _ = check(D_PWL_DC, ov, (cc.names["V"].index("Vs"),),
                  np.arange(0.0, 1.01, 0.25), "fused")
    assert float((xs[0] - xs[1]).abs().max()) > 0.01


def test_linear_divider_sweep_is_one_stamped_solve():
    from toyspice_tpu_torch.engine.dc import make_dc

    cc = jax_compile(jax_parse(DIVIDER_DC))
    pts = sweep_points(cc)
    ov = spread(cc, (("R", "value"),), 3, 4)
    xs, conv = check(DIVIDER_DC, ov, (0,), pts, "linear")
    assert bool(conv.all())
    r = ov["R"]["value"]
    np.testing.assert_allclose(
        xs[..., 2].numpy(), pts[None] * (r[:, 1] / (r[:, 0] + r[:, 1]))[:,
                                                                       None],
        rtol=1e-12, atol=1e-15)
    calls = []

    def counting(pat, vals, rvals, gmin):
        calls.append(vals.shape[0])
        return solve_stamped.solve_plain(pat, vals, rvals, gmin)

    pcc = ts.compile_circuit(ts.parse(DIVIDER_DC))
    params, _ = ts.batch_params(pcc, ov, device="cpu")
    xs2, _ = make_dc(pcc, (0,), solve=counting)(
        params, ts.init_state(pcc, device="cpu"), pts)
    assert calls == [3 * len(pts)]  # all B·P systems in one solve
    assert torch.equal(xs2, xs)


def test_source_table_shapes():
    """One (P, nV) table when no V leaf is batched, (B, P, nV) else."""
    cc = ts.compile_circuit(ts.parse(D_PWL_DC))
    pts = torch.arange(0.0, 1.01, 0.25, dtype=torch.float64)
    params, _ = ts.batch_params(cc, {"R": {"value": np.ones((3, 2))}},
                                device="cpu")
    shared = dc_ops.source_table(cc, params, (0,), pts, 3)
    assert shared.shape == (5, 2)
    assert torch.equal(shared[:, 0], pts)
    params["V"]["dc"] = params["V"]["dc"][None].expand(3, 2).clone()
    batched = dc_ops.source_table(cc, params, (0,), pts, 3)
    assert batched.shape == (3, 5, 2)
    assert torch.equal(batched[1], shared)


def test_kernel_entry_checks():
    cc = ts.compile_circuit(ts.parse(D_DC))
    fn = dc_ops.make_dc_fused(cc, (0,), DEFAULTS)
    plan = fn.plan
    dev = torch.zeros((2, plan.nd), dtype=torch.float64)
    dyn = torch.zeros((2, dc_ops.dyn_width(plan)), dtype=torch.float64)
    vs = torch.zeros((3, 1), dtype=torch.float64)
    sc = dc_ops.DCScalars(1e-6, 1e-12, 100, 1e-12)
    with pytest.raises(ValueError, match="CUDA"):
        dc_ops.launch_dc_kernel(plan, dev, dyn, vs, sc)
    with pytest.raises(ValueError, match="vs must be"):
        dc_ops.dc_lanes(plan, dev, dyn, torch.zeros((3, 2),
                                                    dtype=torch.float64), sc)
    before = dc_ops.launch_dc_kernel.launches
    r = dc_ops.dc_lanes(plan, dev, dyn, vs, sc)
    assert dc_ops.launch_dc_kernel.launches == before
    assert r.xs.shape == (2, 3, plan.np1) and r.conv.shape == (2, 3)
