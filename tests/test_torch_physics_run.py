"""The port's physics-semantics transient on the CPU (``make_tran_batch``
with ``semantics="physics"``: the plain version of the OP kernel's physics
flavour, or the linear OP, then the bias-point seed and the plain version
of the run kernel's PHYS instantiation) against the JAX package's general
engine (engine/tran.py ``make_tran(semantics="physics")``, vmapped), under
backward Euler and the trapezoidal rule, on the half-wave rectifier
(diode, non-UIC) and the Tt diode of tests/test_trapezoidal.py (UIC: no
OP).

The bar of tests/test_run_kernel.py: ``accepted``, ``attempts`` and
``fail`` equal per lane (and ``nr_iters``, except where a case says why
not); state, junction voltages and t_final within rtol 1e-9 of each
leaf's scale.  A companion current computed from a charge difference
(C.i0, D.ic0, the MOSFET's ic*) is also allowed the rounding of that
difference, CHARGE_ULPS ulps of its charge over minstep: dq/dt rounds like
the charge, and the general engine's fused multiply-adds leave a few ulps
of q where the port's difference is exactly 0.  Inputs are made with
numpy from a seed and handed to both packages."""

import os

import numpy as np
import pytest

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.ops import op

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-9
COUNTERS = ("accepted", "attempts", "fail", "nr_iters")
# companion currents and the charges they difference; the ulps of the
# charge (over minstep) that a current may differ by besides RTOL
CHARGE_ULPS = 4
CHARGE_OF = {("C", "i0"): "q0", ("D", "ic0"): "prev_charge",
             **{("M", "ic" + q[1:]): q
                for q in ("qgs", "qgd", "qgb", "qbs", "qbd")}}


def deck_file(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# tests/test_trapezoidal.py's Tt diode (UIC), at its 0.2 us step
D_TT = """diode tt order
.tran 0.2u 20u uic
V1 1 0 SIN(1.0 0.4 100k)
R1 1 2 1k
D1 2 0 DM
R2 2 0 100k
.model DM D (Is=1e-12 Tt=1u)
"""


def lognormal(rng, base, b, spread=0.1):
    base = np.asarray(base)
    return base[None] * np.exp(rng.normal(0.0, spread, (b,) + base.shape))


def spread(deck, keys=("R", "C"), lanes=4, seed=13):
    """Per-lane values of ``keys``, log-normal by 0.1 from ``seed``."""
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(seed)
    return {k: {"value": lognormal(rng, cc.params[k]["value"], lanes)}
            for k in keys if k in cc.params}


def reference(deck, overrides, integration, store="none", cfg_edit=None):
    """The JAX general engine under physics: (cfg, params as numpy, out)."""
    cc = jax_compile(jax_parse(deck))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    if cfg_edit:
        cfg = cfg._replace(**cfg_edit)
    params, axes = jax_batch_params(cc, overrides)
    opts = JaxOptions(integration=integration)
    fn = jax.jit(jax.vmap(make_tran(cc, cfg, semantics="physics",
                                    store=store, opts=opts),
                          in_axes=(axes, None)))
    out = fn(params, jax_init_state(cc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return cfg, params_np, out


def port(deck, cfg, params_np, integration, store="none", engine="run"):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None, semantics="physics", store=store,
                            opts=ts.SimOptions(integration=integration))
    assert fn.engine == engine
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


def close(name, f, a, scale, floor=0.0):
    assert f.shape == a.shape, name
    scale = max(1e-300, scale)
    np.testing.assert_allclose(f, a, rtol=RTOL,
                               atol=max(RTOL * scale, floor), err_msg=name)


def assert_physics_matches(out, ref, cfg, counters=COUNTERS):
    """The bar above: counters equal per lane, state, jv and t_final within
    RTOL of each leaf's scale."""
    for key in counters:
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    np.testing.assert_allclose(out.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=RTOL, atol=0)
    assert set(out.state) == set(ref.state)
    for kind in ref.state:
        assert set(out.state[kind]) == set(ref.state[kind]), kind
        for key in ref.state[kind]:
            a = np.asarray(ref.state[kind][key])
            floor = 0.0
            if (kind, key) in CHARGE_OF:
                q = np.asarray(ref.state[kind][CHARGE_OF[kind, key]])
                floor = (CHARGE_ULPS * np.finfo(np.float64).eps
                         * float(np.max(np.abs(q))) / cfg.minstep)
            close(f"{kind}.{key}", out.state[kind][key].numpy(), a,
                  float(np.max(np.abs(a))), floor)
    assert set(out.jv) == set(ref.jv)
    for kind in ref.jv:
        for key in ref.jv[kind]:
            a = np.asarray(ref.jv[kind][key])
            close(f"jv.{kind}.{key}", out.jv[kind][key].numpy(), a,
                  float(np.max(np.abs(a))))


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_rectifier_matches_general_engine(integration):
    """The main path's deck, non-UIC: the physics OP, the seed, the run."""
    deck = deck_file("half_wave_rectifier.cir")
    cfg, params_np, ref = reference(deck, spread(deck), integration)
    out = port(deck, cfg, params_np, integration)
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
    # the physics run commits the diode's charge memory and first-step flag
    assert bool((out.state["D"]["hist"] == 1).all())
    assert bool((out.state["C"]["hist"] == 1).all())


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_uic_tt_diode_matches_general_engine(integration):
    """UIC: no OP launch, the zero state; the diffusion charge's BE or
    trapezoidal companion carries the dynamics."""
    cc = ts.compile_circuit(ts.parse(D_TT))
    tp = cc.netlist.tran
    cfg0 = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    assert ts.make_tran_batch(cc, cfg0, None, semantics="physics").op is None
    before = op.launch_op_kernel.launches
    cfg, params_np, ref = reference(D_TT, spread(D_TT, ("R",)), integration)
    out = port(D_TT, cfg, params_np, integration)
    assert op.launch_op_kernel.launches == before
    assert_physics_matches(out, ref, cfg)
    assert float(np.abs(out.state["D"]["ic0"].numpy()).max()) > 0


def test_physics_starts_at_the_bias_point():
    """A physics run starts at the bias point: a DC-charged capacitor
    begins at its OP voltage, with no C·V/dt spike on the first step
    (engine/state.py make_op_seed), under BE and trap alike; compat keeps
    the reference's zero state and charges it from 0."""
    deck = """* DC-charged RC
.tran 1u 20u
V1 1 0 DC 5
R1 1 2 1k
C1 2 0 1u
"""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, {}, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    n2 = cc.node_map["2"]
    for integration in ("be", "trap"):
        fn = ts.make_tran_batch(cc, cfg, None, semantics="physics",
                                store="full",
                                opts=ts.SimOptions(integration=integration))
        out = fn(params, state0)
        n = int(out.out_n[0])
        # every row at the OP's V(2): 5 V less the 1e-9 share the
        # capacitor's gmin leak takes in the OP
        np.testing.assert_allclose(out.out_x[0, :n, n2].numpy(), 5.0,
                                   rtol=2e-9)
    compat = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    assert float(compat.out_x[0, 0, n2]) < 1.0
