"""The port's nonlinear compat transient on the CPU (``make_tran_batch``:
the plain version of the OP kernel for the warm-up, then the plain version
of the run kernel with its in-kernel Newton) against the JAX package's
general engine (engine/tran.py ``make_tran``, vmapped), on the half-wave
rectifier (diode), the NMOS inverter (MOSFET) and a CE-amplifier BJT
transient, 4 lanes each with R and C spread log-normally.

``accepted``, ``attempts``, ``fail`` and ``nr_iters`` must be equal per
lane; state, junction voltages and t_final within rtol 1e-9 (both sides
f64).  Inputs are made with numpy from a seed and handed to both
packages."""

import os

import numpy as np
import pytest
import torch

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.ops import op, run, run_plan

from test_torch_run import RTOL, assert_matches, lognormal, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# ce_amplifier_ac.cir's circuit with a SIN drive
BJT_TRAN = """* CE amplifier transient (ce_amplifier_ac.cir's circuit, SIN drive)
.tran 5u 2m
Vcc vcc 0 DC 12
Vsig sig 0 SIN(0 20m 1k)
Rsrc sig in 600
Cin in base 10u
Rb1 vcc base 68k
Rb2 base 0 12k
Rc vcc col 3.3k
Re emit 0 680
Cb emit 0 47u
Q1 col base emit QNPN
.model QNPN NPN (Bf=180 Vaf=90)
"""

DECKS = {"half_wave_rectifier": _deck("half_wave_rectifier.cir"),
         "nmos_inverter_tran": _deck("nmos_inverter_tran.cir"),
         "bjt_ce_tran": BJT_TRAN}


def port_batch(deck, cfg, params_np):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run"
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


def assert_jv_matches(out, ref):
    assert set(out.jv) == set(ref.jv)
    for kind in ref.jv:
        assert set(out.jv[kind]) == set(ref.jv[kind])
        for key in ref.jv[kind]:
            a = np.asarray(ref.jv[kind][key])
            f = out.jv[kind][key].numpy()
            assert f.shape == a.shape, f"{kind}.{key}"
            np.testing.assert_allclose(
                f, a, rtol=RTOL, atol=RTOL * max(1e-300, np.abs(a).max()),
                err_msg=f"jv.{kind}.{key}")


@pytest.mark.parametrize("name", list(DECKS))
def test_plain_matches_general_engine(name):
    deck = DECKS[name]
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(13)
    ov = {k: {"value": lognormal(rng, cc.params[k]["value"], 4)}
          for k in ("R", "C")}
    cfg, _, params_np, ref = reference(deck, ov)
    out = port_batch(deck, cfg, params_np)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not out.fail.any()
    assert bool((out.nr_iters > out.attempts).all())  # Newton ran


def test_uic_skips_the_op_and_starts_from_zero_junctions():
    deck = DECKS["half_wave_rectifier"]
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(17)
    ov = {"R": {"value": lognormal(rng, cc.params["R"]["value"], 2)}}
    cfg, _, params_np, ref = reference(deck, ov, {"uic": True})
    pcc = ts.compile_circuit(ts.parse(deck))
    fn = run.make_tran_run(pcc, cfg)
    assert fn.op is None
    before = op.launch_op_kernel.launches
    out = fn(params_from_numpy(params_np, device="cpu"),
             ts.init_state(pcc, device="cpu"))
    assert op.launch_op_kernel.launches == before
    assert_matches(out, ref)
    assert_jv_matches(out, ref)


def test_the_op_junctions_warm_start_the_run():
    """make_tran_run hands the OP's junction voltages to the run lanes;
    from zero junctions (the BJT's cold-start guess) the first attempt
    ends elsewhere."""
    cc = ts.compile_circuit(ts.parse(BJT_TRAN))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, {}, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    fn = run.make_tran_run(cc, cfg._replace(max_attempts=1))
    opr = fn.op(params, state0)
    assert opr.converged.tolist() == [True] and opr.stage.tolist() == [0]
    out = fn(params, state0)
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, 1, "cpu", 300.15, state0)
    src = run_plan.source_stack(plan, params, 1, "cpu")
    st = run_plan.init_state_stack(plan, state0, 1, "cpu")
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0, 1)
    warm = run.run_lanes(plan, dev, src, st, sc,
                         run_plan.jv_stack(plan, opr.jv, 1))
    cold = run.run_lanes(plan, dev, src, st, sc)
    assert torch.equal(out.nr_iters, warm.nr_iters)
    assert torch.equal(out.jv["Q"]["vbe"], warm.jv[:, :1])
    assert not torch.equal(cold.jv, warm.jv)
    # compat commits no BJT state: it leaves the run as it came in
    assert torch.equal(out.state["Q"]["qbe"],
                       torch.zeros((1, 1), dtype=torch.float64))


# a level-3 NMOS inverter driving a level-2 PMOS inverter: both engines run
# it to tstop (a CMOS pair of these levels hard-fails on both at its first
# edge)
MOS23_TRAN = """* two stages: a level-3 NMOS inverter driving a level-2 PMOS inverter
.tran 1u 0.2m
Vdd vdd 0 DC 5
Vg gate 0 PULSE(0 5 20u 2u 2u 60u 120u)
Rpull vdd d1 10k
Mn d1 gate 0 0 NM3 L=2u W=20u
C1 d1 0 10p
Mp d2 d1 vdd vdd PM2 L=2u W=40u
Rload d2 0 20k
C2 d2 0 10p
.model NM3 NMOS(Level=3 VTO=0.7 KP=300u THETA=0.05 KAPPA=0.3)
.model PM2 PMOS(Level=2 VTO=-0.8 KP=150u UCRIT=1e4 UEXP=0.1)
"""

# The bar this deck meets, below the one above: the level-2/3 conductances
# are differences of two currents 1e-6 V apart, so an ulp between XLA's and
# PyTorch's rounding of a current is ~1e-9 of gm, gds and gmbs
# (tests/test_torch_models.py); over 206 steps that moves a Newton
# convergence test by one iteration on some lanes and the state by ~1e-8.
MOS23_RTOL = 5e-8


def test_level23_mosfet_transient_runs_to_tstop():
    cc = jax_compile(jax_parse(MOS23_TRAN))
    rng = np.random.default_rng(13)
    ov = {k: {"value": lognormal(rng, cc.params[k]["value"], 4)}
          for k in ("R", "C")}
    cfg, _, params_np, ref = reference(MOS23_TRAN, ov)
    out = port_batch(MOS23_TRAN, cfg, params_np)
    for key in ("accepted", "attempts", "fail"):
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    assert not out.fail.any()
    np.testing.assert_array_equal(out.t_final.numpy(),
                                  np.asarray(ref.t_final))
    assert bool((out.t_final == cfg.tstop).all())
    d = np.abs(out.nr_iters.numpy() - np.asarray(ref.nr_iters))
    assert d.max() <= 1, d
    for tree, rtree in ((out.state, ref.state), (out.jv, ref.jv)):
        for kind in rtree:
            for key in rtree[kind]:
                a = np.asarray(rtree[kind][key])
                f = tree[kind][key].numpy()
                scale = max(1e-300, float(np.max(np.abs(a))))
                np.testing.assert_allclose(f, a, rtol=MOS23_RTOL,
                                           atol=MOS23_RTOL * scale,
                                           err_msg=f"{kind}.{key}")
