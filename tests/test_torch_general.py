"""The port's general engine transient on the CPU (``engine/tran.make_tran``:
the general OP as warm-up, then the masked attempt loop over the general
Newton, assemble_entries and the plain stamped solve) against the JAX
package's general engine (engine/tran.py ``make_tran``, vmapped), called
directly on the same numpy inputs: a 3-stage Cockcroft-Walton multiplier
(six diodes), the NMOS inverter, a level-1 CMOS inverter pair, the
CE-amplifier BJT transient, and saturating_transformer.cir under
physics/trap (the live J-A commit and the physics mutual), 4 lanes each.

The CMOS pair is the hard one for both engines: neither finds its OP
(every rung diverges, with a branch current that cancels to ~1e-9 A, so
the two engines part in its seventh digit by the second iteration and
then by overflow), so it runs from rest (UIC), where every lane fails at
minstep within its first three attempts on both; the test holds that
failure lane for lane, with its 100 to 274 Newton iterations.

The bar is the standing one: ``accepted``, ``attempts``, ``fail`` and
``nr_iters`` equal per lane (the Newton counts differ between lanes), and
state, junction voltages and t_final within rtol 1e-9."""

import os

import numpy as np
import pytest

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran as jax_make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.tran import make_tran

from test_torch_run import RTOL, assert_matches, lognormal
from test_torch_run_nonlinear import BJT_TRAN, assert_jv_matches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 4


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


def cockcroft_walton(stages, tstop="2m"):
    """A half-wave Cockcroft-Walton multiplier of ``stages`` stages: 2 ×
    stages diodes and capacitors, np1 = 2·stages + 3, driven by a 100 V
    1 kHz sine into a 10 MΩ load."""
    lines = [f"* {stages}-stage half-wave Cockcroft-Walton multiplier",
             f".tran 5u {tstop}", "Vin a 0 SIN(0 100 1k)",
             "C1 a p1 100n", "D1 0 p1 DMOD", "D2 p1 s1 DMOD",
             "C2 0 s1 100n"]
    for k in range(2, stages + 1):
        lines += [f"C{2 * k - 1} p{k - 1} p{k} 100n",
                  f"D{2 * k - 1} s{k - 1} p{k} DMOD",
                  f"D{2 * k} p{k} s{k} DMOD",
                  f"C{2 * k} s{k - 1} s{k} 100n"]
    lines += [f"Rload s{stages} 0 10meg",
              ".model DMOD D (Is=1e-14 N=1.0 Cj0=2p Tt=5n)", ""]
    return "\n".join(lines)


CMOS_PAIR = """* level-1 CMOS inverter pair
.tran 1u 30u uic
Vdd vdd 0 DC 5
Vin in 0 PULSE(0 5 10u 2u 2u 30u 60u)
Mp1 mid in vdd vdd PM L=1u W=20u
Mn1 mid in 0 0 NM L=1u W=10u
C1 mid 0 5p
Mp2 out mid vdd vdd PM L=1u W=20u
Mn2 out mid 0 0 NM L=1u W=10u
C2 out 0 10p
.model NM NMOS(Level=1 VTO=0.7 KP=100u LAMBDA=0.02)
.model PM PMOS(Level=1 VTO=-0.7 KP=50u LAMBDA=0.02)
"""

SAT_SHORT = _deck("saturating_transformer.cir").replace(".tran 10u 2m",
                                                        ".tran 10u 0.5m")


def spread(deck, kinds, seed=0, lanes=LANES):
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(seed)
    return {k: {"value": lognormal(rng, cc.params[k]["value"], lanes)}
            for k in kinds if k in cc.params}


def jax_reference(deck, overrides, semantics="compat", store="none",
                  integration="be"):
    """(cfg, params as numpy, the JAX general engine's TranOutput)."""
    cc = jax_compile(jax_parse(deck))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = jax_batch_params(cc, overrides)
    fn = jax.jit(jax.vmap(jax_make_tran(
        cc, cfg, semantics=semantics, store=store,
        opts=JaxOptions(integration=integration)), in_axes=(axes, None)))
    out = fn(params, jax_init_state(cc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return cfg, params_np, out


def port_general(deck, cfg, params_np, semantics="compat", store="none",
                 integration="be"):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = make_tran(cc, cfg, semantics=semantics, store=store,
                   opts=ts.SimOptions(integration=integration))
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


CASES = {
    "cw3": (cockcroft_walton(3, "0.2m"), ("C",), "compat", "be"),
    "nmos_inverter": (_deck("nmos_inverter_tran.cir").replace(
        ".tran 1u 0.4m", ".tran 1u 0.1m"), ("R", "C"), "compat", "be"),
    "cmos_pair_uic": (CMOS_PAIR, ("C",), "compat", "be"),
    "bjt_ce_tran": (BJT_TRAN.replace(".tran 5u 2m", ".tran 5u 1m"),
                    ("R", "C"), "compat", "be"),
    "saturating_transformer_physics_trap": (SAT_SHORT, ("R",), "physics",
                                            "trap"),
}


@pytest.mark.parametrize("name", list(CASES))
def test_general_transient_matches_jax(name):
    deck, kinds, semantics, integration = CASES[name]
    cfg, params_np, ref = jax_reference(deck, spread(deck, kinds),
                                        semantics, "none", integration)
    out = port_general(deck, cfg, params_np, semantics, "none", integration)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    np.testing.assert_allclose(out.dt_final.numpy(),
                               np.asarray(ref.dt_final), rtol=RTOL)
    if name == "cmos_pair_uic":
        assert bool(out.fail.all())
    else:
        assert not bool(out.fail.any())
        assert bool((out.t_final == cfg.tstop).all())
    assert out.out_x.shape == (LANES, 1, ref.out_x.shape[-1])
    if name == "cw3":
        # the Newton counts differ from lane to lane, as they do in the
        # reference (a loop run to the slowest lane would not show it)
        assert len(set(out.nr_iters.tolist())) > 1
