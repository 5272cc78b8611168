"""More of the port's magnetic transient on the CPU against the JAX
package's general engine (``vmap(make_tran)``):

* the LM + diode deck (TRANS_SMALL with a half-wave rectifier on its
  secondary) under compat and physics/trap: the OP kernel's plain version
  with the windings' +1e-3 branch diagonal, then the Newton MAG
  instantiations' plain version; the bar of
  tests/test_torch_physics_run.py;
* a magnetised-core start under physics/be (each lane's own nonzero J-A
  core, as a run resumed from a checkpoint carries it) with
  ``store='full'``: the counters and state at that bar, ``out_n`` equal
  and the waveform within rtol 1e-9 of its scale;
* a physics/trap run of the saturating transformer resumed from a
  checkpoint at half its attempts, equal bit for bit to the one-piece run;
* a linear primary coupled to a saturating secondary (the inline deck of
  tests/test_torch_magnetic.py) under physics/trap past its first 2 us
  (tests/test_torch_physics_magnetic.py holds those at the bar), where
  its state is rounding-bound: see
  ``test_linear_primary_is_rounding_bound``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_magnetic import LINEAR_PRIMARY, magnetised_state
from test_torch_physics_magnetic_op import LM_DIODE, SAT
from test_torch_physics_run import (COUNTERS, RTOL, assert_physics_matches,
                                    port, reference, spread)

TRAP = ts.SimOptions(integration="trap")


@pytest.mark.parametrize("semantics,integration",
                         [("compat", "be"), ("physics", "trap")])
def test_lm_diode_transient_matches_general_engine(semantics, integration):
    cc = jax_compile(jax_parse(LM_DIODE))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = jax_batch_params(cc, spread(LM_DIODE, ("R",)))
    ref = jax.jit(jax.vmap(make_tran(
        cc, cfg, semantics=semantics, store="none",
        opts=JaxOptions(integration=integration)), in_axes=(axes, None)))(
        params, jax_init_state(cc))
    pcc = ts.compile_circuit(ts.parse(LM_DIODE))
    fn = ts.make_tran_batch(pcc, cfg, None, semantics=semantics,
                            opts=ts.SimOptions(integration=integration))
    assert fn.engine == "run" and fn.op is not None  # the OP kernel first
    out = fn(params_from_numpy({k: {kk: np.asarray(v) for kk, v in t.items()}
                                for k, t in params.items()}, device="cpu"),
             ts.init_state(pcc, device="cpu"))
    assert_physics_matches(out, ref, cfg)
    assert not bool(out.fail.any())
    assert bool((out.nr_iters > out.attempts).all())  # Newton ran
    if semantics == "compat":  # compat freezes the core
        assert not bool(out.state["LM"]["M"].any())


def test_magnetised_core_physics_matches_general_engine():
    b = 4
    cc = jax_compile(jax_parse(SAT))
    rng = np.random.default_rng(31)
    ov = {"R": {"value": np.asarray(cc.params["R"]["value"])[None]
                * np.exp(rng.normal(0.0, 0.1, (b, 2)))}}
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    cfg = cfg._replace(tstop=5e-4)
    params, axes = jax_batch_params(cc, ov)
    lm = magnetised_state({k: np.asarray(v)
                           for k, v in cc.params["LM"].items()}, rng, b)
    state0 = jax_init_state(cc)
    state0["LM"] = {k: jnp.asarray(v) for k, v in lm.items()}
    in_state = {k: (0 if k == "LM" else None) for k in state0}
    ref = jax.jit(jax.vmap(make_tran(cc, cfg, semantics="physics",
                                     store="full"),
                           in_axes=(axes, in_state)))(params, state0)

    pcc = ts.compile_circuit(ts.parse(SAT))
    pstate0 = ts.init_state(pcc, device="cpu")
    pstate0["LM"] = {k: torch.tensor(v) for k, v in lm.items()}
    fn = ts.make_tran_batch(pcc, cfg, None, semantics="physics",
                            store="full")
    assert fn.engine == "store"
    out = fn(params_from_numpy({k: {kk: np.asarray(v) for kk, v in t.items()}
                                for k, t in params.items()}, device="cpu"),
             pstate0)
    assert_physics_matches(out, ref, cfg)
    assert not bool(out.fail.any())
    np.testing.assert_array_equal(out.out_n.numpy(), np.asarray(ref.out_n))
    n = int(out.out_n.max())
    for key in ("out_x", "out_t"):
        a = np.asarray(getattr(ref, key))[:, :n]
        np.testing.assert_allclose(getattr(out, key)[:, :n].numpy(), a,
                                   rtol=RTOL,
                                   atol=RTOL * float(np.abs(a).max()),
                                   err_msg=key)


def test_physics_magnetic_resume_is_the_one_piece_run():
    cc = ts.compile_circuit(ts.parse(SAT))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, spread(SAT, ("R",), lanes=3, seed=8),
                                device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    whole = ts.make_tran_batch(cc, cfg, None, semantics="physics",
                               opts=TRAP)(params, state0)
    half = int(whole.attempts.min()) // 2
    leg1 = ts.make_tran_batch(cc, cfg._replace(max_attempts=half), None,
                              semantics="physics", opts=TRAP)(params, state0)
    fn = ts.make_tran_batch(cc, cfg, None, semantics="physics", opts=TRAP,
                            resume=True)
    assert fn.engine == "store" and fn.op is None
    rest = fn(params, leg1.state, leg1.t_final, leg1.jv, leg1.dt_final,
              leg1.attempts)
    assert torch.equal(rest.attempts, whole.attempts)
    assert torch.equal(leg1.accepted + rest.accepted, whole.accepted)
    assert torch.equal(rest.t_final, whole.t_final)
    for kind in whole.state:
        for key in whole.state[kind]:
            assert torch.equal(rest.state[kind][key],
                               whole.state[kind][key]), (kind, key)
    # the checkpoint carried a moving core
    assert not torch.equal(leg1.state["LM"]["M"], whole.state["LM"]["M"])


def test_linear_primary_is_rounding_bound():
    """A linear primary coupled to a saturating secondary whose small
    current keeps its core near H = 0: there consecutive steps' dH are
    small against M, so J-A's difference quotient dMdH = (m_new - M)/dH
    (models/magnetic.py ja_step, engine/state.py's commit) multiplies the
    rounding of m_new - M, and the next step's inductance L0·(1 + dMdH)
    feeds it back.  Rounding differences of 1e-17 grow to 1e-9 within
    ~50-150 accepted steps and to ~0.1 of the state by 0.1 ms, in the
    general engine itself: R moved by one ulp moves its LM state by as
    much as the port does.  So this case holds the counters (step control
    reads C and L only, and the linear L's LTE stays below trtol) and
    t_final at the bar, and each state leaf to four times the general
    engine's own spread under a one-ulp change of R, plus the bar."""
    deck = LINEAR_PRIMARY
    edit = {"tstop": 1e-4}
    ov = spread(deck, ("R",))
    cfg, params_np, ref = reference(deck, ov, "trap", cfg_edit=edit)
    ulp = {"R": {"value": ov["R"]["value"] * (1.0 + np.finfo(float).eps)}}
    _, _, ref_ulp = reference(deck, ulp, "trap", cfg_edit=edit)
    out = port(deck, cfg, params_np, "trap")
    np.testing.assert_allclose(out.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=RTOL, atol=0)
    for key in COUNTERS:
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    spread_lm = 0.0
    for kind in ref.state:
        for key in ref.state[kind]:
            a = np.asarray(ref.state[kind][key])
            scale = max(float(np.abs(a).max()), 1e-300)
            own = float(np.abs(np.asarray(ref_ulp.state[kind][key]) - a)
                        .max()) / scale
            got = float(np.abs(out.state[kind][key].numpy() - a).max()) \
                / scale
            assert got <= 4.0 * own + RTOL, (kind, key, got, own)
            if kind == "LM":
                spread_lm = max(spread_lm, own)
    assert spread_lm > 1e-3  # the reference's own rounding-bound spread
