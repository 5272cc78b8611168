"""Resume and checkpoints in the port on the CPU, against the JAX package.

A run to tstop/2, then a resume to tstop from its state, t_final and jv:
the port's ``make_tran_batch(resume=True)`` against the general engine's
resume flavour (``vmap(make_tran(resume=True))``, as
tests/test_checkpoint.py:102-130), on the same inputs (the JAX first leg's
state, times and junction voltages): accepted, attempts, fail, nr_iters
and t_final equal per lane, state and jv within rtol 1e-9.  Cases: an RC
driven by SIN (sources keep their phase because t is absolute),
``half_wave_rectifier.cir`` (jv carried, no OP on resume), and each lane
resumed at its own t0.  Checkpoints: a round trip through the port's
``engine/checkpoint.py``, a file the JAX package wrote loaded and resumed
by the port, and the reverse.
"""

import os

import numpy as np
import pytest
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine import checkpoint as jax_ckpt
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_run import assert_matches, lognormal
from test_torch_run_nonlinear import assert_jv_matches

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LANES = 2

RC_SIN = """* rc sine drive
.tran 0.02m 1m uic
V1 1 0 SIN(0 5 2k)
R1 1 2 1k
C1 2 0 100n
"""


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


CASES = {"rc_sin": RC_SIN,
         "half_wave_rectifier": _deck("half_wave_rectifier.cir")}

_cache = {}


def _tree_np(tree):
    return {k: {kk: np.asarray(v) for kk, v in t.items()}
            for k, t in tree.items()}


def _tree_torch(tree):
    return {k: {kk: torch.as_tensor(np.array(v, np.float64))
                for kk, v in t.items()} for k, t in tree.items()}


def case(name):
    """The JAX legs of one deck, built once: (cfg_half, cfg_full, params
    as numpy, the first leg's output, the resume callable)."""
    if name in _cache:
        return _cache[name]
    deck = CASES[name]
    cc = jax_compile(jax_parse(deck))
    tp = cc.netlist.tran
    cfg_half = jax_build_config(tp.tstart, tp.tstop / 2, tp.tstep, tp.tmax,
                                tp.uic)
    cfg_full = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax,
                                tp.uic)
    rng = np.random.default_rng(37)
    ov = {"R": {"value": lognormal(rng, cc.params["R"]["value"], LANES)}}
    params, axes = jax_batch_params(cc, ov)
    leg1 = jax.jit(jax.vmap(make_tran(cc, cfg_half, store="none"),
                            in_axes=(axes, None)))(params,
                                                   jax_init_state(cc))
    saxes = jax.tree_util.tree_map(lambda _: 0, leg1.state)
    jaxes = jax.tree_util.tree_map(lambda _: 0, leg1.jv)
    resume = jax.jit(jax.vmap(
        make_tran(cc, cfg_full, store="none", resume=True),
        in_axes=(axes, saxes, 0, jaxes)))
    _cache[name] = (cc, cfg_half, cfg_full, params, _tree_np(params), leg1,
                    resume)
    return _cache[name]


def port_resume(deck, cfg, params_np, state, t0, jv):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None, resume=True)
    assert fn.engine == "store" and "resumed" in fn.engine_reason
    assert fn.op is None  # no OP on resume
    return fn(params_from_numpy(params_np, device="cpu"), state,
              torch.as_tensor(np.array(t0)), jv)


@pytest.mark.parametrize("name", list(CASES))
def test_first_leg_matches(name):
    _, cfg_half, _, _, params_np, leg1, _ = case(name)
    cc = ts.compile_circuit(ts.parse(CASES[name]))
    out = ts.make_tran_batch(cc, cfg_half, None)(
        params_from_numpy(params_np, device="cpu"),
        ts.init_state(cc, device="cpu"))
    assert_matches(out, leg1)
    assert_jv_matches(out, leg1)


@pytest.mark.parametrize("name", list(CASES))
def test_resume_matches_general_resume(name):
    _, _, cfg_full, params, params_np, leg1, resume = case(name)
    ref = resume(params, leg1.state, leg1.t_final, leg1.jv)
    out = port_resume(CASES[name], cfg_full, params_np,
                      _tree_torch(leg1.state), leg1.t_final,
                      _tree_torch(leg1.jv))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert bool((out.t_final == cfg_full.tstop).all())


def test_per_lane_t0():
    """Each lane resumes at its own time: lane 1 a tenth of the run
    earlier, from the same committed state."""
    name = "half_wave_rectifier"
    _, _, cfg_full, params, params_np, leg1, resume = case(name)
    t0 = np.asarray(leg1.t_final) - np.array([0.0, 1e-4])
    ref = resume(params, leg1.state, t0, leg1.jv)
    out = port_resume(CASES[name], cfg_full, params_np,
                      _tree_torch(leg1.state), t0, _tree_torch(leg1.jv))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert int(out.accepted[1]) > int(out.accepted[0])


def test_resume_needs_t0_and_jv():
    _, _, cfg_full, _, params_np, leg1, _ = case("half_wave_rectifier")
    cc = ts.compile_circuit(ts.parse(CASES["half_wave_rectifier"]))
    params = params_from_numpy(params_np, device="cpu")
    state = _tree_torch(leg1.state)
    fn = ts.make_tran_batch(cc, cfg_full, None, resume=True)
    with pytest.raises(ValueError, match="t0"):
        fn(params, state)
    with pytest.raises(ValueError, match="jv0"):
        fn(params, state, 1e-3)
    with pytest.raises(ValueError, match="resume=True"):
        ts.make_tran_batch(cc, cfg_full, None)(params, state, 1e-3)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_round_trip(tmp_path):
    """A run cut short by max_attempts, saved, loaded and resumed with its
    dt and attempt count, continues the one-piece run exactly."""
    name = "half_wave_rectifier"
    _, _, cfg_full, _, params_np, _, _ = case(name)
    cc = ts.compile_circuit(ts.parse(CASES[name]))
    params = params_from_numpy(params_np, device="cpu")
    leg1 = ts.make_tran_batch(cc, cfg_full._replace(max_attempts=100),
                              None)(params, ts.init_state(cc, device="cpu"))
    assert leg1.attempts.tolist() == [100] * LANES
    path = str(tmp_path / "ckpt.npz")
    ts.save_checkpoint(path, leg1.state, jv=leg1.jv, t=leg1.t_final,
                       dt=leg1.dt_final, attempts=leg1.attempts)
    state, jv, meta = ts.load_checkpoint(path, cc, device="cpu")
    for kind in leg1.state:
        for key in leg1.state[kind]:
            assert torch.equal(state[kind][key], leg1.state[kind][key])
    for kind in leg1.jv:
        for key in leg1.jv[kind]:
            assert torch.equal(jv[kind][key], leg1.jv[kind][key])
    fn = ts.make_tran_batch(cc, cfg_full, None, resume=True)
    rest = fn(params, state, meta["t"], jv, meta["dt"], meta["attempts"])
    whole = ts.make_tran_batch(cc, cfg_full, None)(
        params, ts.init_state(cc, device="cpu"))
    for key in ("attempts", "fail", "t_final", "dt_final"):
        assert torch.equal(getattr(rest, key), getattr(whole, key)), key
    assert torch.equal(rest.accepted + leg1.accepted, whole.accepted)
    assert torch.equal(rest.nr_iters + leg1.nr_iters, whole.nr_iters)
    for kind in whole.state:
        for key in whole.state[kind]:
            assert torch.equal(rest.state[kind][key],
                               whole.state[kind][key]), f"{kind}.{key}"
    assert torch.equal(rest.jv["D"]["vd"], whole.jv["D"]["vd"])


def test_checkpoint_validation(tmp_path):
    cc = ts.compile_circuit(ts.parse(RC_SIN))
    state = ts.init_state(cc, device="cpu")
    path = str(tmp_path / "bad.npz")
    ts.save_checkpoint(path, {k: v for k, v in state.items() if k != "C"})
    with pytest.raises(ValueError, match="missing"):
        ts.load_checkpoint(path, cc)
    old = {"C": {k: v for k, v in state["C"].items() if k != "hist"}}
    ts.save_checkpoint(path, old)
    with pytest.raises(ValueError, match="fill_missing"):
        ts.load_checkpoint(path, cc)
    loaded, jv, _ = ts.load_checkpoint(path, cc, fill_missing=True)
    assert jv is None
    assert not loaded["C"]["hist"].any()


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    name = "half_wave_rectifier"
    _, _, cfg_full, params, params_np, leg1, resume = case(name)
    path = str(tmp_path / "jax.npz")
    jax_ckpt.save_checkpoint(path, leg1.state, jv=leg1.jv, t=leg1.t_final)
    ref = resume(params, leg1.state, leg1.t_final, leg1.jv)
    cc = ts.compile_circuit(ts.parse(CASES[name]))
    state, jv, meta = ts.load_checkpoint(path, cc, device="cpu")
    out = port_resume(CASES[name], cfg_full, params_np, state, meta["t"], jv)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    name = "rc_sin"
    jcc, cfg_half, cfg_full, params, params_np, _, resume = case(name)
    cc = ts.compile_circuit(ts.parse(CASES[name]))
    tparams = params_from_numpy(params_np, device="cpu")
    leg1 = ts.make_tran_batch(cc, cfg_half, None)(
        tparams, ts.init_state(cc, device="cpu"))
    path = str(tmp_path / "port.npz")
    ts.save_checkpoint(path, leg1.state, jv=leg1.jv, t=leg1.t_final)
    state, jv, meta = jax_ckpt.load_checkpoint(path, jcc)
    assert jv is None  # a linear deck carries no junction voltages
    ref = resume(params, state, meta["t"], {})
    out = ts.make_tran_batch(cc, cfg_full, None, resume=True)(
        tparams, leg1.state, leg1.t_final, leg1.jv)
    assert_matches(out, ref)
