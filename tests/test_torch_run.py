"""The port's whole-run transient on the CPU (ops/run.py's plain version,
the arithmetic of csrc/run_kernel.cu) against the JAX package's general
engine (engine/tran.py ``make_tran``, f64, the semantic reference).

The bar is the one tests/test_run_kernel.py sets for the TPU kernel:
``accepted``, ``attempts`` and ``fail`` equal per lane, and state and
t_final within rtol 1e-9 (both sides are f64 and differ only in the order
of a few roundings).  Inputs are made with numpy from a seed and handed to
both packages."""

import numpy as np
import pytest
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.ops import run, run_plan

RTOL = 1e-9

RC_SIN = """* rc sin
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

RL_PULSE = """* rl pulse
.tran 0.02m 1m
Vin 1 0 PULSE(0 5 0.1m 0.01m 0.01m 0.3m 0.8m)
R1 1 2 50
L1 2 0 10m
"""

IPWL = """* isrc pwl into rc ladder
.tran 0.02m 1m
I1 0 1 PWL(0 0 0.2m 3m 0.5m 1m)
R1 1 0 1k
C1 1 0 0.2u
C2 1 2 0.1u
R2 2 0 2k
"""

# a floating capacitor chain: node 2 has only capacitors, so a lane with
# both capacitors at 0 has an all-zero row (a zero pivot)
CSERIES = """* capacitor chain
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 0 1k
C1 1 2 1u
C2 2 0 1u
"""


def lognormal(rng, base, b, spread=0.1):
    base = np.asarray(base)
    return base[None] * np.exp(rng.normal(0.0, spread, (b,) + base.shape))


def reference(deck, overrides, cfg_edit=None):
    """The JAX general engine on the deck; returns (cc, cfg, params, out)."""
    cc = jax_compile(jax_parse(deck))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    if cfg_edit:
        cfg = cfg._replace(**cfg_edit)
    params, axes = jax_batch_params(cc, overrides)
    fn = jax.jit(jax.vmap(make_tran(cc, cfg, store="none"),
                          in_axes=(axes, None)))
    out = fn(params, jax_init_state(cc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return cfg, axes, params_np, out


def assert_matches(out, ref):
    np.testing.assert_array_equal(out.accepted.numpy(),
                                  np.asarray(ref.accepted))
    np.testing.assert_array_equal(out.attempts.numpy(),
                                  np.asarray(ref.attempts))
    np.testing.assert_array_equal(out.fail.numpy(), np.asarray(ref.fail))
    np.testing.assert_array_equal(out.nr_iters.numpy(),
                                  np.asarray(ref.nr_iters))
    np.testing.assert_allclose(out.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=RTOL, atol=0)
    assert set(out.state) == set(ref.state)
    for kind in ref.state:
        assert set(out.state[kind]) == set(ref.state[kind])
        for key in ref.state[kind]:
            a = np.asarray(ref.state[kind][key])
            f = out.state[kind][key].numpy()
            assert f.shape == a.shape, f"{kind}.{key}"
            scale = max(1e-300, float(np.max(np.abs(a))))
            np.testing.assert_allclose(f, a, rtol=RTOL, atol=RTOL * scale,
                                       err_msg=f"{kind}.{key}")


def port_run(deck, cfg, params_np):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = run.make_tran_run(cc, cfg)
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


@pytest.mark.parametrize("deck,kinds,lanes", [
    (RC_SIN, ("R", "C"), 8),
    (RL_PULSE, ("R", "L"), 4),
    (IPWL, ("R", "C"), 8),
], ids=["rc_sin", "rl_pulse", "ipwl_ladder"])
def test_plain_matches_general_engine(deck, kinds, lanes):
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(11)
    ov = {k: {"value": lognormal(rng, cc.params[k]["value"], lanes)}
          for k in kinds}
    cfg, _, params_np, ref = reference(deck, ov)
    out = port_run(deck, cfg, params_np)
    assert_matches(out, ref)
    assert not out.fail.any()


def test_plain_matches_on_batched_pwl_and_source_params():
    """Per-lane PWL knot values and per-lane SIN parameters."""
    rng = np.random.default_rng(5)
    lanes = 6
    cc = jax_compile(jax_parse(IPWL))
    ov = {"I": {"pwl_v": lognormal(rng, cc.params["I"]["pwl_v"], lanes),
                "pwl_t": np.broadcast_to(cc.params["I"]["pwl_t"],
                                         (lanes,) + cc.params["I"]["pwl_t"]
                                         .shape).copy()},
          "C": {"value": lognormal(rng, cc.params["C"]["value"], lanes)}}
    cfg, _, params_np, ref = reference(IPWL, ov)
    assert_matches(port_run(IPWL, cfg, params_np), ref)

    cc = jax_compile(jax_parse(RC_SIN))
    ov = {"V": {"freq": lognormal(rng, cc.params["V"]["freq"], lanes),
                "phase": rng.uniform(-90, 90, (lanes, 1))}}
    cfg, _, params_np, ref = reference(RC_SIN, ov)
    assert_matches(port_run(RC_SIN, cfg, params_np), ref)


def test_zero_pivot_lane_fails_without_hanging():
    cc = jax_compile(jax_parse(CSERIES))
    c = np.tile(np.asarray(cc.params["C"]["value"]), (4, 1))
    c[1] = 0.0  # lane 1: node 2's row is all zero
    cfg, _, params_np, ref = reference(CSERIES, {"C": {"value": c}})
    out = port_run(CSERIES, cfg, params_np)
    assert_matches(out, ref)
    assert out.fail.tolist() == [False, True, False, False]
    # halved from minstep until dt <= minstep, then the hard fail
    assert int(out.attempts[1]) < 64
    assert int(out.accepted[1]) == 0


def _rl_inputs(lanes=2):
    cc = ts.compile_circuit(ts.parse(RL_PULSE))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(2)
    params, _ = ts.batch_params(cc, {"R": {"value": lognormal(
        rng, cc.params["R"]["value"], lanes)}}, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, lanes, "cpu")
    src = run_plan.source_stack(plan, params, lanes, "cpu")
    st = run_plan.init_state_stack(plan, state0, lanes, "cpu")
    return cfg, plan, dev, src, st


def test_max_attempts_guard_ends_every_lane():
    cfg, plan, dev, src, st = _rl_inputs()
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0, 300)
    res = run.run_plain(plan, dev, src, st, sc)
    assert res.attempts.tolist() == [300, 300]
    assert not res.fail.any()
    assert bool((res.t < cfg.tstop).all())


def test_non_finite_dt_ends_the_lane_as_failed():
    cfg, plan, dev, src, st = _rl_inputs()
    sc = run.RunScalars(cfg.tstop, float("nan"), cfg.tmax, 7.0,
                        cfg.max_attempts)
    res = run.run_plain(plan, dev, src, st, sc)
    assert res.fail.tolist() == [1, 1]
    assert res.attempts.tolist() == [0, 0]


def test_zero_tstop_is_done_at_once():
    cfg, plan, dev, src, st = _rl_inputs()
    sc = run.RunScalars(0.0, cfg.minstep, cfg.tmax, 7.0, cfg.max_attempts)
    res = run.run_plain(plan, dev, src, st, sc)
    assert res.attempts.tolist() == [0, 0]
    assert res.fail.tolist() == [0, 0]
    assert torch.equal(res.state, st)


def test_cpu_tensors_take_the_plain_version():
    cfg, plan, dev, src, st = _rl_inputs()
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0, 200)
    before = run.launch_run_kernel.launches
    got = run.run_lanes(plan, dev, src, st, sc)
    want = run.run_plain(plan, dev, src, st, sc)
    assert run.launch_run_kernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        run.launch_run_kernel(plan, dev, src, st, sc)


def test_wrapper_checks_dtype_and_shape():
    cfg, plan, dev, src, st = _rl_inputs()
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0, 10)
    with pytest.raises(TypeError, match="float64"):
        run.run_lanes(plan, dev.float(), src, st, sc)
    with pytest.raises(ValueError, match="must be"):
        run.run_lanes(plan, dev, src[:, :1], st, sc)
