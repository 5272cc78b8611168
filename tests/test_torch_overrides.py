"""The JAX package's engine overrides on the port, on the CPU.

For each value of ``TOYSPICE_TRAN``, ``TOYSPICE_TRAN_RUN``, ``TOYSPICE_OP``,
``TOYSPICE_AC``, ``TOYSPICE_SOLVER`` and ``TOYSPICE_TRAN_IMPL``, the port
picks the engine the JAX package picks under the same setting, and its
results stay within rtol 1e-9 (atol 1e-12) of the JAX package's f64
general engine on the same numpy inputs.

Two names differ by design: the JAX package's "fused" transient (the
attempt-loop kernel) is the port's "store" instantiation, and the port
names "linear" the general engine's OP of a linear deck, which the JAX
package calls "general".  The port's ``TOYSPICE_SOLVER=auto`` means the
kernels on the card, which is the JAX package's "pallas" on its TPU: the
JAX side's names are taken under "pallas" for it.  The JAX package's
kernels do not run on a CPU, so its results come from its general
engine, the semantic reference it holds them to.
"""

import os

import numpy as np
import pytest
import torch

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine import batch as jax_batch
from toyspice_tpu.engine.ac import make_ac_batch as jax_make_ac_batch
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine import batch as port_batch
from toyspice_tpu_torch.engine import overrides
from toyspice_tpu_torch.engine.ac import make_ac_batch as port_make_ac_batch
from toyspice_tpu_torch.ops import run, solve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-9, 1e-12
LANES = 4
ENV = ("TOYSPICE_TRAN", "TOYSPICE_TRAN_RUN", "TOYSPICE_OP", "TOYSPICE_AC",
       "TOYSPICE_SOLVER", "TOYSPICE_TRAN_IMPL")
PORT_NAMES = {"store": "fused", "linear": "general"}


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


def _setting(monkeypatch, env):
    for key in ENV:
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)


def _jax_setting(monkeypatch, env):
    """The same setting for the JAX package: the port's "auto" solver is
    its "pallas" (the kernels on the card)."""
    jenv = dict(env)
    if jenv.get("TOYSPICE_SOLVER", "auto") == "auto":
        jenv["TOYSPICE_SOLVER"] = "pallas"
    _setting(monkeypatch, jenv)


def _inputs(name, b=LANES):
    deck = _deck(name)
    jcc = jax_compile(jax_parse(deck))
    r = np.asarray(jcc.params["R"]["value"])
    rng = np.random.default_rng(7)
    over = {"R": {"value": r[None] * np.exp(rng.normal(0, 0.1,
                                                        (b, len(r))))}}
    params, axes = jax_batch.batch_params(jcc, over)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pcc = ts.compile_circuit(ts.parse(deck))
    return jcc, params, axes, pcc, params_from_numpy(params_np,
                                                     device="cpu")


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


# ------------------------------------------------------------ transient

TRAN_SETTINGS = [{}, {"TOYSPICE_TRAN": "general"},
                 {"TOYSPICE_TRAN": "fused"}, {"TOYSPICE_TRAN": "auto"},
                 {"TOYSPICE_TRAN_RUN": "off"}, {"TOYSPICE_SOLVER": "xla"},
                 {"TOYSPICE_SOLVER": "xla", "TOYSPICE_TRAN": "fused"},
                 {"TOYSPICE_SOLVER": "pallas"},
                 {"TOYSPICE_TRAN_IMPL": "xla"}]
_tran_ref = {}


def _tran_reference(name, monkeypatch):
    if name not in _tran_ref:
        jcc, params, axes, pcc, pparams = _inputs(name)
        tp = jcc.netlist.tran
        cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax,
                               tp.uic)
        _setting(monkeypatch, {"TOYSPICE_TRAN": "general",
                               "TOYSPICE_SOLVER": "xla"})
        out = jax_batch.run_transient_batch(jcc, cfg, params, axes,
                                            jax_init_state(jcc))
        _tran_ref[name] = (jcc, cfg, axes, pcc, pparams, out)
    return _tran_ref[name]


@pytest.mark.parametrize("name", ["rc_lowpass_tran.cir",
                                  "half_wave_rectifier.cir"])
@pytest.mark.parametrize("env", TRAN_SETTINGS,
                         ids=lambda e: ",".join(f"{k[9:]}={v}" for k, v in
                                                e.items()) or "unset")
def test_tran_override(name, env, monkeypatch):
    jcc, jcfg, axes, pcc, pparams, ref = _tran_reference(name, monkeypatch)
    _jax_setting(monkeypatch, env)
    jname, _, _ = jax_batch.select_tran_engine(jcc, jcfg, axes)
    _setting(monkeypatch, env)
    tp = pcc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    fn = port_batch.make_tran_batch(pcc, cfg, axes)
    assert PORT_NAMES.get(fn.engine, fn.engine) == jname, fn.engine_reason
    out = fn(pparams, ts.init_state(pcc, device="cpu"))
    for key in ("accepted", "attempts", "fail"):
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)))
    _close(out.t_final.numpy(), ref.t_final)
    for kind, tbl in ref.state.items():
        for key, leaf in tbl.items():
            _close(out.state[kind][key].numpy(), leaf)


# ------------------------------------------------------------ OP and DC

OP_SETTINGS = [{}, {"TOYSPICE_OP": "general"}, {"TOYSPICE_OP": "fused"},
               {"TOYSPICE_SOLVER": "xla"},
               {"TOYSPICE_SOLVER": "xla", "TOYSPICE_OP": "fused"},
               {"TOYSPICE_TRAN_IMPL": "xla"}]
_op_ref = {}


@pytest.mark.parametrize("name", ["ce_amplifier_op.cir", "divider_op.cir"])
@pytest.mark.parametrize("env", OP_SETTINGS,
                         ids=lambda e: ",".join(f"{k[9:]}={v}" for k, v in
                                                e.items()) or "unset")
def test_op_override(name, env, monkeypatch):
    jcc, params, axes, pcc, pparams = _inputs(name)
    if name not in _op_ref:
        _setting(monkeypatch, {"TOYSPICE_OP": "general",
                               "TOYSPICE_SOLVER": "xla"})
        _op_ref[name] = jax_batch.run_op_batch(jcc, params, axes)
    ref = _op_ref[name]
    _jax_setting(monkeypatch, env)
    jname, _ = jax_batch.select_op_engine(jcc)
    _setting(monkeypatch, env)
    pname, reason = port_batch.select_op_engine(pcc)
    assert PORT_NAMES.get(pname, pname) == jname, reason
    out = ts.run_op_batch(pcc, pparams)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    _close(out.x.numpy(), ref.x)


@pytest.mark.parametrize("env", [{}, {"TOYSPICE_OP": "general"},
                                 {"TOYSPICE_SOLVER": "xla"}],
                         ids=["unset", "OP=general", "SOLVER=xla"])
def test_dc_override(env, monkeypatch):
    jcc, params, axes, pcc, pparams = _inputs("diode_iv_sweep.cir")
    dp = jcc.netlist.dc
    pts = np.asarray(ts.sweep_values(dp.start1, dp.stop1, dp.increment1))
    slot = (jcc.names["V"].index(dp.source1),)
    if "dc" not in _op_ref:
        _setting(monkeypatch, {"TOYSPICE_OP": "general",
                               "TOYSPICE_SOLVER": "xla"})
        _op_ref["dc"] = jax_batch.run_dc_batch(jcc, slot, params, axes, pts)
    xs_ref, conv_ref = _op_ref["dc"]
    _jax_setting(monkeypatch, env)
    jname, _ = jax_batch.select_op_engine(jcc)
    _setting(monkeypatch, env)
    pname, _ = port_batch.select_op_engine(pcc)
    assert pname == jname
    xs, conv = ts.run_dc_batch(pcc, slot, pparams, points=pts)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    _close(xs.numpy(), xs_ref)


# ------------------------------------------------------------------- AC

AC_SETTINGS = [{}, {"TOYSPICE_AC": "general"}, {"TOYSPICE_AC": "fused"},
               {"TOYSPICE_OP": "general"},
               {"TOYSPICE_AC": "general", "TOYSPICE_OP": "general"},
               {"TOYSPICE_SOLVER": "xla"},
               {"TOYSPICE_SOLVER": "xla", "TOYSPICE_AC": "fused"},
               {"TOYSPICE_TRAN_IMPL": "xla"}]


def _jax_ac_paths(fn):
    """(fused bias, fused solve) of the JAX package's make_ac_batch."""
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return (cells["fused_bias"].cell_contents,
            cells["fused_solve"].cell_contents)


@pytest.mark.parametrize("env", AC_SETTINGS,
                         ids=lambda e: ",".join(f"{k[9:]}={v}" for k, v in
                                                e.items()) or "unset")
def test_ac_override(env, monkeypatch):
    jcc, params, axes, pcc, pparams = _inputs("ce_amplifier_ac.cir")
    ap = jcc.netlist.ac
    freqs = ts.frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    if "ac" not in _op_ref:
        _setting(monkeypatch, {"TOYSPICE_OP": "general",
                               "TOYSPICE_AC": "general",
                               "TOYSPICE_SOLVER": "xla"})
        _op_ref["ac"] = jax_batch.run_ac_batch(jcc, params, axes, freqs)
    xr_ref, xi_ref, _ = _op_ref["ac"]
    _jax_setting(monkeypatch, env)
    bias, fused = _jax_ac_paths(jax_make_ac_batch(jcc, axes))
    _setting(monkeypatch, env)
    fn = port_make_ac_batch(pcc, axes)
    assert (fn.bias_engine == "fused", fn.engine == "fused") == (
        bias, fused), fn.engine_reason
    xr, xi, _ = fn(pparams, ts.init_state(pcc, device="cpu"), freqs)
    scale = max(np.abs(np.asarray(xr_ref)).max(),
                np.abs(np.asarray(xi_ref)).max())
    for got, want in ((xr, xr_ref), (xi, xi_ref)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL + RTOL * scale)


# --------------------------------------------------- kernel or plain


@pytest.mark.parametrize("env,chosen", [
    ({}, {}), ({"TOYSPICE_SOLVER": "auto"}, {}),
    ({"TOYSPICE_SOLVER": "xla"}, "plain"),
    ({"TOYSPICE_SOLVER": "pallas"}, "raises")],
    ids=["unset", "auto", "xla", "pallas"])
def test_solver_backend_dispatch(env, chosen, monkeypatch):
    """The wrappers read no override: on a CPU tensor the dense solve runs
    its plain version under every setting.  The setting chooses the solves
    an engine is built with: none under auto (the wrappers' choice), the
    plain versions under xla, the kernels alone under pallas, which refuse
    a CPU tensor."""
    _setting(monkeypatch, env)
    assert overrides.solver_backend() == env.get("TOYSPICE_SOLVER", "auto")
    a = torch.eye(3, dtype=torch.float64)[None] * 2.0
    b = torch.ones(1, 3, dtype=torch.float64)
    before = solve.launch_gj.launches
    np.testing.assert_array_equal(solve.linear_solve(a, b).numpy(),
                                  solve.gj_plain(a, b).numpy())
    assert solve.launch_gj.launches == before
    kw = overrides.solves()
    if chosen == {}:
        assert kw == {}
    elif chosen == "plain":
        np.testing.assert_array_equal(kw["dense_solve"](a, b).numpy(),
                                      solve.gj_plain(a, b).numpy())
    else:
        with pytest.raises(ValueError, match="does not run on cpu"):
            kw["dense_solve"](a, b)
        with pytest.raises(ValueError, match="TOYSPICE_SOLVER=pallas"):
            ts.run_analysis(_deck("divider_op.cir"), device="cpu")
    assert solve.launch_gj.launches == before


@pytest.mark.parametrize("impl,plain", [(None, False), ("kernel", False),
                                        ("xla", True)])
def test_tran_impl_dispatch(impl, plain, monkeypatch):
    """TOYSPICE_TRAN_IMPL=xla builds the transient on the kernels' plain
    versions and says so in the engine's reason; the wrappers it no longer
    calls are the ones that launch on the card."""
    _setting(monkeypatch, {} if impl is None else
             {"TOYSPICE_TRAN_IMPL": impl})
    assert overrides.kernels_plain() is plain
    calls = []

    def spy(*args, **kw):
        calls.append(1)
        return run.store_plain(*args, **kw)

    monkeypatch.setattr(run, "store_lanes", spy)
    cc = ts.compile_circuit(ts.parse(_deck("rc_lowpass_tran.cir")))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    fn = port_batch.make_tran_batch(cc, cfg, None, store="full")
    assert fn.engine == "store"
    assert ("TOYSPICE_TRAN_IMPL=xla" in fn.engine_reason) is plain
    fn(ts.batch_params(cc, {}, device="cpu")[0],
       ts.init_state(cc, device="cpu"))
    assert calls == ([] if plain else [1])
    # the dense and stamped solves follow TOYSPICE_SOLVER, not this switch
    assert overrides.solves() == {}


def test_single_instance_api_under_solver_xla(monkeypatch):
    """run_analysis takes the plain versions under TOYSPICE_SOLVER=xla, as
    on the CPU by default: the same Results bit for bit."""
    deck = _deck("half_wave_rectifier.cir")
    _setting(monkeypatch, {})
    auto = ts.run_analysis(deck, device="cpu")
    _setting(monkeypatch, {"TOYSPICE_SOLVER": "xla"})
    xla = ts.run_analysis(deck, device="cpu")
    assert set(auto) == set(xla)
    for key in auto:
        np.testing.assert_array_equal(auto[key], xla[key])
