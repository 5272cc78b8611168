"""The port's magnetic pieces on the CPU against the JAX package.

* ``models/magnetic.py``: ``ja_calculate``, ``l_zero``, ``l_effective`` and
  ``value_for_mutual`` on seeded core states away from and near the
  reference's guards (|dH| < 1e-12, |He| < 1e-6, the Langevin series below
  |x| = 0.25, the ±1e-12 denominator clamp, the ±1e6 and ±1e3 clips),
  within rtol 1e-12.  With a Curie temperature (tc > 0) Ms scales by
  ((tc - T)/tc)**beta, and XLA's f64 pow differs from the C library's
  (torch.pow) by an ulp on about 2% of inputs; dMdH is a difference
  quotient (m_new - M)/dH, which carries that ulp to 1.4e-12 of L_eff on
  one of these 256 states, so that case is held to 1e-11.
* The compat transient of ``circuits/coupled_inductors.cir`` (a linear
  transformer: K between two L) and ``circuits/saturating_transformer.cir``
  (two LM windings on a Jiles-Atherton core and their K), 4 lanes with R
  spread from ``default_rng``, ``store='none'``, through ``make_tran_batch``
  (the plain version of the whole-run kernel's magnetic instantiation)
  against the general engine (``vmap(make_tran)``): accepted, attempts,
  fail, nr_iters and t_final equal per lane, state within 1e-9 — the bar of
  tests/test_torch_run_nonlinear.py.  The linear transformer's compat
  inductor LTE paces every lane near minstep (23,656 attempts over its
  1.5 ms), so its run stops at 0.3 ms to keep the plain version's CPU time
  small; the saturating transformer runs its whole 2 ms.
* The same with a magnetised core: each lane starts from its own nonzero
  LM state (the Jiles-Atherton core after a current ramp, with frozen i0
  and i1), as a run resumed from a physics-mode checkpoint does.  Compat
  freezes that state, so L_eff differs from L0, the LM branch uses L_eff
  once t >= dt, its RHS reads the frozen i1 and each K reads an LM
  partner's frozen i0 (and a linear partner's live one, on an inline deck
  with a linear primary and a saturating secondary, run to 0.1 ms).
  ``store='full'`` against ``vmap(make_tran(store='full'))``: the same
  counters and state bar, ``out_n`` equal, ``out_x``/``out_t`` within
  rtol 1e-9 — the waveform is what the frozen core changes, since compat
  step control reads C and L only.
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.models import magnetic as jax_mag
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.models import magnetic
from toyspice_tpu_torch.ops import run_plan

from test_torch_run import RTOL, assert_matches, lognormal, reference

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_MODEL = 1e-12
TEMP = 300.15
KEYS = ("H", "Hold", "M", "Mirr", "dMdH")


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# each case's stop time (None: the deck's own)
DECKS = {"coupled_inductors": ("coupled_inductors.cir", 3e-4),
         "saturating_transformer": ("saturating_transformer.cir", None)}


def _core_params(rng, n, tc=0.0):
    """saturating_transformer.cir's core with every leaf spread, and
    ``tc`` (> 0 turns on the temperature scaling of Ms)."""
    def spread(v):
        return v * np.exp(rng.normal(0.0, 0.2, n))

    return {"turns": spread(120.0), "ms": spread(1.5e6),
            "alpha": spread(1.2e-3), "a": spread(900.0), "c": spread(0.18),
            "k": spread(450.0), "area": spread(1.1e-4), "len": spread(0.08),
            "tc": np.full(n, tc), "beta": spread(0.4)}


def _core_states(rng, n, alpha):
    """Core states and currents that hit each guard: column blocks of
    ordinary states, |dH| < 1e-12, |He| < 1e-6 (the linear anhysteretic),
    |x| < 0.25 (the Langevin series), a denominator near 0, H past the
    ±1e6 clip, and dMdH past ±1e3."""
    st = {k: rng.normal(0.0, 1.0, n) * s for k, s in
          (("H", 200.0), ("Hold", 200.0), ("M", 1e5), ("Mirr", 1e5),
           ("dMdH", 50.0))}
    i0 = rng.normal(0.0, 1.0, n)
    h = rng.normal(0.0, 300.0, n)
    q = n // 8
    st["Hold"][q:2 * q] = h[q:2 * q] + rng.uniform(-5e-13, 5e-13, q)
    st["M"][2 * q:3 * q] = (-h[2 * q:3 * q] / alpha[2 * q:3 * q]
                            + rng.uniform(-1e-4, 1e-4, q))
    h[3 * q:4 * q] = rng.uniform(-100.0, 100.0, q)
    st["M"][3 * q:4 * q] = rng.uniform(-1e4, 1e4, q)
    st["Mirr"][4 * q:5 * q] = 1e9  # -alpha·(man - Mirr) swamps k
    i0[5 * q:6 * q] = rng.choice([-1.0, 1.0], q) * rng.uniform(1e3, 1e5, q)
    st["dMdH"][6 * q:7 * q] = rng.choice([-1.0, 1.0], q) * 5e3
    return st, i0, h


def _close(got, want, what, rtol=RTOL_MODEL):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * 1e-300,
                               err_msg=what)


@pytest.mark.parametrize("tc,rtol", [(0.0, RTOL_MODEL), (600.0, 1e-11)],
                         ids=["ms", "ms_of_temp"])
def test_magnetic_model_matches_jax(tc, rtol):
    rng = np.random.default_rng(21)
    n = 256
    p = _core_params(rng, n, tc)
    st, i0, h = _core_states(rng, n, p["alpha"])
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.as_tensor(v) for k, v in p.items()}
    jst = jax_mag.CoreState(*(jnp.asarray(st[k]) for k in KEYS))
    tst = magnetic.CoreState(*(torch.as_tensor(st[k]) for k in KEYS))

    jm, jd, jnew = jax_mag.ja_calculate(jp, jst, jnp.asarray(h), TEMP)
    tm, td, tnew = magnetic.ja_calculate(tp, tst, torch.as_tensor(h), TEMP)
    _close(tm, jm, "M", rtol)
    _close(td, jd, "dMdH", rtol)
    for k, a, b in zip(KEYS, tnew, jnew):
        _close(a, b, f"state.{k}", rtol)

    _close(magnetic.l_zero(tp), jax_mag.l_zero(jp), "l_zero", rtol)
    ti0, ji0 = torch.as_tensor(i0), jnp.asarray(i0)
    tl, tcore = magnetic.l_effective(tp, tst, ti0, TEMP)
    jl, jcore = jax_mag.l_effective(jp, jst, ji0, TEMP)
    _close(tl, jl, "l_effective", rtol)
    for k, a, b in zip(KEYS, tcore, jcore):
        _close(a, b, f"l_effective state.{k}", rtol)
    _close(magnetic.value_for_mutual(tp, tst, ti0, TEMP),
           jax_mag.value_for_mutual(jp, jst, ji0, TEMP), "value_for_mutual",
           rtol)


def test_the_guards_are_hit():
    """The seeded states reach every branch the model guards."""
    rng = np.random.default_rng(21)
    n = 256
    p = _core_params(rng, n)
    st, i0, h = _core_states(rng, n, p["alpha"])
    dh = h - st["Hold"]
    he = h + p["alpha"] * st["M"]
    x = np.where(np.abs(he) < 1e-6, 1.0, he) / p["a"]
    assert (np.abs(dh) < 1e-12).any()
    assert (np.abs(he) < 1e-6).any()
    assert ((np.abs(x) < 0.25) & (np.abs(he) >= 1e-6)).any()
    assert (np.abs(x) >= 0.25).any()
    assert (np.abs(p["turns"] * i0 / p["len"]) > 1e6).any()
    m, dmdh, _ = magnetic.ja_calculate(
        {k: torch.as_tensor(v) for k, v in p.items()},
        magnetic.CoreState(*(torch.as_tensor(st[k]) for k in KEYS)),
        torch.as_tensor(h), TEMP)
    assert bool((dmdh.abs() > 1e3).any())


def port_batch(deck, cfg, params_np):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run"
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


@pytest.mark.parametrize("name", list(DECKS))
def test_magnetic_transient_matches_general_engine(name):
    fname, tstop = DECKS[name]
    deck = _deck(fname)
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(29)
    ov = {"R": {"value": lognormal(rng, cc.params["R"]["value"], 4)}}
    cfg, _, params_np, ref = reference(
        deck, ov, {"tstop": tstop} if tstop else None)
    out = port_batch(deck, cfg, params_np)
    assert_matches(out, ref)
    assert not out.fail.any()
    assert bool((out.t_final == cfg.tstop).all())
    assert "K" in cc.idx


def test_magnetic_run_constants():
    """The saturating transformer's frozen core gives L_eff = L0 at i0 = 0
    (dMdH = 0 at a zero core), and M = k·L0 of the two windings; the
    LM branch takes L0 while |i0| < 1e-9."""
    cc = ts.compile_circuit(ts.parse(_deck("saturating_transformer.cir")))
    params, _ = ts.batch_params(cc, {}, device="cpu")
    plan = run_plan.make_plan(cc)
    assert (plan.nlm, plan.nk) == (2, 1)
    rows = run_plan.magnetic_rows(plan, params, 1, "cpu", TEMP,
                                  ts.init_state(cc, device="cpu"))
    l0, leff, i0, i1, mij = rows
    assert torch.equal(l0, leff)
    assert not i0.any() and not i1.any()
    want = 0.98 * torch.sqrt(l0[:, 0] * l0[:, 1])
    assert torch.allclose(mij[:, 0], want, rtol=1e-15, atol=0)


LINEAR_PRIMARY = """Linear primary, saturating secondary
.tran 10u 2m
Vpri in 0 SIN(0 20 1k)
Rpri in p1 2.2
Lp p1 0 8m
Ls s1 0 core=XCORE turns=40
K1 Lp Ls 0.98
Rsec s1 0 220
.model XCORE CORE (ms=1.5meg A=900 K=450 C=0.18 ALPHA=1.2e-3 AREA=1.1e-4 LEN=0.08)
"""

# each case's deck and stop time (None: the deck's own)
MAGNETISED = {"saturating_transformer": (_deck("saturating_transformer.cir"),
                                         None),
              "linear_primary": (LINEAR_PRIMARY, 1e-4)}


def magnetised_state(pm, rng, b):
    """Per-lane (b, nlm) LM leaves of a magnetised core: the J-A state
    after ramping each winding to a seeded current in ten steps, with i0
    and i1 near that current; the v and flux leaves stay 0."""
    nlm = len(pm["turns"])
    i_end = (rng.uniform(0.05, 0.4, (b, nlm))
             * rng.choice([-1.0, 1.0], (b, nlm)))
    p = {k: torch.as_tensor(np.asarray(v))[None] for k, v in pm.items()}
    core = magnetic.CoreState(*(torch.zeros((b, nlm), dtype=torch.float64)
                                for _ in KEYS))
    for s in np.linspace(0.1, 1.0, 10):
        h = p["turns"] * torch.as_tensor(s * i_end) / p["len"]
        _, _, core = magnetic.ja_calculate(p, core, h, TEMP)
    lm = {k: v.numpy() for k, v in zip(KEYS, core)}
    lm.update(i0=i_end * 1.05, i1=i_end * 0.9)
    for k in ("v0", "v1", "flux0"):
        lm[k] = np.zeros((b, nlm))
    return lm


@pytest.mark.parametrize("name", list(MAGNETISED))
def test_magnetised_core_matches_general_engine(name):
    deck, tstop = MAGNETISED[name]
    b = 4
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(31)
    ov = {"R": {"value": lognormal(rng, cc.params["R"]["value"], b)}}
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    if tstop is not None:
        cfg = cfg._replace(tstop=tstop)
    params, axes = jax_batch_params(cc, ov)
    lm = magnetised_state({k: np.asarray(v)
                           for k, v in cc.params["LM"].items()}, rng, b)
    state0 = jax_init_state(cc)
    state0["LM"] = {k: jnp.asarray(v) for k, v in lm.items()}
    in_state = {k: (0 if k == "LM" else None) for k in state0}
    ref = jax.jit(jax.vmap(make_tran(cc, cfg, store="full"),
                           in_axes=(axes, in_state)))(params, state0)

    pcc = ts.compile_circuit(ts.parse(deck))
    pparams = params_from_numpy(
        {k: {kk: np.asarray(v) for kk, v in t.items()}
         for k, t in params.items()}, device="cpu")
    pstate0 = ts.init_state(pcc, device="cpu")
    pstate0["LM"] = {k: torch.tensor(v) for k, v in lm.items()}
    l0, leff, i0, _, _ = run_plan.magnetic_rows(
        run_plan.make_plan(pcc), pparams, b, "cpu", TEMP, pstate0)
    assert bool((i0.abs() >= 1e-9).all())
    assert bool((leff > 10.0 * l0).all())  # the frozen core's L_eff is used

    fn = ts.make_tran_batch(pcc, cfg, None, store="full")
    out = fn(pparams, pstate0)
    assert fn.engine == "store"
    assert_matches(out, ref)
    assert not out.fail.any()
    np.testing.assert_array_equal(out.out_n.numpy(), np.asarray(ref.out_n))
    rx, rt = np.asarray(ref.out_x), np.asarray(ref.out_t)
    for lane in range(b):
        n = int(out.out_n[lane])
        np.testing.assert_allclose(out.out_t[lane, :n].numpy(), rt[lane, :n],
                                   rtol=RTOL, atol=0)
        scale = float(np.abs(rx[lane, :n]).max())
        np.testing.assert_allclose(out.out_x[lane, :n].numpy(),
                                   rx[lane, :n], rtol=RTOL,
                                   atol=RTOL * scale)
    # the frozen core moves the waveform: a zero core gives another one
    zero = fn(pparams, ts.init_state(pcc, device="cpu"))
    n = int(min(zero.out_n.min(), out.out_n.min()))
    assert float((zero.out_x[:, :n] - out.out_x[:, :n]).abs().max()) > 1.0
