"""The port's device models (toyspice_tpu_torch/models) against the JAX
package's, function by function, on random batches of 256 made with numpy
from a seed: the limiter, the diode, the BJT (NPN and PNP), the MOSFET
(NMOS and PMOS, levels 1-3, every region), and the AC pieces: the sources'
phasors, the diode's junction capacitance and the BJT's junction
capacitances.  Both sides are f64; they may
differ only where XLA and PyTorch round differently (XLA's CPU code may
contract a product into a sum, and its exp/log/pow are its own), so the
bar is rtol 1e-12.  The one exception is stated where it is checked: the
level-2/3 MOSFET conductances are differences of two currents 1e-6 V
apart, which turn an ulp of the current into 1e6 ulp of the conductance;
they are held to that noise floor, 8 ulp of |id| over the 1e-6 step."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyspice_tpu.models import bjt as jbjt
from toyspice_tpu.models import diode as jdiode
from toyspice_tpu.models import limiter as jlim
from toyspice_tpu.models import mosfet as jmos
from toyspice_tpu.models import sources as jsources

from toyspice_tpu_torch.models import bjt, diode, limiter, mosfet, sources

N = 256
RTOL = 1e-12
TEMPS = (300.15, 350.0)


def close(got, want, what="", atol=None):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want),
                                  err_msg=what)
    scale = np.nanmax(np.abs(want)) if np.isfinite(want).any() else 1.0
    floor = RTOL * 1e-3 * max(scale, 1e-300)
    if atol is None:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=floor,
                                   err_msg=what)
        return
    ok = np.abs(got - want) <= RTOL * np.abs(want) + floor + atol
    assert ok.all(), (what, got[~ok], want[~ok])


def both(tree):
    """numpy leaves -> (torch leaves, jax leaves)."""
    return ({k: torch.as_tensor(v) for k, v in tree.items()},
            {k: jnp.asarray(v) for k, v in tree.items()})


def test_vcrit_and_pnjlim():
    rng = np.random.default_rng(0)
    vte = rng.uniform(0.02, 0.06, N)
    is_ = 10.0 ** rng.uniform(-18, -9, N)
    close(limiter.vcrit(torch.as_tensor(vte), torch.as_tensor(is_)),
          jlim.vcrit(jnp.asarray(vte), jnp.asarray(is_)), "vcrit")
    vc = np.asarray(jlim.vcrit(jnp.asarray(vte), jnp.asarray(is_)))
    # new voltages around and far past vcrit, old ones of both signs
    vnew = np.concatenate([rng.uniform(-5, 30, N // 2),
                           vc[N // 2:] + rng.uniform(-0.2, 2.0, N // 2)])
    vold = rng.uniform(-2, 1.5, N)
    vold[::7] = 0.0
    vold[1::9] = vnew[1::9] + 100.0  # arg <= 0: the vcrit branch
    got = limiter.pnjlim(*(torch.tensor(a) for a in (vnew, vold, vte, vc)))
    want = jlim.pnjlim(*(jnp.asarray(a) for a in (vnew, vold, vte, vc)))
    close(got, want, "pnjlim")
    assert (got.numpy() != vnew).sum() > N // 8  # the limiter engaged


def diode_params(rng):
    return {"is_": 10.0 ** rng.uniform(-17, -11, N),
            "n": rng.uniform(0.7, 2.0, N), "eg": rng.uniform(0.6, 1.2, N),
            "xti": rng.uniform(2.0, 4.0, N), "gmin": np.full(N, 1e-12),
            "cj0": np.where(rng.uniform(size=N) < 0.2, 0.0,
                            rng.uniform(1e-12, 1e-11, N)),
            "m": rng.uniform(0.3, 0.6, N), "vj": rng.uniform(0.5, 1.0, N)}


@pytest.mark.parametrize("temp", TEMPS)
def test_diode(temp):
    rng = np.random.default_rng(1)
    pt, pj = both(diode_params(rng))
    vd = rng.uniform(-3.0, 1.5, N)
    vd[::11] = rng.uniform(5.0, 60.0, len(vd[::11]))  # the clamped exp
    close(diode.temperature_adjusted_is(pt, temp),
          jdiode.temperature_adjusted_is(pj, temp), "is_t")
    assert diode.thermal_voltage(temp) == pytest.approx(
        float(jdiode.thermal_voltage(temp)), rel=1e-15)
    got = diode.dc_eval(pt, torch.as_tensor(vd), temp)
    want = jdiode.dc_eval(pj, jnp.asarray(vd), temp)
    for g, w, what in zip(got, want, ("id", "gd")):
        close(g, w, what)
    assert (vd < -3.0 * pt["n"].numpy() * diode.thermal_voltage(temp)).any()
    close(diode.junction_cap(pt, torch.as_tensor(vd)),
          jdiode.junction_cap(pj, jnp.asarray(vd)), "cj")


def bjt_params(rng, sign):
    off = rng.uniform(size=(4, N)) < 0.25  # parameters switched off
    return {"sign": np.full(N, sign), "ies": 10.0 ** rng.uniform(-16, -13, N),
            "ics": 10.0 ** rng.uniform(-16, -13, N),
            "nf": rng.uniform(0.9, 1.3, N), "nr": rng.uniform(0.9, 1.3, N),
            "alphaf": rng.uniform(0.95, 0.995, N),
            "vaf": np.where(off[0], 0.0, rng.uniform(20, 150, N)),
            "var": np.where(off[1], 0.0, rng.uniform(10, 80, N)),
            "ikf": np.where(off[2], 0.0, 10.0 ** rng.uniform(-4, -1, N)),
            "ikr": np.where(off[3], 0.0, 10.0 ** rng.uniform(-4, -1, N))}


@pytest.mark.parametrize("temp", TEMPS)
@pytest.mark.parametrize("sign", (1.0, -1.0), ids=("npn", "pnp"))
def test_bjt(sign, temp):
    rng = np.random.default_rng(2 if sign > 0 else 3)
    pt, pj = both(bjt_params(rng, sign))
    vbe = rng.uniform(-2.0, 1.0, N)
    vbc = rng.uniform(-12.0, 0.9, N)
    vbe[::13] = rng.uniform(2.0, 8.0, len(vbe[::13]))  # clamped exps
    vbc[5::17] = rng.uniform(2.0, 8.0, len(vbc[5::17]))
    vce = vbe - vbc
    for a in (vbe, vbc, vce):
        a[::10] = 0.0  # cold lanes: vbe = vce = 0
    tv = [torch.as_tensor(a) for a in (vbe, vbc, vce)]
    jv = [jnp.asarray(a) for a in (vbe, vbc, vce)]
    got = bjt.cold_start(pt, *tv, temp)
    want = jbjt.cold_start(pj, *jv, temp)
    for g, w, what in zip(got, want, ("vbe", "vbc", "vce")):
        close(g, w, "cold " + what)
    vbe_c, vbc_c = got[0], got[1]
    close(bjt.currents(pt, vbe_c, vbc_c, temp)[0],
          jbjt.currents(pj, want[0], want[1], temp)[0], "ic")
    close(bjt.currents(pt, vbe_c, vbc_c, temp)[1],
          jbjt.currents(pj, want[0], want[1], temp)[1], "ib")
    got = bjt.jacobian(pt, vbe_c, vbc_c, temp)
    want = jbjt.jacobian(pj, want[0], want[1], temp)
    for g, w, what in zip(got, want, ("ic", "ib", "g11", "g12", "g21",
                                      "g22")):
        close(g, w, what)


def mos_params(rng, sign):
    def some_off(lo, hi, frac=0.3):
        return np.where(rng.uniform(size=N) < frac, 0.0,
                        rng.uniform(lo, hi, N))

    return {"sign": np.full(N, sign), "vto": rng.uniform(0.3, 1.2, N),
            "kp": rng.uniform(1e-5, 5e-3, N), "w": rng.uniform(1e-6, 5e-5, N),
            "l": rng.uniform(5e-7, 2e-5, N), "lam": some_off(0.001, 0.05),
            "gamma": some_off(0.1, 0.8), "phi": rng.uniform(0.4, 0.9, N),
            "tox": rng.uniform(2e-8, 1e-7, N), "uo": rng.uniform(300, 700, N),
            "ucrit": some_off(5e3, 2e4), "uexp": some_off(0.05, 0.3),
            "vmax": some_off(1e4, 1e5), "theta": some_off(0.01, 0.2),
            "kappa": some_off(0.1, 0.5), "delta": some_off(0.1, 2.0),
            "cgso": some_off(1e-10, 1e-9), "cgdo": some_off(1e-10, 1e-9),
            "cgbo": some_off(1e-10, 1e-9), "cbs": some_off(1e-15, 1e-13),
            "cbd": some_off(1e-15, 1e-13), "cj": some_off(1e-4, 1e-3),
            "cjsw": some_off(1e-10, 1e-9), "as": rng.uniform(0, 1e-10, N),
            "ad": rng.uniform(0, 1e-10, N), "ps": rng.uniform(0, 1e-4, N),
            "pd": rng.uniform(0, 1e-4, N), "pb": rng.uniform(0.6, 0.9, N),
            "mj": rng.uniform(0.3, 0.6, N)}


@pytest.mark.parametrize("level", (1, 2, 3))
@pytest.mark.parametrize("sign", (1.0, -1.0), ids=("nmos", "pmos"))
def test_mosfet(sign, level):
    rng = np.random.default_rng(10 * level + (1 if sign > 0 else 2))
    pt, pj = both(mos_params(rng, sign))
    lv = np.full(N, level, dtype=np.int32)
    lv[::5] = rng.integers(1, 4, len(lv[::5]))  # mixed levels in one batch
    # the 256 devices of one circuit: node voltages -> the flipped frame
    x = rng.uniform(-5.0, 5.0, 64)
    x[0] = 0.0
    nodes = rng.integers(0, 64, (N, 4))
    nodes[::6, 3] = nodes[::6, 2]  # bulk tied to source: vbs = 0
    got_tv = mosfet.terminal_voltages(pt, torch.as_tensor(x), nodes)
    want_tv = jmos.terminal_voltages(pj, jnp.asarray(x), nodes)
    for g, w, what in zip(got_tv, want_tv, ("vgs", "vds", "vbs")):
        close(g, w, what)
    vgs, vds, vbs = (g.numpy().copy() for g in got_tv)
    vgs[::9], vds[::9], vbs[::9] = 0.0, 0.0, 0.0  # cold lanes
    tv = [torch.as_tensor(a) for a in (vgs, vds, vbs)]
    jv = [jnp.asarray(a) for a in (vgs, vds, vbs)]
    got = mosfet.cold_start(pt, *tv)
    want = jmos.cold_start(pj, *jv)
    for g, w in zip(got, want):
        close(g, w, "cold")
    ev = mosfet.dc_eval(pt, torch.as_tensor(lv), *got)
    jev = jmos.dc_eval(pj, jnp.asarray(lv), *want)
    diffd = np.where(lv >= 2, 8 * np.finfo(float).eps
                     * np.abs(np.asarray(jev.id)) / mosfet.DELTA, 0.0)
    for f in ev._fields:
        close(getattr(ev, f), getattr(jev, f), f,
              atol=diffd if f in ("gm", "gds", "gmbs") else None)
    q = mosfet.charges(pt, ev, *got)
    jq = jmos.charges(pj, jev, *want)
    for g, w, what in zip(q, jq, ("qgs", "qgd", "qgb", "qbs", "qbd")):
        close(g, w, what)
    region = ev.region.numpy()
    mine = lv == level
    for r in (mosfet.CUTOFF, mosfet.LINEAR, mosfet.SATURATION):
        assert (region[mine] == r).sum() >= 5, f"region {r} not covered"
    assert (got[2].numpy() < 0).sum() > 20  # body effect engaged


def test_junction_update_matches_nlstate():
    """engine/nlstate: init_jv and the limited update on a deck with a
    diode, an NPN, a PNP and MOSFETs of both types, x in batches of 4."""
    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine import nlstate as jnl
    from toyspice_tpu.netlist.parser import parse as jax_parse

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine import nlstate

    deck = """* every junction family
.op
V1 1 0 DC 5
D1 1 2 DX
Q1 3 2 0 QN
Q2 0 2 4 QP
M1 5 2 1 1 PM
M2 5 2 0 0 NM
R1 3 0 1k
R2 4 0 1k
R3 5 0 1k
.model DX D(Is=1e-15 N=1.1)
.model QN NPN(Bf=150)
.model QP PNP(Bf=80)
.model PM PMOS(VTO=-0.8)
.model NM NMOS(VTO=0.7)
"""
    jcc = jax_compile(jax_parse(deck))
    cc = ts.compile_circuit(ts.parse(deck))
    jzero = jnl.init_jv(jcc)
    zero = nlstate.init_jv(cc, device="cpu")
    assert {k: list(v) for k, v in zero.items()} == {
        k: list(v) for k, v in jzero.items()}
    rng = np.random.default_rng(9)
    x = rng.uniform(-3.0, 40.0, (4, cc.np1))
    x[:, 0] = 0.0
    prev = {k: {kk: rng.uniform(-1.0, 1.0, (4,) + v.shape)
                for kk, v in t.items()} for k, t in jzero.items()}
    params = {k: {kk: torch.as_tensor(np.asarray(v)) for kk, v in t.items()}
              for k, t in jcc.params.items()}
    got = nlstate.update_jv(cc.idx, params, torch.as_tensor(x),
                            {k: {kk: torch.as_tensor(v) for kk, v in t.items()}
                             for k, t in prev.items()})
    for lane in range(4):
        want = jnl.update_jv(jcc, jcc.params, jnp.asarray(x[lane]),
                             {k: {kk: jnp.asarray(v[lane])
                                  for kk, v in t.items()}
                              for k, t in prev.items()})
        for k in want:
            for kk in want[k]:
                close(got[k][kk][lane], want[k][kk], f"{k}.{kk}")


def test_source_phasors():
    rng = np.random.default_rng(21)
    p = {"ac_mag": np.where(rng.uniform(size=N) < 0.2, 0.0,
                            rng.uniform(-2.0, 5.0, N)),
         "ac_phase": rng.uniform(-400.0, 400.0, N)}
    p["ac_phase"][::7] = 0.0
    p["ac_phase"][3::11] = 90.0
    pt, pj = both(p)
    for g, w, what in zip(sources.eval_sources_ac(pt),
                          jsources.eval_sources_ac(pj), ("re", "im")):
        close(g, w, what)
    # batched (B, nS) leaves as the AC assembly passes them
    pb = {k: v.reshape(16, 16) for k, v in pt.items()}
    re_, im_ = sources.eval_sources_ac(pb)
    assert re_.shape == (16, 16)
    close(re_.reshape(-1), jsources.eval_sources_ac(pj)[0], "re batched")


def test_diode_junction_cap():
    rng = np.random.default_rng(22)
    p = {"cj0": np.where(rng.uniform(size=N) < 0.2, 0.0,
                         10.0 ** rng.uniform(-13, -10, N)),
         "vj": rng.uniform(0.5, 1.0, N), "m": rng.uniform(0.2, 0.6, N)}
    vd = rng.uniform(-20.0, 1.0, N)
    vd[::9] = 0.0
    pt, pj = both(p)
    close(diode.junction_cap(pt, torch.as_tensor(vd)),
          jdiode.junction_cap(pj, jnp.asarray(vd)), "cj")


@pytest.mark.parametrize("sign", (1.0, -1.0), ids=("npn", "pnp"))
def test_bjt_junction_caps(sign):
    rng = np.random.default_rng(23 if sign > 0 else 24)
    p = {"cje": 10.0 ** rng.uniform(-13, -10, N),
         "vje": rng.uniform(0.5, 0.9, N), "mje": rng.uniform(0.2, 0.5, N),
         "cjc": 10.0 ** rng.uniform(-13, -10, N),
         "vjc": rng.uniform(0.5, 0.9, N), "mjc": rng.uniform(0.2, 0.5, N),
         "tf": np.where(rng.uniform(size=N) < 0.2, 0.0,
                        10.0 ** rng.uniform(-11, -8, N)),
         "sign": np.full(N, sign)}
    vbe = rng.uniform(-5.0, 1.2, N)  # both sides of vje
    vbc = rng.uniform(-15.0, 1.2, N)
    gm = sign * 10.0 ** rng.uniform(-6, -1, N)
    pt, pj = both(p)
    got = bjt.junction_caps(pt, *(torch.as_tensor(a) for a in (vbe, vbc,
                                                               gm)))
    want = jbjt.junction_caps(pj, *(jnp.asarray(a) for a in (vbe, vbc,
                                                             gm)))
    for g, w, what in zip(got, want, ("cbe", "cbc")):
        close(g, w, what)
