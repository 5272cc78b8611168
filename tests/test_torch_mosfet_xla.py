"""Where the port's level-2/3 MOSFET arithmetic meets XLA's.

The JAX package's ``models/mosfet.py`` runs compiled by XLA, whose
algebraic simplifier rewrites some of its arithmetic (ROADMAP Queue 3 lists
the rewrites); the port (``models/mosfet.py`` and ``csrc/newton.cuh``)
computes those the way the compiled code does.  What stays different is
below the operations the source names: XLA's f64 ``power`` (level 2's
mobility term) and ``rsqrt`` (level 3's vdsat) against the port's
exp(b·log a) and 1/sqrt, and XLA's CPU code contracting a product and a
difference into one fused multiply-add (the linear-region currents).
These tests check, at the bias points of
tests/test_torch_run_nonlinear.py's level-2/3 transient, that pow and
rsqrt stay within two ulps of XLA's, that the Meyer capacitances are
equal, and that the drain current is within two ulps wherever pow and
rsqrt agree."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.models import mosfet as jmos
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.models import mosfet

from test_torch_run_nonlinear import MOS23_TRAN

_cache = {}


def bias_points():
    """Every accepted step's terminal voltages of the transient (one lane,
    the deck's values), the JAX parameters and level codes, built once."""
    if not _cache:
        cc = ts.compile_circuit(ts.parse(MOS23_TRAN))
        tp = cc.netlist.tran
        cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax,
                              tp.uic)
        params, _ = ts.batch_params(cc, {}, device="cpu")
        out = ts.make_tran_batch(cc, cfg, None, store="full")(
            params, ts.init_state(cc, device="cpu"))
        x = out.out_x[0, :int(out.out_n[0])]
        tv = mosfet.terminal_voltages(params["M"], x, cc.idx["M"]["nodes"])
        jcc = jax_compile(jax_parse(MOS23_TRAN))
        _cache.update(
            tv=tv, pt=params["M"],
            pj={k: jnp.asarray(np.asarray(v))
                for k, v in jcc.params["M"].items()},
            level=np.asarray(jcc.idx["M"]["level"]))
    return _cache


def ulps(a, b):
    """|a - b| in units in the last place of b."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.spacing(np.abs(b))


def test_pow_and_rsqrt_differ_by_at_most_two_ulps():
    c = bias_points()
    vgs, vds, vbs = c["tv"]
    p = c["pt"]
    lv2 = c["level"] == 2
    vth = mosfet._vth(p, vbs)
    vgst = (vgs - vth)[:, lv2]
    pp = {k: v[lv2] for k, v in p.items()}
    base = torch.clamp_min(vgst / ((pp["tox"] * 100.0) * pp["ucrit"]),
                           1e-300)
    mine = mosfet.pow_pos(base, pp["uexp"]).numpy()
    xla = np.asarray(jax.jit(jnp.power)(jnp.asarray(base.numpy()),
                                         jnp.asarray(pp["uexp"].numpy())))
    assert ulps(mine, xla).max() <= 2
    m = np.linspace(1.0, 3.0, 4097)
    r = np.asarray(jax.jit(jax.lax.rsqrt)(jnp.asarray(m)))
    assert ulps(1.0 / np.sqrt(m), r).max() <= 2


@pytest.mark.parametrize("level", [2, 3])
def test_current_and_caps_where_the_functions_agree(level):
    c = bias_points()
    vgs, vds, vbs = c["tv"]
    lv = torch.as_tensor(c["level"])
    ev = mosfet.dc_eval(c["pt"], lv, vgs, vds, vbs)
    jev = jax.jit(jmos.dc_eval)(c["pj"], jnp.asarray(c["level"]),
                                *(jnp.asarray(a.numpy()) for a in c["tv"]))
    col = int(np.flatnonzero(c["level"] == level)[0])
    # the points where the level's function call rounds alike
    p = {k: v[col] for k, v in c["pt"].items()}
    vgst = vgs[:, col] - mosfet._vth(p, vbs[:, col])
    if level == 2:
        base = torch.clamp_min(vgst / ((p["tox"] * 100.0) * p["ucrit"]),
                               1e-300)
        agree = (mosfet.pow_pos(base, p["uexp"]).numpy()
                 == np.asarray(jnp.power(jnp.asarray(base.numpy()),
                                         float(p["uexp"]))))
    else:
        veff = vgst / (1.0 + p["theta"] * vgst)
        m = torch.clamp_min(1.0 + p["kappa"] * veff, 1e-30).numpy()
        agree = 1.0 / np.sqrt(m) == np.asarray(jax.lax.rsqrt(
            jnp.asarray(m)))
    assert agree.sum() > len(agree) // 4
    for f in ("cgs", "cgd", "cgb"):
        np.testing.assert_array_equal(getattr(ev, f)[:, col].numpy(),
                                      np.asarray(getattr(jev, f))[:, col],
                                      err_msg=f)
    got = ev.id[:, col].numpy()[agree]
    want = np.asarray(jev.id)[:, col][agree]
    on = want != 0
    assert on.sum() > 10
    assert ulps(got[on], want[on]).max() <= 2
    np.testing.assert_array_equal(got[~on], want[~on])
