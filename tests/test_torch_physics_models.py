"""The port's physics-semantics device pieces on the CPU against the JAX
package's: the Rs/Bv diode (models/diode.py ``dc_eval_physics``) over the
forward, flat-reverse and breakdown regions with and without series
resistance, the breakdown-frame limit of ``update_jv`` across its gate,
and the bias-point seed ``make_op_seed``.  Inputs are made with numpy from
a seed; values within rtol 1e-12 (both sides f64)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine import nlstate as jax_nlstate
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.state import make_op_seed as jax_make_op_seed
from toyspice_tpu.models import diode as jax_diode
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine import nlstate
from toyspice_tpu_torch.engine.state import make_op_seed
from toyspice_tpu_torch.models import diode

RTOL = 1e-12


def diode_params(rng, n, rs):
    """n diodes of varied Is, N, Bv and Tt; Rs = ``rs`` on every one."""
    return {"is_": 10.0 ** rng.uniform(-16, -12, n),
            "n": rng.uniform(0.9, 1.8, n), "gmin": np.full(n, 1e-12),
            "eg": np.full(n, 1.11), "xti": np.full(n, 3.0),
            "tt": rng.uniform(0.0, 1e-8, n),
            "bv": rng.uniform(20.0, 120.0, n), "rs": np.full(n, rs)}


def voltages(rng, p):
    """Per diode: a forward voltage, a flat-reverse one, and breakdown
    voltages 0.05-2 V past -Bv; (6, n)."""
    n = len(p["bv"])
    return np.stack([rng.uniform(0.2, 0.9, n), rng.uniform(0.5, 1.5, n),
                     -rng.uniform(1.0, 10.0, n),
                     -0.5 * p["bv"],
                     -p["bv"] - rng.uniform(0.05, 0.5, n),
                     -p["bv"] - rng.uniform(0.5, 2.0, n)])


def torch_tree(p):
    return {k: torch.as_tensor(v) for k, v in p.items()}


@pytest.mark.parametrize("rs", [0.0, 0.5, 100.0])
@pytest.mark.parametrize("temp", [300.15, 350.0])
def test_dc_eval_physics_matches_jax(rs, temp):
    rng = np.random.default_rng(int(rs * 10) + int(temp))
    p = diode_params(rng, 8, rs)
    vd = voltages(rng, p)
    ij, gj = jax_diode.dc_eval_physics({k: jnp.asarray(v) for k, v in
                                        p.items()}, jnp.asarray(vd), temp)
    it, gt = diode.dc_eval_physics(torch_tree(p), torch.as_tensor(vd), temp)
    np.testing.assert_allclose(it.numpy(), np.asarray(ij), rtol=RTOL,
                               atol=0)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=0)
    # every region is reached: forward, flat reverse (-Is_t) and breakdown
    # (|id| beyond Is_t)
    is_t = diode.temperature_adjusted_is(torch_tree(p), temp)
    assert bool((it[0] > 0).all())
    assert bool((it[3] == -is_t).all()) if rs == 0 else True
    assert bool((it[5].abs() > 10 * is_t).all())


def test_rs_skip_is_exact():
    """At Rs = 0 the inner Newton is an exact no-op, so skipping it (every
    lane's Rs 0) gives the same bits."""
    rng = np.random.default_rng(3)
    p = torch_tree(diode_params(rng, 8, 0.0))
    vd = torch.as_tensor(voltages(rng, {k: v.numpy() for k, v in p.items()}))
    a = diode.dc_eval_physics(p, vd, 300.15, rs_any=True)
    b = diode.dc_eval_physics(p, vd, 300.15, rs_any=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_rs_moves_the_forward_characteristic():
    """With Rs the terminal current at a forward voltage falls below the
    bare junction's, and gd = g/(1 + Rs·g) stays below 1/Rs."""
    rng = np.random.default_rng(5)
    p0 = diode_params(rng, 4, 0.0)
    p1 = dict(p0, rs=np.full(4, 10.0))
    vd = torch.full((4,), 0.9, dtype=torch.float64)
    i0, _ = diode.dc_eval_physics(torch_tree(p0), vd, 300.15)
    i1, g1 = diode.dc_eval_physics(torch_tree(p1), vd, 300.15)
    assert bool((i1 < i0).all()) and bool((g1 < 0.1).all())


DIODE_DECK = """* one diode
.tran 1u 10u
V1 1 0 DC 1
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 Bv=50)
"""


def test_update_jv_breakdown_frame_matches_jax():
    """The physics limit across the gate min(0, -Bv + 10·vte): below it the
    step is limited as -(Bv + vd); a jump from breakdown to forward bias
    keeps the forward limit (the gate reads the new voltage only)."""
    jcc = jax_compile(jax_parse(DIODE_DECK))
    pcc = ts.compile_circuit(ts.parse(DIODE_DECK))
    pd = {k: np.asarray(v) for k, v in jcc.params["D"].items()}
    vte = pd["n"][0] * nlstate.VT_NOM
    gate = -50.0 + 10.0 * vte
    new = np.array([gate - 1e-9, gate + 1e-9, gate - 3.0, -51.0, -60.0,
                    0.9, 0.8, -49.0, -50.2, 5.0])
    old = np.array([gate + 0.5, gate - 0.5, -49.0, -50.0, -51.0,
                    -55.0, 0.1, -52.0, -49.9, -60.0])
    n2 = jcc.node_map["2"]
    for sem in ("compat", "physics"):
        for vn, vo in zip(new, old):
            x = np.zeros(jcc.np1)
            x[n2] = vn
            ref = jax_nlstate.update_jv(
                jcc, {"D": {k: jnp.asarray(v) for k, v in pd.items()}},
                jnp.asarray(x), {"D": {"vd": jnp.asarray([vo])}},
                semantics=sem)
            got = nlstate.update_jv(
                pcc.idx, {"D": torch_tree(pd)}, torch.as_tensor(x),
                {"D": {"vd": torch.as_tensor([vo])}}, sem)
            np.testing.assert_allclose(got["D"]["vd"].numpy(),
                                       np.asarray(ref["D"]["vd"]),
                                       rtol=RTOL, atol=0,
                                       err_msg=f"{sem} {vn} {vo}")
    # below the gate physics limits where compat passes the step through
    x = np.zeros(jcc.np1)
    x[n2] = -60.0
    args = (pcc.idx, {"D": torch_tree(pd)}, torch.as_tensor(x),
            {"D": {"vd": torch.as_tensor([-51.0])}})
    assert float(nlstate.update_jv(*args)["D"]["vd"]) == -60.0
    assert float(nlstate.update_jv(*args, "physics")["D"]["vd"]) > -52.0


SEED_DECK = """* R, L, D, C
.tran 1u 10u
V1 1 0 DC 2
R1 1 2 1k
L1 2 3 1m
D1 3 4 DM
C1 4 0 1u
R2 4 0 10k
.model DM D (Is=1e-14 Rs=5 Tt=2n)
"""


@pytest.mark.parametrize("temp", [300.15, 330.0])
def test_make_op_seed_matches_jax(temp):
    """C at its OP voltage and raw-C charge, L at its branch current, the
    diode's physics charge at the stamp temperature; hist untouched."""
    jcc = jax_compile(jax_parse(SEED_DECK))
    pcc = ts.compile_circuit(ts.parse(SEED_DECK))
    rng = np.random.default_rng(11)
    b = 3
    xs = rng.normal(0.0, 1.0, (b, jcc.np1))
    xs[:, 0] = 0.0
    cval = np.asarray(jcc.params["C"]["value"])[None] * np.exp(
        rng.normal(0.0, 0.1, (b, 1)))
    jparams = {k: {kk: jnp.asarray(v) for kk, v in t.items()}
               for k, t in jcc.params.items()}
    seed_j = jax_make_op_seed(jcc, temp)
    refs = [seed_j({**jparams, "C": {**jparams["C"],
                                     "value": jnp.asarray(cval[i])}},
                   jax_init_state(jcc), jnp.asarray(xs[i]))
            for i in range(b)]
    params, _ = ts.batch_params(pcc, {"C": {"value": cval}}, device="cpu")
    got = make_op_seed(pcc, temp)(params, ts.init_state(pcc, device="cpu"),
                                  torch.as_tensor(xs))
    for kind in ("C", "L", "D"):
        assert set(got[kind]) == set(refs[0][kind]), kind
        for key in refs[0][kind]:
            want = np.stack([np.asarray(r[kind][key]) for r in refs])
            have = np.broadcast_to(got[kind][key].numpy(), want.shape)
            np.testing.assert_allclose(have, want, rtol=RTOL, atol=0,
                                       err_msg=f"{kind}.{key}")
    assert float(got["D"]["prev_charge"].abs().max()) > 0
