"""The port's OP, DC sweep and AC of magnetic decks on the CPU against the
JAX package's general engine (engine/op.py ``make_op``, engine/dc.py
``make_dc`` and engine/ac.py ``make_ac_batch``, vmapped), under compat
and physics semantics:

* the OP and the DC sweep of an LM + diode deck (TRANS_SMALL of
  tests/test_fused_tran.py with a diode, load and capacitor on the
  secondary): the plain versions of the OP and DC sweep kernels with each
  winding's +1e-3 branch diagonal (magnetic.go:216-217) and no K stamp;
* the OP and DC sweep of ``saturating_transformer.cir``, a linear
  magnetic deck: the stamped solve of ``assemble_entries``' entries;
* AC of ``coupled_inductors.cir`` and ``saturating_transformer.cir``,
  their primaries driven by a unit AC source: each winding's -ωL and
  each coupling's -ωM on the branch rows, L of an LM the J-A
  ``value_for_mutual`` at the zero state.

The bars of tests/test_torch_physics_op.py: ``converged`` and ``stage``
equal per lane (and the plain-NR iterations on the OP kernel's deck), x,
jv and the DC points within rtol 1e-9, atol 1e-12, DC ``conv`` equal per
point; AC within rtol 2e-9 of the solution's scale.  4 lanes (3 for AC),
R spread log-normally by 0.1 from a seed."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.ac import frequency_points as jax_freqs
from toyspice_tpu.engine.ac import make_ac_batch as jax_make_ac_batch
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.dc import make_dc as jax_make_dc
from toyspice_tpu.engine.newton import make_nr
from toyspice_tpu.engine.nlstate import init_jv as jax_init_jv
from toyspice_tpu.engine.op import make_op
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine

from test_fused_tran import TRANS_SMALL
from test_torch_physics_op import AC_TOL, ATOL, RTOL, numpy_tree, r_spread
from test_torch_physics_run import deck_file

# TRANS_SMALL with a half-wave rectifier on its secondary
LM_DIODE = TRANS_SMALL.replace(
    "Rload 3 0 1000", "D1 3 4 DMOD\nRload 4 0 1k\nCload 4 0 10u\n"
    ".model DMOD D(IS=1e-14)")
SAT = deck_file("saturating_transformer.cir")
COUPLED = deck_file("coupled_inductors.cir")
SEMANTICS = ("compat", "physics")
OP_CASES = [(deck, name, engine, sem)
            for deck, name, engine in ((LM_DIODE, "lm_diode", "fused"),
                                       (SAT, "saturating_transformer",
                                        "linear"))
            for sem in SEMANTICS]


def op_reference(deck, overrides, semantics):
    """The general engine's OP and its plain-NR iterations from the linear
    estimate (the stage-0 Newton the port counts)."""
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, overrides)
    opts = JaxOptions()
    op_g, estimate = make_op(cc, opts, semantics=semantics)
    nr = make_nr(cc, mode="op", warm_start=False, conv="op",
                 semantics=semantics, opts=opts)
    s0 = jax_init_state(cc)

    def lane(p):
        r0 = nr(p, s0, jax_init_jv(cc), estimate(p, s0, 1.0), t=0.0, dt=0.0,
                gmin=0.0, dc_scale=1.0)
        return op_g(p, s0), r0.iters

    ref, iters = jax.jit(jax.vmap(lane, in_axes=(axes,)))(params)
    return numpy_tree(params), ref, np.asarray(iters)


@pytest.mark.parametrize("deck,name,engine,semantics", OP_CASES,
                         ids=[f"{n}-{s}" for _, n, _, s in OP_CASES])
def test_magnetic_op_matches_general_engine(deck, name, engine, semantics):
    cc = jax_compile(jax_parse(deck))
    params_np, ref, iters = op_reference(deck, r_spread(cc, 4), semantics)
    pcc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(pcc, semantics)[0] == engine
    out = ts.run_op_batch(pcc, params_from_numpy(params_np, device="cpu"),
                          semantics=semantics)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.stage.numpy(), np.asarray(ref.stage))
    assert bool(out.converged.all())
    if engine == "fused":
        np.testing.assert_array_equal(out.iters.numpy(), iters)
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)
    for kind in ref.jv:
        for key in ref.jv[kind]:
            np.testing.assert_allclose(
                out.jv[kind][key].numpy(), np.asarray(ref.jv[kind][key]),
                rtol=RTOL, atol=ATOL, err_msg=f"jv.{kind}.{key}")
    # the windings' branch rows carry the +1e-3 diagonal: a DC current
    # through a winding shows as 1e3 times its voltage, not a short
    br = pcc.idx["LM"]["branch"]
    assert float(out.x[:, br].abs().max()) < 1e-6


@pytest.mark.parametrize("deck,name,semantics",
                         [(d, n, s) for d, n, _, s in OP_CASES],
                         ids=[f"{n}-{s}" for _, n, _, s in OP_CASES])
def test_magnetic_dc_sweep_matches_general_engine(deck, name, semantics):
    cc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(cc, r_spread(cc, 4, 3))
    pts = np.linspace(-2.0, 5.0, 8)
    slot = (0,)  # the primary's source
    dc = jax_make_dc(cc, slot, JaxOptions(), semantics=semantics)
    s0 = jax_init_state(cc)
    xs_ref, conv_ref = jax.jit(jax.vmap(lambda p: dc(p, s0, jnp.asarray(pts)),
                                        in_axes=(axes,)))(params)
    pcc = ts.compile_circuit(ts.parse(deck))
    xs, conv = ts.run_dc_batch(pcc, slot, params_from_numpy(
        numpy_tree(params), device="cpu"), None, pts, semantics=semantics)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    np.testing.assert_allclose(xs.numpy(), np.asarray(xs_ref), rtol=RTOL,
                               atol=ATOL)


# the decks with their primary driven by a unit AC source
AC_DECKS = {"coupled_inductors": COUPLED.replace("SIN(0 10 2k)", "AC 1 0"),
            "saturating_transformer": SAT.replace("SIN(0 20 1k)", "AC 1 0")}
AC_CASES = [(AC_DECKS[name], name, sem) for name in AC_DECKS
            for sem in SEMANTICS]


@pytest.mark.parametrize("deck,name,semantics", AC_CASES,
                         ids=[f"{n}-{s}" for _, n, s in AC_CASES])
def test_magnetic_ac_matches_general_engine(deck, name, semantics):
    cc = jax_compile(jax_parse(deck))
    freqs = jax_freqs("DEC", 10.0, 1e5, 9)
    params, axes = jax_batch_params(cc, r_spread(cc, 3, 2))
    xr_ref, xi_ref, opr = jax.jit(jax_make_ac_batch(
        cc, axes, JaxOptions(), semantics=semantics))(
        params, jax_init_state(cc), jnp.asarray(freqs))
    pcc = ts.compile_circuit(ts.parse(deck))
    xr, xi, out = ts.run_ac_batch(pcc, params_from_numpy(
        numpy_tree(params), device="cpu"), None, freqs, semantics=semantics)
    assert bool(out.converged.all())
    xr_ref, xi_ref = np.asarray(xr_ref), np.asarray(xi_ref)
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max(), 1e-12)
    np.testing.assert_allclose(xr.numpy(), xr_ref, rtol=AC_TOL,
                               atol=AC_TOL * scale)
    np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=AC_TOL,
                               atol=AC_TOL * scale)
    # the coupling drives the secondary: its winding's branch current
    sec = pcc.idx["LM" if "LM" in pcc.idx else "L"]["branch"][1]
    assert float(xr[..., sec].abs().max()) > 1e-4
