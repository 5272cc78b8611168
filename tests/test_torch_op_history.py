"""An OP from a state with history, under physics/trap, on the CPU.

No entry point of either package reaches it unless the caller hands the
OP such a state, so the state here comes from a short JAX transient under
physics/trap (its inductor has ``hist`` > 0, a current ``i1`` and a
voltage ``v0``) and is carried across with the port's own
``convert.params_from_numpy``.  Each port OP engine is held to its JAX
counterpart on it:

* the general OP (``engine/op.make_op``, a nonlinear deck) and the linear
  OP (the same on a linear deck) stamp the trapezoidal inductor companion,
  2L/dt·i1 + v0 with dt = 1e-9, as the JAX general engine does
  (ops/assemble.py); they are held to its ``make_op``;
* the kernel OP (``ops/op.make_op_fused``, the plain version of
  csrc/op_kernel.cu) stamps backward Euler, L/dt·i1, as the JAX package's
  ``_op_kernel`` does: it reads only L.i1 (ops/pallas_op.py, the lrhs of
  ``make_op_fused``).  That is the JAX general engine's stamp for the same
  state with ``hist`` = 0, which is what it is held to here (the XLA trace
  of the JAX fused OP takes minutes on one core, which is why
  tests/test_fused_op.py is marked slow).

The bar is tests/test_torch_op.py's: ``converged`` and ``stage`` equal per
lane, x within rtol 1e-9; and the two stamps give different x."""

import numpy as np

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.op import make_op as jax_make_op
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran as jax_make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.op import make_op
from toyspice_tpu_torch.ops.op import make_op_fused

RTOL, ATOL = 1e-9, 1e-12
LANES = 3

RL_DIODE = """* RL into a diode
.tran 1u 20u
V1 1 0 SIN(0.5 1 50k)
R1 1 2 100
L1 2 3 1m
D1 3 0 DM
.model DM D (Is=1e-14)
"""

RL = """* RL divider
.tran 1u 20u
V1 1 0 SIN(0.5 1 50k)
R1 1 2 100
L1 2 3 1m
R2 3 0 50
"""


def history(deck):
    """(params and the end state of a 20 us physics/trap JAX transient as
    numpy, the JAX cc, axes, options)."""
    cc = jax_compile(jax_parse(deck))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(0)
    r = np.asarray(cc.params["R"]["value"])
    params, axes = jax_batch_params(cc, {"R": {"value": r[None] * np.exp(
        rng.normal(0, 0.1, (LANES, len(r))))}})
    opts = JaxOptions(integration="trap")
    out = jax.jit(jax.vmap(jax_make_tran(cc, cfg, semantics="physics",
                                         opts=opts),
                           in_axes=(axes, None)))(params, jax_init_state(cc))
    state = jax.tree_util.tree_map(np.asarray, out.state)
    assert (state["L"]["hist"] > 0).all() and (state["L"]["i1"] != 0).all()
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return params_np, state, cc, axes, opts


def jax_op(cc, params_np, axes, opts, state):
    op_g, _ = jax_make_op(cc, opts, semantics="physics")
    state_axes = jax.tree_util.tree_map(lambda _: 0, state)
    return jax.jit(jax.vmap(op_g, in_axes=(axes, state_axes)))(params_np,
                                                               state)


def assert_matches(out, ref):
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(ref.converged))
    np.testing.assert_array_equal(out.stage.numpy(), np.asarray(ref.stage))
    assert bool(out.converged.all())
    np.testing.assert_allclose(out.x.numpy(), np.asarray(ref.x), rtol=RTOL,
                               atol=ATOL)


def test_op_from_a_state_with_history():
    opts = ts.SimOptions(integration="trap")
    for deck, engines in ((RL_DIODE, ("general", "kernel")),
                          (RL, ("linear",))):
        params_np, state, jcc, axes, jopts = history(deck)
        trap_ref = jax_op(jcc, params_np, axes, jopts, state)
        be_state = dict(state, L=dict(state["L"],
                                      hist=np.zeros_like(state["L"]["hist"])))
        be_ref = jax_op(jcc, params_np, axes, jopts, be_state)
        assert not np.allclose(np.asarray(trap_ref.x), np.asarray(be_ref.x),
                               rtol=RTOL, atol=ATOL)
        cc = ts.compile_circuit(ts.parse(deck))
        params = params_from_numpy(params_np, device="cpu")
        state0 = params_from_numpy(state, device="cpu")
        for engine in engines:
            if engine == "kernel":
                out, ref = make_op_fused(cc, opts, "physics")(params,
                                                              state0), be_ref
            else:
                out, ref = make_op(cc, opts, "physics")(params,
                                                        state0), trap_ref
            assert_matches(out, ref)
