"""A deck past n = 128 (np1 = 130: on the card the kernels eliminate its
systems in the registers of a 512-thread block) through the port's
transient on the CPU: a 127-stage RC ladder (np1 = 130), 2
lanes with C spread log-normally by 0.1, to 0.05 ms, through
``make_tran_batch`` (engine "general": the general OP, then the masked
attempt loop over the general Newton, ``assemble_entries`` and the plain
stamped solve), against the JAX package's general engine (engine/tran.py
``make_tran``, vmapped) on the same numpy inputs.  The bar is the
standing one: accepted, attempts, fail and nr_iters equal per lane;
state, jv and t_final within rtol 1e-9."""

import numpy as np

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_general import jax_reference, spread
from test_torch_run import RTOL, assert_matches
from test_torch_run_nonlinear import assert_jv_matches

LANES = 2


def rc_ladder(stages, analysis=".tran 0.01m 0.05m"):
    """An RC ladder of ``stages`` sections (100 Ω series, 1 nF shunt) from
    a 1 kHz sine: np1 = stages + 3 (the ground row, nodes 1..stages + 1,
    the source's branch row)."""
    lines = [f"* {stages}-stage rc ladder", analysis, "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 1n"]
    return "\n".join(lines) + "\n"


def test_past_nbig_transient_matches_jax():
    deck = rc_ladder(127)
    cfg, params_np, ref = jax_reference(deck, spread(deck, ("C",),
                                                     lanes=LANES))
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 130
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "general" and "np1=130" in fn.engine_reason
    out = fn(params_from_numpy(params_np, device="cpu"),
             ts.init_state(cc, device="cpu"))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    np.testing.assert_allclose(out.dt_final.numpy(),
                               np.asarray(ref.dt_final), rtol=RTOL)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())
    assert int(out.accepted.min()) > 0
