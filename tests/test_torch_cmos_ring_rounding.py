"""A 5-stage level-1 CMOS ring (``cmos_ring(5)`` of
tests/test_torch_past_caps.py), 2 lanes with C spread log-normally by 0.1
from numpy seed 0, where the port and the JAX package's general engine
part on lane 0 by rounding, not by a fault (ROADMAP Queue 3).

The deck has no stable solution in this simulator: its nodes leave the
rails within a few picoseconds (a capacitor at -13 V by t = 2.8 ps, -38 V
by 3.87 ps on a 1.8 V supply), and each accepted step there multiplies a
difference in the last bits by about 4,500 (relative 3.7e-16 after 9
attempts, 1.7e-12 after 10, 4.2e-9 after 12).  Both engines keep the same
counters through attempt 14; at attempt 15 (dt = 0.53 ps after three
rejections) the port's Newton converges in its 84th iteration of 100 and
the JAX package's, from a start 4.2e-9 away, runs to max_iter and rejects:
lane 0 then takes 36 accepted steps in the port (the run and the general
engine alike) and 8 in the JAX package, and both fail.  Lane 1 agrees
throughout.

What holds, and what this test holds: every counter of both lanes equal
through 14 attempts, the state within rtol 1e-9 through 11; lane 1 at the
standing bar over the whole run (counters equal, state within rtol 1e-9);
both lanes hard-fail in both packages."""

import numpy as np

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_past_caps import cmos_ring

DECK = cmos_ring(5)
RTOL = 1e-9


def _both(cfg, ov):
    """The JAX general engine's and the port's run engine's TranOutput."""
    import jax

    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine.batch import batch_params as jax_batch_params
    from toyspice_tpu.engine.state import init_state as jax_init_state
    from toyspice_tpu.engine.tran import make_tran as jax_make_tran
    from toyspice_tpu.netlist.parser import parse as jax_parse

    jcc = jax_compile(jax_parse(DECK))
    params, axes = jax_batch_params(jcc, ov)
    ref = jax.jit(jax.vmap(jax_make_tran(jcc, cfg), in_axes=(axes, None)))(
        params, jax_init_state(jcc))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    cc = ts.compile_circuit(ts.parse(DECK))
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run"
    return ref, fn(params_from_numpy(params_np, device="cpu"),
                   ts.init_state(cc, device="cpu"))


def _counters_equal(out, ref, lanes=slice(None)):
    for key in ("accepted", "attempts", "nr_iters", "fail", "t_final",
                "dt_final"):
        np.testing.assert_array_equal(getattr(out, key).numpy()[lanes],
                                      np.asarray(getattr(ref, key))[lanes],
                                      err_msg=key)


def _state_close(out, ref, lanes=slice(None)):
    for kind in ref.state:
        for key in ref.state[kind]:
            a = np.asarray(ref.state[kind][key])[lanes]
            np.testing.assert_allclose(
                out.state[kind][key].numpy()[lanes], a, rtol=RTOL,
                atol=RTOL * max(1e-300, float(np.abs(a).max())),
                err_msg=f"{kind}.{key}")


def test_cmos_ring5_parts_from_jax_only_where_rounding_grows():
    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine.tran import build_config
    from toyspice_tpu.netlist.parser import parse as jax_parse

    from test_torch_general import spread

    tp = jax_compile(jax_parse(DECK)).netlist.tran
    cfg = build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    ov = spread(DECK, ("C",), lanes=2)
    ref, out = _both(cfg._replace(max_attempts=11), ov)
    _counters_equal(out, ref)
    _state_close(out, ref)
    ref, out = _both(cfg._replace(max_attempts=14), ov)
    _counters_equal(out, ref)
    ref, out = _both(cfg, ov)
    _counters_equal(out, ref, 1)
    _state_close(out, ref, 1)
    assert bool(out.fail.all()) and bool(np.asarray(ref.fail).all())
    assert int(out.accepted[0]) == 36 and int(ref.accepted[0]) == 8
