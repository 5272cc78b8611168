"""The port's Newton transient on decks in the run kernel's 16 and 32 size
buckets, on the CPU (``make_tran_batch``: the plain version of the OP
kernel, then the plain version of the run kernel's Newton instantiation),
against the JAX package's general engine (engine/tran.py ``make_tran``,
vmapped): the diode clamp ladders of np1 = 16 (13 diodes) and np1 = 32 (16
diodes, the kernel's device cap) under compat, the first also under
physics and the trapezoidal rule, and a mixed deck at the 16-device cap
(6 diodes, 4 BJTs, 6 MOSFETs; np1 = 32) under compat.  These are the decks
on which ``tests/test_torch_cuda.py`` holds the kernel to the plain
version on the card.

``accepted``, ``attempts``, ``fail`` and ``nr_iters`` equal per lane;
state, junction voltages and t_final within rtol 1e-9 (both sides f64),
except, on the mixed deck, the capacitors' state (the node voltages and
charges the MOSFETs drive) and the MOSFETs' junction voltages: its
level-2 and level-3 MOSFETs' conductances are differences of two currents
1e-6 V apart, which hold the general engine there to ``MOS23_RTOL``
(tests/test_torch_run_nonlinear.py says why; with level-1 models in their
place neither engine converges on this chain from x = 0).  The mixed
deck's diodes and BJTs and every other state row stay at 1e-9.
Three lanes each, R and C spread log-normally; inputs are made with numpy
from a seed and handed to both packages."""

import numpy as np
import pytest

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.netlist.parser import parse as jax_parse

from test_torch_cuda import MIXED16, newton_ladder
from test_torch_physics_run import (assert_physics_matches, port,
                                    reference as physics_reference, spread)
from test_torch_run import RTOL, assert_matches, lognormal, reference
from test_torch_run_nonlinear import (MOS23_RTOL, assert_jv_matches,
                                      port_batch)

def _compat(deck, lanes=3, seed=13):
    cc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(seed)
    ov = {k: {"value": lognormal(rng, cc.params[k]["value"], lanes)}
          for k in ("R", "C")}
    cfg, _, params_np, ref = reference(deck, ov)
    out = port_batch(deck, cfg, params_np)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not out.fail.any()
    assert bool((out.nr_iters > out.attempts).all())  # Newton ran
    return cc, out


@pytest.mark.parametrize("np1", [16, 32])
def test_diode_ladder_matches_general_engine(np1):
    cc, out = _compat(newton_ladder(np1))
    assert cc.np1 == np1
    assert out.jv["D"]["vd"].shape == (3, min(np1 - 3, 16))


def test_diode_ladder_physics_trap_matches_general_engine():
    deck = newton_ladder(16)
    cfg, params_np, ref = physics_reference(deck, spread(deck, lanes=3),
                                            "trap")
    out = port(deck, cfg, params_np, "trap")
    assert_physics_matches(out, ref, cfg)
    assert not out.fail.any()
    assert bool((out.state["D"]["hist"] == 1).all())


def test_mixed_devices_at_the_cap_match_general_engine():
    cc = jax_compile(jax_parse(MIXED16))
    assert cc.np1 == 32
    rng = np.random.default_rng(13)
    ov = {k: {"value": lognormal(rng, cc.params[k]["value"], 3)}
          for k in ("R", "C")}
    cfg, _, params_np, ref = reference(MIXED16, ov)
    out = port_batch(MIXED16, cfg, params_np)
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        np.testing.assert_array_equal(getattr(out, key).numpy(),
                                      np.asarray(getattr(ref, key)),
                                      err_msg=key)
    np.testing.assert_allclose(out.t_final.numpy(), np.asarray(ref.t_final),
                               rtol=RTOL, atol=0)
    assert not out.fail.any()
    assert bool((out.nr_iters > out.attempts).all())
    for tree, rtree, loose in ((out.state, ref.state, "C"),
                               (out.jv, ref.jv, "M")):
        assert set(tree) == set(rtree)
        for kind in rtree:
            tol = MOS23_RTOL if kind == loose else RTOL
            for key in rtree[kind]:
                a = np.asarray(rtree[kind][key])
                f = tree[kind][key].numpy()
                scale = max(1e-300, float(np.max(np.abs(a))))
                np.testing.assert_allclose(f, a, rtol=tol, atol=tol * scale,
                                           err_msg=f"{kind}.{key}")
    assert {k: v[next(iter(v))].shape[1] for k, v in out.jv.items()} == {
        "D": 6, "Q": 4, "M": 6}
