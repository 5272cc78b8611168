"""The Newton transient of the block bucket (np1 past 64, a lane on a
whole block, ``tests/test_torch_block_bucket.py`` says how) on the CPU:
a 62-stage RC ladder ending in a diode clamp (np1 = 66) through
``make_tran_batch`` (engine "run": the OP kernel's plain version, then the
run kernel's), compat and physics/trap, 2 lanes from numpy seeds, each
held to the JAX package's general engine called directly (~140 s on one
core, nearly all of it the JAX engine's compiles).

Tolerance: the standing bar.  ``accepted``, ``attempts``, ``fail`` and
``nr_iters`` equal per lane, and state, jv and t_final within rtol 1e-9 of
each leaf's largest value.
"""

import toyspice_tpu_torch as ts

from test_torch_block_bucket import LANES, _port_tran, clamped_ladder

CLAMPED = clamped_ladder(62)


def test_clamped_ladder_runs_on_the_block_bucket_and_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches
    from test_torch_run_nonlinear import assert_jv_matches

    cc = ts.compile_circuit(ts.parse(CLAMPED))
    assert cc.np1 == 66 and cc.kind_count("D") == 1
    cfg, params_np, ref = jax_reference(CLAMPED, spread(
        CLAMPED, ("R", "C"), lanes=LANES))
    out = _port_tran(CLAMPED, cfg, params_np)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())


def test_clamped_ladder_physics_trap_matches_jax():
    from test_torch_physics_run import (assert_physics_matches, reference,
                                        spread)

    cfg, params_np, ref = reference(CLAMPED, spread(CLAMPED, ("R", "C"),
                                                    LANES), "trap")
    out = _port_tran(CLAMPED, cfg, params_np, semantics="physics",
                     opts=ts.SimOptions(integration="trap"))
    assert_physics_matches(out, ref, cfg)
    assert not bool(out.fail.any())
