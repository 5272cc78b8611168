"""The block bucket past its shared-memory fit on the CPU: a 180-stage RC
ladder (np1 = 183), whose block slice outgrows a block's shared memory so
that the card runs it on the device-memory workspace
(``ops/run.py block_place``/``block_work``).  Its transient through
``make_tran_batch`` (engine "run", the plain version of the block bucket;
with ``store='full'`` engine "store"), 2 lanes with R and C spread from a
numpy seed, held to the JAX package's general engine at the standing bar
(counters equal per lane, state and t_final within rtol 1e-9 of each
leaf's largest value), to 0.02 ms; and a string of 180 diodes (np1 = 183)
takes the OP and DC sweep kernels (engine "fused").  About 120 s on one
core, nearly all of it the JAX engine's compile.
"""

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.ops import dc, op, run

from test_torch_block_bucket import LANES, _port_tran
from test_torch_wide_bucket import diode_string, rc_ladder

DECK = rc_ladder(180, "0.02m")


def test_np1_183_runs_on_the_block_bucket_and_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches

    cc = ts.compile_circuit(ts.parse(DECK))
    plan = run.make_plan(cc)
    assert cc.np1 == 183 and not run.run_placement(plan)[2]
    cfg, params_np, ref = jax_reference(DECK, spread(DECK, ("R", "C"),
                                                     lanes=LANES))
    assert ts.make_tran_batch(cc, cfg, None, store="full").engine == "store"
    out = _port_tran(DECK, cfg, params_np)
    assert_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())


def test_np1_183_op_and_sweep_take_the_kernels():
    cc = ts.compile_circuit(ts.parse(diode_string(180)))
    plan = run.make_plan(cc, "op")
    assert cc.np1 == 183 and select_op_engine(cc)[0] == "fused"
    for mod in (op, dc):
        lane = mod.lane_doubles(plan)
        assert run.placement(plan, lane) == (run.BLOCK_BUCKET, True, False)
