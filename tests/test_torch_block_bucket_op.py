"""The OP of the block bucket (np1 past 64, a lane on a whole block,
``tests/test_torch_block_bucket.py`` says how) on the CPU: a string of 64
diodes (np1 = 67) through ``run_op_batch`` (engine "fused", the OP
kernel's plain version under the rescue ladders), 2 lanes with R spread
from a numpy seed, against the JAX package's general OP called directly:
converged and stage equal per lane, x and jv within rtol 1e-9 and atol
1e-12, as tests/test_torch_op.py holds them (~70 s on one core, nearly all
of it the JAX engine's compile).
"""

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.ops import op, run

from test_torch_block_bucket import r_draw
from test_torch_wide_bucket import diode_string


def test_diode_string_op_runs_on_the_op_kernel_and_matches_jax():
    from test_torch_op import assert_matches, reference

    deck = diode_string(64)
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 67 and cc.kind_count("D") == 64
    assert select_op_engine(cc)[0] == "fused"
    plan = run.make_plan(cc, "op")
    assert run.placement(plan, op.lane_doubles(plan)) == (
        run.BLOCK_BUCKET, True, True)
    params_np, ref = reference(deck, r_draw(deck, 3))
    out = ts.run_op_batch(cc, params_from_numpy(params_np, device="cpu"))
    assert_matches(out, ref)
    assert bool(out.converged.all())
