"""Cut versions of chip_smoke.py phase 38's coupled bus (``bus`` of
tests/test_torch_past_caps.py: a PULSE source, 50 Ω and 1 pF a line,
neighbours coupled by 0.2 pF): 3 lines to 10 ns, and 40 lines (40
sources, past the kernels' former cap of 32; np1 = 121, the block bucket)
to 2 ns, 2 lanes with R and C spread log-normally by 0.1 from numpy seed
0, through ``make_tran_batch`` (engine "run": the run kernel's plain
version on the CPU) against the JAX package's general engine at the
standing bar: counters equal per lane, state within rtol 1e-9."""

import pytest

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.ops import run

from test_torch_past_caps import bus

LANES = 2


@pytest.mark.parametrize("lines,tstop,bucket", [
    (3, "10n", 16), (40, "2n", run.BLOCK_BUCKET)], ids=["bus3", "bus40"])
def test_bus_runs_on_the_run_kernel_and_matches_jax(lines, tstop, bucket):
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches

    deck = bus(lines, tstop)
    cfg, params_np, ref = jax_reference(deck, spread(deck, ("R", "C"),
                                                     lanes=LANES))
    cc = ts.compile_circuit(ts.parse(deck))
    assert run.run_bucket(run.make_plan(cc)) == bucket
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run", fn.engine_reason
    out = fn(params_from_numpy(params_np, device="cpu"),
             ts.init_state(cc, device="cpu"))
    assert_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())
