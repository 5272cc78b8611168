"""The port's graft entry points (toyspice_tpu_torch/parallel/dryrun.py)
on the CPU: ``entry()`` against ``__graft_entry__.entry()`` of the JAX
package (the accepted count equal, the state within rtol 1e-9, as
tests/test_torch_run.py holds the transient), and ``dryrun_multichip`` on
CPU shards, its report and its summed count against the port's unsharded
batch run on the same lanes."""

import re

import jax
import numpy as np
import pytest

import __graft_entry__

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.parallel import dryrun

RTOL = 1e-9


def test_entry_matches_graft_entry():
    fn_j, args_j = __graft_entry__.entry()
    acc_j, state_j = jax.jit(fn_j)(*args_j)
    fn, args = dryrun.entry(device="cpu")
    acc, state = fn(*args)
    assert int(acc) == int(acc_j) > 0
    for kind in state_j:
        for key in state_j[kind]:
            a = np.asarray(state_j[kind][key])
            np.testing.assert_allclose(
                state[kind][key].numpy(), a, rtol=RTOL,
                atol=RTOL * max(1e-300, float(np.abs(a).max())),
                err_msg=f"{kind}.{key}")


def _unsharded_total(n):
    """The accepted steps of dryrun_multichip(n)'s batch, run unsharded."""
    cc = ts.compile_circuit(ts.parse(dryrun.RLC_TINY))
    rng = np.random.default_rng(0)
    params, axes = ts.batch_params(
        cc, dryrun._spread(cc, "R", rng, 2 * n), device="cpu")
    out = ts.make_tran_batch(cc, dryrun._config(cc), axes)(
        params, ts.init_state(cc, device="cpu"))
    return int(out.accepted.sum())


@pytest.mark.parametrize("n", [8, 1])
def test_dryrun_multichip_on_cpu_shards(n, capsys):
    dryrun.dryrun_multichip(n, device="cpu")
    text = capsys.readouterr().out
    m = re.search(r"dryrun_multichip OK: (\d+) devices, batch (\d+), "
                  r"aggregate accepted steps (\d+)", text)
    assert m and (int(m[1]), int(m[2])) == (n, 2 * n), text
    assert int(m[3]) == _unsharded_total(n)
    assert ("2-D mesh 4x2 AC batch 8 x 16 freqs OK" in text) == (n == 8)
    assert "sharded OP + DC sweep (5 pts) OK" in text
    assert "tran engine=run (" in text
    assert "op engine=fused (" in text and "dc engine=fused (" in text
