"""The whole-run CUDA kernel against its plain torch version on the card.

Needs a CUDA card and nvcc; skips elsewhere.  On the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.ops import run, run_plan

pytestmark = pytest.mark.needs_cuda

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""

IPWL = """* isrc pwl into rc ladder
.tran 0.02m 1m
I1 0 1 PWL(0 0 0.2m 3m 0.5m 1m)
R1 1 0 1k
C1 1 0 0.2u
C2 1 2 0.1u
R2 2 0 2k
"""

CSERIES = """* capacitor chain
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 0 1k
C1 1 2 1u
C2 2 0 1u
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(deck, lanes, device, edit=None):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(4)
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params[k]["value"]))))}
        for k in ("R", "L", "C") if k in cc.params}
    if edit:
        edit(ov)
    params, _ = ts.batch_params(cc, ov, device=device)
    state0 = ts.init_state(cc, device=device)
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, lanes, device)
    src = run_plan.source_stack(plan, params, lanes, device)
    st = run_plan.init_state_stack(plan, state0, lanes, device)
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    return cc, cfg, params, state0, plan, dev, src, st, sc


def _assert_same(k, p):
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float64:
            scale = b.abs().amax().clamp_min(1e-300)
            assert bool(((a - b).abs() <= 1e-9 * scale).all())
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("deck,lanes,max_attempts", [
    (IPWL, 64, None), (RLC, 256, 3000)], ids=["ipwl", "rlc_3000"])
def test_kernel_matches_plain(cuda, deck, lanes, max_attempts):
    *_, plan, dev, src, st, sc = _inputs(deck, lanes, cuda)
    if max_attempts:
        sc = sc._replace(max_attempts=max_attempts)
    before = run.launch_run_kernel.launches
    k = run.launch_run_kernel(plan, dev, src, st, sc)
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == before + 1
    _assert_same(k, run.run_plain(plan, dev, src, st, sc))


def test_zero_pivot_and_nan_lanes_end_failed(cuda):
    def zero_caps(ov):
        ov["C"]["value"][1] = 0.0

    *_, plan, dev, src, st, sc = _inputs(CSERIES, 4, cuda, zero_caps)
    k = run.launch_run_kernel(plan, dev, src, st, sc)
    _assert_same(k, run.run_plain(plan, dev, src, st, sc))
    assert k.fail.tolist() == [0, 1, 0, 0]
    nan = sc._replace(minstep=float("nan"))
    k = run.launch_run_kernel(plan, dev, src, st, nan)
    assert k.fail.tolist() == [1] * 4 and k.attempts.tolist() == [0] * 4


def test_main_path_launches_the_kernel_once(cuda):
    cc, cfg, params, state0, *_ = _inputs(IPWL, 32, cuda)
    fn = ts.make_tran_batch(cc, cfg, None, store="none")
    before = run.launch_run_kernel.launches
    out = fn(params, state0)
    assert run.launch_run_kernel.launches == before + 1
    assert fn.engine == "run" and out.t_final.is_cuda
    assert not out.fail.any()
