"""The 5-stage version of chip_smoke.py phase 38's NMOS ring oscillator
(``nmos_ring`` of tests/test_torch_past_caps.py, to 300 ns with UIC), 2
lanes with R and C spread log-normally by 0.1 from numpy seed 0, through
``make_tran_batch`` (engine "run": the run kernel's plain version on the
CPU) against the JAX package's general engine at the standing bar:
counters equal per lane, state and junction voltages within rtol 1e-9.
The ring oscillates: every node swings between the rails.

Then the one lane of chip_smoke.py phase 38's 101-stage ring at 8192 lanes
(R then C spread log-normally by 0.1 from numpy seed 0, ``rc_spread``)
whose node leaves the rails: from 10.7 ns lane 337's n53 alternates, one
accepted step to the next, between a value inside the rails and one just
below -100 V (-100.76 V, then -100.07 V and closer), to tstop.  -100 V is
-1 / LAMBDA, where the level-1 current's factor (1 + LAMBDA Vds) of MN52
changes sign: both packages apply the level-1 equations at a negative Vds
without exchanging drain and source.  The test holds that lane's first 15
ns, stored, to the JAX package's general engine at the standing bar."""

import numpy as np

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_past_caps import nmos_ring

LANES = 2
RTOL = 1e-9
DECK = nmos_ring(5, "300n")
# phase 38's lane whose node leaves the rails, of its 8192
RING101_LANE = 337


def test_nmos_ring5_runs_on_the_run_kernel_and_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches
    from test_torch_run_nonlinear import assert_jv_matches

    cfg, params_np, ref = jax_reference(DECK, spread(DECK, ("R", "C"),
                                                     lanes=LANES),
                                        store="full")
    cc = ts.compile_circuit(ts.parse(DECK))
    fn = ts.make_tran_batch(cc, cfg, None, store="full")
    assert fn.engine == "store", fn.engine_reason
    out = fn(params_from_numpy(params_np, device="cpu"),
             ts.init_state(cc, device="cpu"))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())
    np.testing.assert_array_equal(out.out_n.numpy(), np.asarray(ref.out_n))
    nodes = [cc.netlist.nodes[f"n{i}"] for i in range(5)]
    for lane in range(LANES):
        v = out.out_x[lane, :int(out.out_n[lane])][:, nodes].numpy()
        assert v.min() < 0.5 and v.max() > 2.5
        assert (np.diff(v > 2.5, axis=0) != 0).sum() >= 20


def test_nmos_ring101_lane_off_the_rails_matches_jax():
    import jax

    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine.batch import batch_params as jax_batch_params
    from toyspice_tpu.engine.state import init_state as jax_init_state
    from toyspice_tpu.engine.tran import build_config, make_tran
    from toyspice_tpu.netlist.parser import parse as jax_parse

    from test_torch_run import assert_matches
    from test_torch_run_nonlinear import assert_jv_matches

    deck = nmos_ring(101, "100n")
    jcc = jax_compile(jax_parse(deck))
    rng = np.random.default_rng(0)
    ov = {k: {"value": (np.asarray(jcc.params[k]["value"])[None] * np.exp(
        rng.normal(0.0, 0.1, (8192, len(jcc.params[k]["value"])))))[
            [RING101_LANE]]} for k in ("R", "C")}
    tp = jcc.netlist.tran
    cfg = build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax,
                       tp.uic)._replace(tstop=15e-9)
    params, axes = jax_batch_params(jcc, ov)
    ref = jax.jit(jax.vmap(make_tran(jcc, cfg, store="full"),
                           in_axes=(axes, None)))(params, jax_init_state(jcc))
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None, store="full")
    assert fn.engine == "store", fn.engine_reason
    out = fn(params_from_numpy({k: {kk: np.asarray(v) for kk, v in t.items()}
                                for k, t in params.items()}, device="cpu"),
             ts.init_state(cc, device="cpu"))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not bool(out.fail.any()) and float(out.t_final[0]) == 15e-9
    n = int(out.out_n[0])
    assert n == int(ref.out_n[0])
    x, want = out.out_x[0, :n].numpy(), np.asarray(ref.out_x[0, :n])
    np.testing.assert_allclose(x, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())
    # n53 off the rails on every other row from 10.7 ns, at -1 / LAMBDA
    lam = float(np.asarray(cc.params["M"]["lam"]).flat[0])
    nodes = [cc.netlist.nodes[f"n{i}"] for i in range(101)]
    v = x[:, nodes]
    off = (v < -0.5) | (v > 5.5)
    j = nodes.index(cc.netlist.nodes["n53"])
    assert not off[:, [i for i in range(101) if i != j]].any()
    assert off[:, j].sum() >= 2
    assert (np.abs(v[off[:, j], j] + 1.0 / lam) < 1.0).all(), v[off[:, j], j]
