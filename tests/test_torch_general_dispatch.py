"""Decks past the kernels' caps take the port's general engine through the
user's entry points, as they take the JAX package's:

* the 16-stage Cockcroft-Walton multiplier (np1 = 35, 32 diodes), cut to
  0.1 ms, 4 lanes with C spread: ``make_tran_batch`` gives engine
  "general" with the kernels' reason, and the run matches the JAX general
  engine at the standing bar (counters equal per lane, state and jv within
  rtol 1e-9); its streamed store raises ValueError, as the JAX package's
  does;
* the OP and DC sweep of a deck of 17 diodes: ``select_op_engine`` gives
  "general", and ``run_op_batch`` and ``run_dc_batch`` run it;
* the AC of a 16-section LC ladder (a 72 x 72 system): ``make_ac_batch``
  gives "general", and the ladder passes half the source to its load up to
  1 MHz and nothing far above its cutoff."""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.ac import make_ac_batch
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.ops.solve import NBIG

from test_torch_general import (cockcroft_walton, jax_reference,
                                port_general, spread)
from test_torch_general_analyses import lc_ladder
from test_torch_run import assert_matches
from test_torch_run_nonlinear import assert_jv_matches

CW16 = cockcroft_walton(16, "0.1m")


def test_cw16_takes_the_general_engine_and_matches_jax():
    cfg, params_np, ref = jax_reference(CW16, spread(CW16, ("C",)))
    cc = ts.compile_circuit(ts.parse(CW16))
    assert cc.np1 == 35 and cc.kind_count("D") == 32
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "general"
    assert "np1=35 exceeds the kernel's matrix cap of 32" in fn.engine_reason
    out = fn(params_from_numpy(params_np, device="cpu"),
             ts.init_state(cc, device="cpu"))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())
    direct = port_general(CW16, cfg, params_np)
    assert torch.equal(direct.nr_iters, out.nr_iters)
    with pytest.raises(ValueError, match="streamed store"):
        ts.make_tran_stream(cc, cfg, 64)
    with pytest.raises(ValueError, match="streamed store"):
        next(ts.stream_transient_chunks(
            cc, cfg, ts.batch_params(cc, {}, device="cpu")[0],
            ts.init_state(cc, device="cpu"), 64))
    resumed = ts.make_tran_batch(cc, cfg, None, resume=True)
    assert resumed.engine == "general"


def _diodes(n):
    lines = ["* diode string", ".dc V1 0 2 0.5", "V1 1 0 DC 1"]
    for k in range(n):
        lines.append(f"R{k} 1 {k + 2} 1k")
        lines.append(f"D{k} {k + 2} 0 DM")
    lines.append(".model DM D (Is=1e-14)")
    return "\n".join(lines) + "\n"


def test_op_and_dc_past_the_device_cap_take_the_general_engine():
    cc = ts.compile_circuit(ts.parse(_diodes(17)))
    engine, reason = select_op_engine(cc)
    assert engine == "general" and "17 diodes" in reason
    params, _ = ts.batch_params(cc, {"R": {"value": np.full((3, 17), 1e3)
                                           * np.arange(1, 4)[:, None]}},
                                device="cpu")
    op = ts.run_op_batch(cc, params)
    assert bool(op.converged.all()) and op.stage.tolist() == [0, 0, 0]
    # 1 V through R into a forward diode: between 0.4 and 0.7 V
    vd = op.x[:, 2:19]
    assert bool(((vd > 0.4) & (vd < 0.7)).all())
    xs, conv = ts.run_dc_batch(cc, (0,), params, None,
                               ts.sweep_values(0.0, 2.0, 0.5))
    assert xs.shape == (3, 5, cc.np1) and bool(conv.all())
    torch.testing.assert_close(xs[:, 2], op.x, rtol=1e-6, atol=1e-9)


def test_lc16_ac_takes_the_general_engine():
    deck = lc_ladder(16)
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 36 and 2 * cc.np1 <= NBIG
    fn = make_ac_batch(cc, None)
    assert fn.engine == "general"
    assert "np1=36 exceeds the AC kernel's matrix cap of 32" in \
        fn.engine_reason
    ap = cc.netlist.ac
    freqs = ts.frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    assert len(freqs) == 21
    params, _ = ts.batch_params(cc, {}, device="cpu")
    xr, xi, opr = fn(params, ts.init_state(cc, device="cpu"), freqs)
    out = cc.netlist.nodes["n16"]
    mag = torch.sqrt(xr[0, :, out] ** 2 + xi[0, :, out] ** 2).numpy()
    assert np.allclose(mag[freqs <= 1e6], 0.5, atol=1e-3)
    assert mag[freqs >= 3e7].max() < 1e-3
