"""Decks the kernels take since their 64-row bucket, and decks past the
kernels' caps, through the user's entry points, against the JAX package:

* the 16-stage Cockcroft-Walton multiplier (np1 = 35, 32 diodes), cut to
  0.1 ms, 4 lanes with C spread: ``make_tran_batch`` gives engine "run"
  (the run kernel's 64-row bucket, whose eligibility the JAX package's
  ``run_ineligible_reason`` would give it too), and under
  ``TOYSPICE_TRAN=general`` engine "general"; each run matches the JAX
  general engine at the standing bar (counters equal per lane, state and
  jv within rtol 1e-9); its streamed store now runs, on the store
  kernel's 64-row bucket, and a resumed run takes the store engine;
* the OP and DC sweep of 17 resistor-fed banks of 48 diodes (816 diodes,
  a stamp plan past the kernels' former 48 KB table): ``select_op_engine``
  gives "fused" (the OP and DC sweep kernels, their plain versions on the
  CPU), and "general" under ``TOYSPICE_OP=general``; ``run_op_batch`` and
  ``run_dc_batch`` run both, and they agree;
* the AC of a 16-section LC ladder (a 72 x 72 system): ``make_ac_batch``
  gives "fused" (the AC kernel takes every np1), and "general" under
  ``TOYSPICE_AC=general``; on both the ladder passes half the source to
  its load up to 1 MHz and nothing far above its cutoff."""

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


def test_cw16_takes_the_general_engine_and_matches_jax(monkeypatch):
    cfg, params_np, ref = jax_reference(CW16, spread(CW16, ("C",)))
    cc = ts.compile_circuit(ts.parse(CW16))
    assert cc.np1 == 35 and cc.kind_count("D") == 32
    params = params_from_numpy(params_np, device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run"
    out = fn(params, state0)
    with monkeypatch.context() as m:
        m.setenv("TOYSPICE_TRAN", "general")
        fg = ts.make_tran_batch(cc, cfg, None)
        assert fg.engine == "general"
        assert "TOYSPICE_TRAN=general" in fg.engine_reason
        general = fg(params, state0)
    for got in (out, general):
        assert_matches(got, ref)
        assert_jv_matches(got, ref)
        assert not bool(got.fail.any())
        assert bool((got.t_final == cfg.tstop).all())
    direct = port_general(CW16, cfg, params_np)
    assert torch.equal(direct.nr_iters, general.nr_iters)
    # the streamed store: every chunk's rows those of one store='full' run
    whole = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    fns = ts.make_tran_stream(cc, cfg, 8)
    n0 = torch.zeros_like(whole.out_n)
    chunks = list(ts.stream_transient_chunks(cc, cfg, params, state0, 8,
                                             fns=fns))
    assert len(chunks) > 1
    for chunk in chunks:
        for lane in range(whole.out_n.shape[0]):
            a, b = int(n0[lane]), int(chunk.out_n[lane])
            assert torch.equal(chunk.out_x[lane, :b],
                               whole.out_x[lane, a:a + b])
        n0 += chunk.out_n
    assert torch.equal(n0, whole.out_n)
    assert torch.equal(chunks[-1].attempts, out.attempts)
    resumed = ts.make_tran_batch(cc, cfg, None, resume=True)
    assert resumed.engine == "store"


def _diode_banks(nodes, per):
    """``nodes`` nodes fed from 1 V through 1 kΩ each, ``per`` diodes in
    parallel to ground at each."""
    lines = ["* diode banks", ".dc V1 0 2 0.5", "V1 1 0 DC 1"]
    for k in range(nodes):
        lines.append(f"R{k} 1 {k + 2} 1k")
        lines += [f"D{k}_{j} {k + 2} 0 DM" for j in range(per)]
    lines.append(".model DM D (Is=1e-14)")
    return "\n".join(lines) + "\n"


def test_op_and_dc_past_the_device_cap_take_the_general_engine(monkeypatch):
    """816 diodes take the OP and DC sweep kernels; the general engine
    (TOYSPICE_OP=general) gives the same bias and sweep."""
    cc = ts.compile_circuit(ts.parse(_diode_banks(17, 48)))
    params, _ = ts.batch_params(cc, {"R": {"value": np.full((3, 17), 1e3)
                                           * np.arange(1, 4)[:, None]}},
                                device="cpu")
    runs = {}
    for env, want in ((None, "fused"), ("general", "general")):
        if env is None:
            monkeypatch.delenv("TOYSPICE_OP", raising=False)
        else:
            monkeypatch.setenv("TOYSPICE_OP", env)
        engine, reason = select_op_engine(cc)
        assert engine == want, reason
        op = ts.run_op_batch(cc, params)
        assert bool(op.converged.all()) and op.stage.tolist() == [0, 0, 0]
        # 1 V through R into 48 forward diodes: between 0.4 and 0.7 V
        vd = op.x[:, 2:19]
        assert bool(((vd > 0.4) & (vd < 0.7)).all())
        xs, conv = ts.run_dc_batch(cc, (0,), params, None,
                                   ts.sweep_values(0.0, 2.0, 0.5))
        assert xs.shape == (3, 5, cc.np1) and bool(conv.all())
        torch.testing.assert_close(xs[:, 2], op.x, rtol=1e-6, atol=1e-9)
        runs[engine] = op.x, xs
    for a, b in zip(runs["fused"], runs["general"]):
        torch.testing.assert_close(a, b, rtol=1e-9, atol=1e-12)


def test_lc16_ac_takes_the_general_engine(monkeypatch):
    """lc16 takes the AC kernel ("fused") by default and the general
    branch under TOYSPICE_AC=general."""
    deck = lc_ladder(16)
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 36 and 2 * cc.np1 <= NBIG
    ap = cc.netlist.ac
    freqs = ts.frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    assert len(freqs) == 21
    params, _ = ts.batch_params(cc, {}, device="cpu")
    out = cc.netlist.nodes["n16"]
    for env, engine, reason in ((None, "fused", "AC kernel eligible"),
                                ("general", "general",
                                 "TOYSPICE_AC=general override")):
        if env is None:
            monkeypatch.delenv("TOYSPICE_AC", raising=False)
        else:
            monkeypatch.setenv("TOYSPICE_AC", env)
        fn = make_ac_batch(cc, None)
        assert fn.engine == engine and reason in fn.engine_reason
        xr, xi, opr = fn(params, ts.init_state(cc, device="cpu"), freqs)
        assert bool(opr.converged.all())
        mag = torch.sqrt(xr[0, :, out] ** 2 + xi[0, :, out] ** 2).numpy()
        assert np.allclose(mag[freqs <= 1e6], 0.5, atol=1e-3)
        assert mag[freqs >= 3e7].max() < 1e-3
