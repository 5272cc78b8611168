"""The port's physics waveforms and resume on the CPU (the plain version of
the run kernel's PHYS store instantiation) on the half-wave rectifier
under the trapezoidal rule:

* ``store='full'`` against the JAX package's general engine
  (``make_tran(semantics="physics", store="full")``, vmapped): ``out_n``
  equal per lane, ``out_x``/``out_t`` within rtol 1e-9 of their scale,
  and the counters and state at the bar of
  tests/test_torch_physics_run.py;
* the streamed store (``run_transient_streamed``) bit for bit with the
  monolithic one, the physics rows carried chunk to chunk;
* a physics resume from a run cut at half its attempts against the
  general engine's resume flavour (``make_tran(resume=True)``) from the
  same checkpoint: no OP, the checkpoint's state (C i0 and hist, the
  diode's charge memory) and junction voltages."""

import numpy as np
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.options import SimOptions as JaxOptions
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from test_torch_physics_run import (RTOL, assert_physics_matches, deck_file,
                                    port, reference, spread)

HWR = deck_file("half_wave_rectifier.cir")
TRAP = ts.SimOptions(integration="trap")


def test_store_full_matches_general_engine():
    cfg, params_np, ref = reference(HWR, spread(HWR, lanes=3), "trap",
                                    store="full")
    out = port(HWR, cfg, params_np, "trap", store="full", engine="store")
    assert_physics_matches(out, ref, cfg)
    np.testing.assert_array_equal(out.out_n.numpy(), np.asarray(ref.out_n))
    assert not bool(out.store_overflow.any())
    n = int(out.out_n.max())
    for key in ("out_x", "out_t"):
        a = np.asarray(getattr(ref, key))[:, :n]
        np.testing.assert_allclose(getattr(out, key)[:, :n].numpy(), a,
                                   rtol=RTOL,
                                   atol=RTOL * float(np.abs(a).max()),
                                   err_msg=key)


def test_streamed_store_equals_the_monolithic_one():
    cc = ts.compile_circuit(ts.parse(HWR))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, spread(HWR, lanes=3, seed=5),
                                device="cpu")
    state0 = ts.init_state(cc, device="cpu")
    whole = ts.make_tran_batch(cc, cfg, None, semantics="physics",
                               store="full", opts=TRAP)(params, state0)
    chunks = list(ts.stream_transient_chunks(cc, cfg, params, state0, 64,
                                             semantics="physics",
                                             opts=TRAP))
    assert len(chunks) > 3
    st = ts.run_transient_streamed(cc, cfg, params, state0, 64,
                                   semantics="physics", opts=TRAP)
    assert torch.equal(st.out_n, whole.out_n)
    n = int(whole.out_n.max())
    assert torch.equal(st.out_x, whole.out_x[:, :n])
    assert torch.equal(st.out_t, whole.out_t[:, :n])
    for key in ("accepted", "attempts", "nr_iters", "t_final", "dt_final"):
        assert torch.equal(getattr(st, key), getattr(whole, key)), key
    for kind in whole.state:
        for key in whole.state[kind]:
            assert torch.equal(st.state[kind][key],
                               whole.state[kind][key]), (kind, key)


def test_resume_matches_general_engine_resume():
    pcc = ts.compile_circuit(ts.parse(HWR))
    jcc = jax_compile(jax_parse(HWR))
    tp = pcc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params_jax, axes = jax_batch_params(jcc, spread(HWR, lanes=3, seed=8))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params_jax.items()}
    params = params_from_numpy(params_np, device="cpu")
    state0 = ts.init_state(pcc, device="cpu")
    whole = ts.make_tran_batch(pcc, cfg, None, semantics="physics",
                               opts=TRAP)(params, state0)
    half = int(whole.attempts.min()) // 2
    leg1 = ts.make_tran_batch(pcc, cfg._replace(max_attempts=half), None,
                              semantics="physics", opts=TRAP)(params, state0)
    fn = ts.make_tran_batch(pcc, cfg, None, semantics="physics", opts=TRAP,
                            resume=True)
    assert fn.engine == "store" and fn.op is None
    rest = fn(params, leg1.state, leg1.t_final, leg1.jv, leg1.dt_final,
              leg1.attempts)
    # the two legs are the one-piece run
    assert torch.equal(rest.attempts, whole.attempts)
    assert torch.equal(leg1.accepted + rest.accepted, whole.accepted)
    assert torch.equal(rest.t_final, whole.t_final)
    for kind in whole.state:
        for key in whole.state[kind]:
            assert torch.equal(rest.state[kind][key],
                               whole.state[kind][key]), (kind, key)
    # the general engine's resume from the same checkpoint
    jfn = jax.jit(jax.vmap(
        make_tran(jcc, cfg, semantics="physics", store="none",
                  opts=JaxOptions(integration="trap"), resume=True),
        in_axes=(axes, 0, 0, 0, 0)))
    tree = {k: {kk: np.asarray(v) for kk, v in t.items()}
            for k, t in leg1.state.items()}
    jv0 = {k: {kk: np.asarray(v) for kk, v in t.items()}
           for k, t in leg1.jv.items()}
    ref = jfn(params_jax, tree, leg1.t_final.numpy(), jv0,
              leg1.dt_final.numpy())
    rest_this_call = rest._replace(attempts=rest.attempts - leg1.attempts)
    assert_physics_matches(rest_this_call, ref, cfg)
