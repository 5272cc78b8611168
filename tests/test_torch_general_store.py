"""The port's general engine transient with waveforms and resumed, on the
CPU, against the JAX package's general engine on the same numpy inputs:
``store='full'`` on the 3-stage Cockcroft-Walton multiplier (out_n equal
per lane, out_x and out_t within rtol 1e-9 of their scale), and a resume
(``resume=True``) from the JAX engine's own state, junction voltages, t
and dt halfway through (counters equal, state, jv, t_final and dt_final
within rtol 1e-9), 4 lanes."""

import numpy as np
import torch

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran as jax_make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.tran import make_tran

from test_torch_general import (cockcroft_walton, jax_reference,
                                port_general, spread)
from test_torch_run import RTOL, assert_matches
from test_torch_run_nonlinear import assert_jv_matches

CW3 = cockcroft_walton(3, "0.2m")


def test_general_store_full_matches_jax():
    cfg, params_np, ref = jax_reference(CW3, spread(CW3, ("C",)),
                                        store="full")
    out = port_general(CW3, cfg, params_np, store="full")
    assert_matches(out, ref)
    n = out.out_n.numpy()
    np.testing.assert_array_equal(n, np.asarray(ref.out_n))
    assert (n == out.accepted.numpy()).all() and not bool(
        out.store_overflow.any())
    kmax = int(n.max())
    want_x = np.asarray(ref.out_x)[:, :kmax]
    want_t = np.asarray(ref.out_t)[:, :kmax]
    np.testing.assert_allclose(out.out_x[:, :kmax].numpy(), want_x,
                               rtol=RTOL, atol=RTOL * np.abs(want_x).max())
    np.testing.assert_allclose(out.out_t[:, :kmax].numpy(), want_t,
                               rtol=RTOL, atol=0)
    assert not out.out_x[:, kmax:].any()


def test_general_resume_matches_jax():
    """Both engines resume from the same checkpoint: the JAX engine's
    state, jv, t and dt after the first half of the run."""
    cc = jax_compile(jax_parse(CW3))
    half = jax_compile(jax_parse(CW3.replace(".tran 5u 0.2m",
                                             ".tran 5u 0.1m")))
    tp, hp = cc.netlist.tran, half.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    # the first half with the whole run's step control
    hcfg = cfg._replace(tstop=hp.tstop)
    params, axes = jax_batch_params(cc, spread(CW3, ("C",)))
    first = jax.jit(jax.vmap(jax_make_tran(cc, hcfg, store="none"),
                             in_axes=(axes, None)))(params,
                                                    jax_init_state(cc))
    assert not bool(np.asarray(first.fail).any())
    resumed = jax.jit(jax.vmap(
        jax_make_tran(cc, cfg, store="none", resume=True),
        in_axes=(axes, 0, 0, 0, 0)))
    ref = resumed(params, first.state, first.t_final, first.jv,
                  first.dt_final)

    def tree(t):
        return {k: {kk: torch.as_tensor(np.array(v)) for kk, v in
                    tb.items()} for k, tb in t.items()}

    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pc = ts.compile_circuit(ts.parse(CW3))
    fn = make_tran(pc, cfg, store="none", resume=True)
    out = fn(params_from_numpy(params_np, device="cpu"), tree(first.state),
             torch.as_tensor(np.array(first.t_final)), tree(first.jv),
             torch.as_tensor(np.array(first.dt_final)))
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    np.testing.assert_allclose(out.dt_final.numpy(),
                               np.asarray(ref.dt_final), rtol=RTOL)
    assert bool((out.t_final == cfg.tstop).all())
