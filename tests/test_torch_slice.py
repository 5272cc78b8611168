"""The whole slice on the CPU: bench.py's workload (the RLC deck,
perturbed as bench.py perturbs it, compat, store='none') through the
port's entry points, with the JAX package's parameters carried across by
``convert.params_from_numpy``, against the JAX general engine at full
tstop (23,656 attempts per lane at nominal values)."""

import numpy as np

import jax

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.engine.tran import make_tran
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy

from test_torch_run import assert_matches

LANES = 4

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def test_bench_deck_through_make_tran_batch():
    cc = jax_compile(jax_parse(RLC))
    tp = cc.netlist.tran
    cfg = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(0)

    def perturb(base, spread=0.1):  # bench.py's perturbation
        return base[None, :] * np.exp(
            rng.normal(0.0, spread, size=(LANES, base.shape[0])))

    overrides = {k: {"value": perturb(np.asarray(cc.params[k]["value"]))}
                 for k in ("R", "L", "C")}
    params, axes = jax_batch_params(cc, overrides)
    ref = jax.jit(jax.vmap(make_tran(cc, cfg, store="none"),
                           in_axes=(axes, None)))(params, jax_init_state(cc))

    pcc = ts.compile_circuit(ts.parse(RLC))
    pcfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    pparams = params_from_numpy(
        {k: {kk: np.asarray(v) for kk, v in t.items()}
         for k, t in params.items()}, device="cpu")
    fn = ts.make_tran_batch(pcc, pcfg, axes, store="none")
    assert fn.engine == "run"
    out = fn(pparams, ts.init_state(pcc, device="cpu"))
    assert_matches(out, ref)
    assert int(out.attempts[0]) > 20000  # the full run, at minstep pace
    assert not out.fail.any()
    assert out.t_final.tolist() == [cfg.tstop] * LANES
