"""The AC past n = 128 on the CPU: a 31-section LC ladder (np1 = 66, so
(132, 132) AC systems: on the card the AC kernel's wide register body,
and under ``TOYSPICE_AC=general`` the GJ kernel's), 2 lanes with C spread
log-normally by 0.1, three frequencies, through ``run_ac_batch`` (engine
"fused": the linear OP's stamped solve as the bias, then one AC solve of
every (lane, frequency) system, the AC kernel's plain version) and
through the general branch (one dense solve of the assembled systems),
each against the JAX package's ``run_ac_batch`` (which on the CPU takes
its general branch), computed once, on the same numpy inputs: converged
equal, xr and xi within rtol 1e-9 of their scale."""

import numpy as np

import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.ac import frequency_points as jax_frequency_points
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.batch import run_ac_batch as jax_run_ac_batch
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.ac import make_ac_batch

from test_torch_general_analyses import lc_ladder
from test_torch_run import RTOL

LANES = 2


def test_past_nbig_ac_matches_jax(monkeypatch):
    deck = lc_ladder(31).replace(".ac dec 21 10k 100meg",
                                 ".ac dec 3 10k 100meg")
    cc = jax_compile(jax_parse(deck))
    ap = cc.netlist.ac
    freqs = jax_frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
    assert len(freqs) == 3
    rng = np.random.default_rng(3)
    base = np.asarray(cc.params["C"]["value"])[None, :]
    params, axes = jax_batch_params(cc, {"C": {"value": base * np.exp(
        rng.normal(0, 0.1, (LANES, base.shape[1])))}})
    xr_ref, xi_ref, opr = jax_run_ac_batch(cc, params, axes,
                                           jnp.asarray(freqs))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    pc = ts.compile_circuit(ts.parse(deck))
    assert pc.np1 == 66
    xr_ref, xi_ref = np.asarray(xr_ref), np.asarray(xi_ref)
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max())
    assert float(np.abs(xi_ref).max()) > 0
    for env, engine in ((None, "fused"), ("general", "general")):
        if env is None:
            monkeypatch.delenv("TOYSPICE_AC", raising=False)
        else:
            monkeypatch.setenv("TOYSPICE_AC", env)
        assert make_ac_batch(pc).engine == engine
        xr, xi, out = ts.run_ac_batch(pc, params_from_numpy(params_np,
                                                            device="cpu"),
                                      None, freqs)
        np.testing.assert_array_equal(out.converged.numpy(),
                                      np.asarray(opr.converged))
        assert bool(out.converged.all())
        assert xr.shape == xr_ref.shape == (LANES, 3, 66)
        np.testing.assert_allclose(xr.numpy(), xr_ref, rtol=RTOL,
                                   atol=RTOL * scale)
        np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=RTOL,
                                   atol=RTOL * scale)
