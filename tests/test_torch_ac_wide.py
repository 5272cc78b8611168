"""The port's AC past np1 = 32 on the CPU, where the AC kernel now takes
every np1 as the JAX package's does: ``make_ac_batch`` gives engine
"fused" (one ``assemble_ac_blocks`` at omega = 1, then the AC solve of
every (instance, frequency) system: ``ac_plain`` here, on the card
csrc/ac_kernel.cu's block bodies).  Two decks, C spread log-normally by
0.1 from numpy ``default_rng``, 2 lanes, 3 frequencies:

* a 15-section LC ladder (np1 = 34, a 68-row system), its bias the linear
  OP;
* a string of 29 diodes with a capacitor, driven through an AC-only source
  in series with its DC supply (np1 = 34; the reference parser drops the
  AC part of "DC x AC y"), its bias the OP kernel's plain version.

Each is held to the JAX package's ``run_ac_batch``, which on the CPU takes
its general branch (the general bias, one assemble and dense solve per
frequency), and to the port's own general branch (``TOYSPICE_AC=general``)
at tests/test_fused_ac.py's bar: ``converged`` equal per lane, xr and xi
within rtol 2e-9 and atol 2e-9 of the largest |x|."""

import numpy as np
import pytest

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

TOL = 2e-9
LANES = 2


def diode_string_ac(count):
    """``count`` diodes in series from node 2 to ground behind 1 kΩ, a
    10 pF capacitor across the string, 20 V DC with a 10 mV AC source in
    series: np1 = count + 5."""
    lines = [f"* {count} diodes in series, AC", ".ac DEC 3 10k 1000meg",
             "Vdc s 0 DC 20", "Vin 1 s AC 0.01", "R1 1 2 1k", "C1 2 0 10p"]
    lines += [f"D{k} {k + 2} {k + 3} DM" for k in range(count - 1)]
    lines += [f"D{count - 1} {count + 1} 0 DM",
              ".model DM D (Is=1e-14 N=1.2 Cj0=4p Vj=0.8 M=0.4)", ""]
    return "\n".join(lines)


DECKS = {"lc15": lc_ladder(15).replace(".ac dec 21 10k 100meg",
                                       ".ac dec 3 10k 100meg"),
         "diodes29": diode_string_ac(29)}
_refs = {}


def reference(name):
    """(numpy params, freqs, xr, xi, converged) of the JAX package's
    run_ac_batch on the deck, once per deck."""
    if name not in _refs:
        cc = jax_compile(jax_parse(DECKS[name]))
        ap = cc.netlist.ac
        freqs = jax_frequency_points(ap.sweep, ap.fstart, ap.fstop,
                                     ap.points)
        rng = np.random.default_rng(5)
        base = np.asarray(cc.params["C"]["value"])[None, :]
        params, axes = jax_batch_params(cc, {"C": {"value": base * np.exp(
            rng.normal(0, 0.1, (LANES, base.shape[1])))}})
        xr, xi, opr = jax_run_ac_batch(cc, params, axes, jnp.asarray(freqs))
        params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                     for k, t in params.items()}
        _refs[name] = (params_np, freqs, np.asarray(xr), np.asarray(xi),
                       np.asarray(opr.converged))
    return _refs[name]


def port_ac(name, params_np, freqs):
    """(engine, bias engine, xr, xi, converged) of the port's
    make_ac_batch on the CPU under the current TOYSPICE_AC."""
    cc = ts.compile_circuit(ts.parse(DECKS[name]))
    assert cc.np1 == 34
    fn = make_ac_batch(cc, None)
    xr, xi, opr = fn(params_from_numpy(params_np, device="cpu"),
                     ts.init_state(cc, device="cpu"), freqs)
    return (fn.engine, fn.bias_engine, xr.numpy(), xi.numpy(),
            opr.converged.numpy())


def assert_ac_close(got, want):
    xr, xi, conv = got
    xr_ref, xi_ref, conv_ref = want
    np.testing.assert_array_equal(conv, conv_ref)
    assert bool(conv.all())
    assert xr.shape == xr_ref.shape == (LANES, 3, 34)
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max())
    np.testing.assert_allclose(xr, xr_ref, rtol=TOL, atol=TOL * scale)
    np.testing.assert_allclose(xi, xi_ref, rtol=TOL, atol=TOL * scale)
    assert float(np.abs(xi_ref).max()) > 0  # the frequencies matter


@pytest.mark.parametrize("name", sorted(DECKS))
def test_fused_ac_past_32_matches_jax(name, monkeypatch):
    monkeypatch.delenv("TOYSPICE_AC", raising=False)
    params_np, freqs, xr_ref, xi_ref, conv_ref = reference(name)
    engine, bias, xr, xi, conv = port_ac(name, params_np, freqs)
    assert engine == "fused"
    assert bias == ("fused" if name == "diodes29" else "linear")
    assert_ac_close((xr, xi, conv), (xr_ref, xi_ref, conv_ref))


@pytest.mark.parametrize("name", sorted(DECKS))
def test_fused_ac_past_32_matches_the_general_branch(name, monkeypatch):
    params_np, freqs = reference(name)[:2]
    monkeypatch.delenv("TOYSPICE_AC", raising=False)
    fused = port_ac(name, params_np, freqs)
    monkeypatch.setenv("TOYSPICE_AC", "general")
    general = port_ac(name, params_np, freqs)
    assert (fused[0], general[0]) == ("fused", "general")
    assert_ac_close(fused[2:], general[2:])
