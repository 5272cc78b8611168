"""The port's batched AC on the CPU (``run_ac_batch``: the bias through the
plain version of the OP kernel or of the linear OP, then
``assemble_ac_blocks`` at omega = 1 and the plain version of
csrc/ac_kernel.cu) against the JAX package's general engine
(engine/ac.py ``make_ac_batch`` on the CPU: the vmapped general bias and
one assemble and solve per frequency), on ce_amplifier_ac.cir,
tests/test_fused_ac.py's RLC (linear), diode and BJT decks and a
common-source MOSFET deck, R spread per lane.

The bar is the JAX package's own for its fused AC (test_fused_ac.py):
xr and xi within rtol 2e-9 and atol 2e-9 of the largest |x|, and
``converged`` of the bias equal per lane.  Inputs are made with numpy from
a seed and handed to both packages."""

import math
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.ac import frequency_points as jax_frequency_points
from toyspice_tpu.engine.ac import make_ac_batch as jax_make_ac_batch
from toyspice_tpu.engine.batch import batch_params as jax_batch_params
from toyspice_tpu.engine.state import init_state as jax_init_state
from toyspice_tpu.netlist.parser import parse as jax_parse
from toyspice_tpu.ops.assemble import assemble_system_ac as jax_assemble_ac

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.ops import ac as ac_ops
from toyspice_tpu_torch.ops.assemble import assemble_ac_blocks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-9


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# tests/test_fused_ac.py's decks, each signal source written as an AC-only
# source: the reference parser reads "DC x AC y" as a DC source and drops
# the AC part (compiler.py), which leaves those decks with no excitation
BJT_AC = """* bjt3-style AC amplifier
.ac DEC 10 10 100k
VCC 1 0 DC 12
VIN 4 0 AC 1
CIN 4 2 10u
RB1 1 2 100k
RB2 2 0 22k
Q1 3 2 5 QN
RC 1 3 4.7k
RE 5 0 1k
.model QN NPN(Bf=150 Cje=10p Cjc=5p Tf=0.5n)
"""

RLC_AC = """* passive RLC AC
.ac LIN 12 100 10k
Vin 1 0 AC 1 0
R1 1 2 100
L1 2 3 10m
C1 3 0 1u
R2 3 0 1k
"""

DIODE_AC = """* diode AC (gd + jwCj at bias)
.ac DEC 8 100 1meg
Vdc 5 0 DC 0.6
Vin 1 5 AC 0.01
R1 1 2 500
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2 Cj0=4p Vj=0.8 M=0.4)
"""

MOS_AC = """* common-source amplifier with Meyer and junction capacitances
.ac DEC 6 1k 100meg
VDD 1 0 DC 5
VGB 5 0 DC 1.5
VG 2 5 AC 1 30
RG 2 4 1k
RD 1 3 10k
M1 3 4 0 0 NM L=2u W=20u
CL 3 0 1p
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01 CGSO=2n CGDO=1n CGBO=0.5n CBD=20f CBS=20f)
"""


def _freqs(cc):
    ap = cc.netlist.ac
    return jax_frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)


def reference(deck, lanes, seed):
    cc = jax_compile(jax_parse(deck))
    freqs = _freqs(cc)
    rng = np.random.default_rng(seed)
    base = np.asarray(cc.params["R"]["value"])[None, :]
    params, axes = jax_batch_params(cc, {"R": {"value": base * np.exp(
        rng.normal(0, 0.1, (lanes, base.shape[1])))}})
    xr, xi, opr = jax.jit(jax_make_ac_batch(cc, axes))(
        params, jax_init_state(cc), jnp.asarray(freqs))
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    return params_np, freqs, np.asarray(xr), np.asarray(xi), opr


@pytest.mark.parametrize("deck", [
    _deck("ce_amplifier_ac.cir"), RLC_AC, DIODE_AC, BJT_AC, MOS_AC],
    ids=["ce_amplifier_ac", "rlc_linear", "diode", "bjt", "mosfet"])
def test_ac_matches_general_engine(deck):
    params_np, freqs, xr_ref, xi_ref, opr = reference(deck, 3, 2)
    cc = ts.compile_circuit(ts.parse(deck))
    np.testing.assert_array_equal(
        ts.frequency_points(cc.netlist.ac.sweep, cc.netlist.ac.fstart,
                            cc.netlist.ac.fstop, cc.netlist.ac.points),
        freqs)
    xr, xi, out = ts.run_ac_batch(
        cc, params_from_numpy(params_np, device="cpu"), None, freqs)
    np.testing.assert_array_equal(out.converged.numpy(),
                                  np.asarray(opr.converged))
    assert bool(out.converged.all())
    scale = max(np.abs(xr_ref).max(), np.abs(xi_ref).max(), 1e-12)
    assert xr.shape == xr_ref.shape == (3, len(freqs), cc.np1)
    np.testing.assert_allclose(xr.numpy(), xr_ref, rtol=TOL,
                               atol=TOL * scale)
    np.testing.assert_allclose(xi.numpy(), xi_ref, rtol=TOL,
                               atol=TOL * scale)
    assert float(np.abs(xr_ref).max()) > 0  # the source excites it
    assert float(np.abs(xi_ref).max()) > 0  # the frequencies matter


def test_ce_amplifier_has_twelve_frequencies():
    cc = ts.compile_circuit(ts.parse(_deck("ce_amplifier_ac.cir")))
    f = ts.frequency_points("DEC", cc.netlist.ac.fstart,
                            cc.netlist.ac.fstop, cc.netlist.ac.points)
    assert len(f) == 12
    np.testing.assert_allclose(f[0], 20.0, rtol=1e-14)
    np.testing.assert_allclose(f[-1], 2e6, rtol=1e-14)
    assert cc.np1 == 8


@pytest.mark.parametrize("deck", [MOS_AC, BJT_AC],
                         ids=["mosfet", "bjt"])
def test_assemble_system_ac_matches_jax(deck):
    """The block system at one frequency and a random bias, element by
    element (the MOSFET's asymmetric imaginary couplings included)."""
    jcc = jax_compile(jax_parse(deck))
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = jax_batch_params(jcc, {})
    rng = np.random.default_rng(6)
    if "M" in jcc.idx:
        jv = {"M": {k: rng.uniform(0.2, 3.0, 1) for k in
                    ("vgs", "vds")} | {"vbs": -rng.uniform(0, 1, 1)}}
    else:
        vbe = rng.uniform(0.5, 0.7, 1)
        vbc = -rng.uniform(1, 5, 1)
        jv = {"Q": {"vbe": vbe, "vbc": vbc, "vce": vbe - vbc}}
    a_ref, b_ref = jax_assemble_ac(
        jcc, params, jax_init_state(jcc),
        {k: {kk: jnp.asarray(v) for kk, v in t.items()} for k, t in
         jv.items()}, 1234.5)
    tp = params_from_numpy({k: {kk: np.asarray(v) for kk, v in t.items()}
                            for k, t in params.items()}, device="cpu")
    tjv = {k: {kk: torch.as_tensor(v)[None] for kk, v in t.items()}
           for k, t in jv.items()}
    g, bm, br, bi = assemble_ac_blocks(cc, tp, ts.init_state(cc,
                                                            device="cpu"),
                                       tjv, 1234.5)
    a2 = torch.cat([torch.cat([g, -bm], dim=2), torch.cat([bm, g], dim=2)],
                   dim=1)  # the JAX package's real block embedding
    b2 = torch.cat([br, bi], dim=1)
    a_ref, b_ref = np.asarray(a_ref), np.asarray(b_ref)
    np.testing.assert_allclose(a2[0].numpy(), a_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(a_ref).max())
    np.testing.assert_allclose(b2[0].numpy(), b_ref, rtol=1e-12, atol=0)
    n = cc.np1
    bmat = a_ref[n:, :n]
    if "M" in jcc.idx:  # the imaginary part is not symmetric
        assert not np.array_equal(bmat, bmat.T)


def test_plain_solve_builds_the_block_system():
    """[[G, -wB], [wB, G]] x = r, checked against numpy's complex solve."""
    rng = np.random.default_rng(11)
    b, n = 2, 4
    g = rng.normal(size=(b, n, n)) + 5 * np.eye(n)
    bh = rng.normal(size=(b, n, n))
    r = rng.normal(size=(b, 2 * n))
    freqs = np.array([1.0, 50.0, 2e3])
    x = ac_ops.ac_solve_batch(torch.as_tensor(g), torch.as_tensor(bh),
                              torch.as_tensor(r), freqs)
    assert x.shape == (b, 3, 2 * n)
    for i in range(b):
        for f, fr in enumerate(freqs):
            w = 2 * math.pi * fr
            z = np.linalg.solve(g[i] + 1j * w * bh[i],
                                r[i, :n] + 1j * r[i, n:])
            np.testing.assert_allclose(x[i, f, :n].numpy(), z.real,
                                       rtol=1e-10, atol=1e-12)
            np.testing.assert_allclose(x[i, f, n:].numpy(), z.imag,
                                       rtol=1e-10, atol=1e-12)
    with pytest.raises(ValueError, match="CUDA"):
        ac_ops.launch_ac_kernel(torch.as_tensor(g), torch.as_tensor(bh),
                                torch.as_tensor(r),
                                torch.as_tensor(freqs))
