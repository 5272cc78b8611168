"""The port's host engines (``toyspice_tpu_torch.hostsim``, a copy of the
JAX package's, over the port's compiler and ``native``) on the CPU.

* Bit for bit the JAX package's ``hostsim``, with the NumPy dense solver
  and with the native C++ sparse LU (``native/sparse_lu.cc``), on decks of
  every analysis.
* Against the port's own engine (``run_analysis`` on the CPU) at
  tests/test_hostsim.py's tolerances: the OP within rtol 1e-9, the
  transient on the same step grid within atol 1e-9.
"""

import os

import numpy as np
import pytest

import toyspice_tpu.hostsim as jhost
from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.netlist.parser import parse as jax_parse

import toyspice_tpu_torch as pts
from toyspice_tpu_torch import hostsim, native

from test_torch_api import deck_text

DECKS = ["divider_op.cir", "ce_amplifier_op.cir", "diode_iv_sweep.cir",
         "ce_amplifier_ac.cir", "rc_lowpass_tran.cir",
         "half_wave_rectifier.cir"]


def teardown_module():
    hostsim.set_solver("numpy")
    jhost.set_solver("numpy")


def _both(name, solver):
    text = deck_text(name)
    jhost.set_solver(solver)
    hostsim.set_solver(solver)
    try:
        want = jhost.run_host_analysis(jax_compile(jax_parse(text)))
        got = hostsim.run_host_analysis(pts.compile_circuit(pts.parse(text)))
    finally:
        jhost.set_solver("numpy")
        hostsim.set_solver("numpy")
    return got, want


@pytest.mark.parametrize("solver", ["numpy", "native"])
@pytest.mark.parametrize("name", DECKS)
def test_host_engine_bit_for_bit_with_jax(name, solver):
    if solver == "native" and not native.available():
        pytest.skip("no native toolchain (g++/make)")
    got, want = _both(name, solver)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_native_loads_the_repository_library():
    from toyspice_tpu import native as jnative

    assert native._LIB_PATH == jnative._LIB_PATH
    assert os.path.basename(os.path.dirname(native._LIB_PATH)) == "native"


def test_set_solver_native_raises_without_the_library(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_error", "no g++")
    with pytest.raises(RuntimeError, match="native C\\+\\+ solver"):
        hostsim.set_solver("native")
    with pytest.raises(ValueError):
        hostsim.set_solver("lapack")


@pytest.mark.parametrize("name", ["divider_op.cir", "ce_amplifier_op.cir"])
def test_host_op_matches_the_port_engine(name):
    text = deck_text(name)
    host = hostsim.run_host_analysis(pts.compile_circuit(pts.parse(text)))
    port = pts.run_analysis(text, device="cpu")
    for key in port:
        np.testing.assert_allclose(host[key], port[key], rtol=1e-9,
                                   err_msg=key)


@pytest.mark.parametrize("name", ["rc_lowpass_tran.cir",
                                  "half_wave_rectifier.cir"])
def test_host_transient_matches_the_port_engine(name):
    text = deck_text(name)
    host = hostsim.run_host_analysis(pts.compile_circuit(pts.parse(text)))
    port = pts.run_analysis(text, device="cpu")
    # identical algorithm, identical step decisions: the same grid
    assert len(host["TIME"]) == len(port["TIME"])
    for key in port:
        np.testing.assert_allclose(host[key], port[key], atol=1e-9,
                                   err_msg=key)
