"""The port's front end (netlist parser, circuit compiler, unit parsing,
transient config) against the JAX package's, field by field.

The port keeps its own numpy copies of these modules so that it loads
without JAX; these tests hold the copies to the originals on every deck in
``circuits/`` and on bench.py's RLC deck."""

import dataclasses
import enum
import glob
import os

import numpy as np
import pytest
import torch

from toyspice_tpu.compiler import compile_circuit as jax_compile
from toyspice_tpu.engine.tran import build_config as jax_build_config
from toyspice_tpu.netlist.parser import parse as jax_parse
from toyspice_tpu.utils.units import parse_value as jax_parse_value

from toyspice_tpu_torch.compiler import compile_circuit
from toyspice_tpu_torch.engine.tran import build_config
from toyspice_tpu_torch.netlist.parser import parse
from toyspice_tpu_torch.utils.units import parse_value

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECKS = sorted(glob.glob(os.path.join(ROOT, "circuits", "*.cir")))

# bench.py's deck (bench.py:43-49)
RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def _plain(obj):
    """Dataclasses, enums and arrays -> comparable builtins."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return (type(obj).__name__, obj.name, obj.value)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    return obj


def _assert_tables_equal(a, b, what):
    assert list(a) == list(b), what
    for kind in a:
        assert list(a[kind]) == list(b[kind]), f"{what}[{kind}]"
        for key in a[kind]:
            x, y = np.asarray(a[kind][key]), np.asarray(b[kind][key])
            assert x.dtype == y.dtype, f"{what}[{kind}][{key}] dtype"
            np.testing.assert_array_equal(x, y,
                                          err_msg=f"{what}[{kind}][{key}]")


def _deck_text(path):
    with open(path) as f:
        return f.read()


@pytest.mark.parametrize(
    "text", [_deck_text(p) for p in DECKS] + [RLC],
    ids=[os.path.basename(p) for p in DECKS] + ["bench_rlc"])
def test_compiled_circuit_matches_field_by_field(text):
    ref = jax_compile(jax_parse(text))
    got = compile_circuit(parse(text))
    assert got.title == ref.title
    assert got.n == ref.n and got.np1 == ref.np1
    assert got.node_map == ref.node_map
    assert got.branch_map == ref.branch_map
    assert got.node_names == ref.node_names
    assert got.branch_names == ref.branch_names
    assert got.resistor_names == ref.resistor_names
    assert got.names == ref.names
    assert _plain(got.analysis) == _plain(ref.analysis)
    assert _plain(got.netlist) == _plain(ref.netlist)
    _assert_tables_equal(got.idx, ref.idx, "idx")
    _assert_tables_equal(got.params, ref.params, "params")
    for kind in ref.idx:
        assert got.kind_count(kind) == ref.kind_count(kind)


def test_deck_set_is_complete():
    assert len(DECKS) >= 14


@pytest.mark.parametrize("text", [
    "1k", "2.5meg", "1M", "0.1ms", "20ns", "3.3u", "-4.7e-3", "+12",
    "1e3K", "7p", "5f", "1T", "2G", ".5m", "10"])
def test_parse_value_matches(text):
    assert parse_value(text) == jax_parse_value(text)


def test_parse_value_rejects_like_reference():
    for bad in ("abc", "1x", ""):
        with pytest.raises(ValueError):
            jax_parse_value(bad)
        with pytest.raises(ValueError):
            parse_value(bad)


@pytest.mark.parametrize("text", [_deck_text(p) for p in DECKS if
                                  ".tran" in _deck_text(p).lower()] + [RLC])
def test_build_config_matches(text):
    tp = parse(text).tran
    ref = jax_build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    got = build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    assert tuple(got) == tuple(ref)
    assert got._fields == ref._fields


# PNP and PMOS of levels 2 and 3 beside the NPN/NMOS decks of circuits/
# (no space before a model's "(": with one, the parser drops the first
# parameter, as the reference does)
POLARITIES = """* polarities and levels
.tran 1u 10u
V1 1 0 DC 5
R1 1 2 1k
Q1 3 2 0 QP
Q2 1 2 3 QN
M1 4 2 1 1 PM2 L=2u W=10u
M2 5 2 1 1 PM3 L=1u W=4u
M3 5 2 0 0 NM1
D1 4 0 DX
R2 3 0 1k
R3 5 0 2k
.model QP PNP(Bf=120 Vaf=60)
.model QN NPN(Bf=150)
.model PM2 PMOS(Level=2 VTO=-0.8 KP=15u UCRIT=1e4 UEXP=0.1)
.model PM3 PMOS(Level=3 VTO=-0.7 KP=20u THETA=0.05 KAPPA=0.3)
.model NM1 NMOS(VTO=0.6 KP=30u GAMMA=0.4)
.model DX D(Is=1e-15 N=1.1 Tt=2n)
"""


@pytest.mark.parametrize("text", [
    _deck_text(os.path.join(ROOT, "circuits", name))
    for name in ("half_wave_rectifier.cir", "nmos_inverter_tran.cir",
                 "ce_amplifier_op.cir")] + [POLARITIES],
    ids=["diode", "nmos", "npn", "polarities"])
def test_params_from_numpy_carries_nonlinear_tables(text):
    """The JAX package's batch_params pytree, carried across with
    params_from_numpy, equals the port's own: D, Q and M tables with the
    model sign leaves, a batched override among them; and the MOSFET level
    codes sit in the idx tables of both."""
    from toyspice_tpu.engine.batch import batch_params as jax_batch_params

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.convert import params_from_numpy

    ref_cc = jax_compile(jax_parse(text))
    cc = compile_circuit(parse(text))
    rng = np.random.default_rng(5)
    kind = [k for k in ("M", "Q", "D") if k in cc.params][0]
    key = {"D": "is_", "Q": "ies", "M": "kp"}[kind]
    base = np.asarray(cc.params[kind][key])
    ov = {kind: {key: base[None] * rng.uniform(0.5, 2.0, (3,) + base.shape)}}
    jparams, _ = jax_batch_params(ref_cc, ov)
    got = params_from_numpy(
        {k: {kk: np.asarray(v) for kk, v in t.items()}
         for k, t in jparams.items()}, device="cpu")
    want, _ = ts.batch_params(cc, ov, device="cpu")
    assert list(got) == list(want)
    for k in want:
        assert list(got[k]) == list(want[k]), k
        for kk in want[k]:
            assert got[k][kk].dtype == want[k][kk].dtype
            assert torch.equal(got[k][kk], want[k][kk]), (k, kk)
    assert got[kind][key].shape == (3,) + base.shape
    for k in ("D", "Q", "M"):
        if k in cc.params:
            assert {"D": "n", "Q": "sign", "M": "sign"}[k] in got[k]
    if "M" in cc.idx:
        np.testing.assert_array_equal(cc.idx["M"]["level"],
                                      ref_cc.idx["M"]["level"])
    if text is POLARITIES:
        assert got["Q"]["sign"].tolist() == [-1.0, 1.0]
        assert got["M"]["sign"].tolist() == [-1.0, -1.0, 1.0]
        assert cc.idx["M"]["level"].tolist() == [2, 3, 1]
