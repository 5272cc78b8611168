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
