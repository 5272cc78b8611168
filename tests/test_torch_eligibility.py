"""What the port's transient does not cover raises NotImplementedError
with the reason; there is no other engine to fall back on yet."""

import os

import pytest

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.options import SimOptions
from toyspice_tpu_torch.ops import run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def _ladder(stages):
    """An RC ladder with np1 = stages + 3: the ground row, nodes
    1..stages+1 and the source's branch row."""
    lines = ["* rc ladder", ".tran 0.01m 1m", "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, stages + 1):
        lines.append(f"R{k} {k} {k + 1} 100")
        lines.append(f"C{k} {k + 1} 0 1n")
    return "\n".join(lines) + "\n"


def _many_sources(count):
    """``count`` DC current sources into one resistor (np1 = 2)."""
    lines = ["* many sources", ".tran 0.01m 1m", "R1 1 0 1k"]
    lines += [f"I{k} 0 1 DC 1m" for k in range(count)]
    return "\n".join(lines) + "\n"


def _build(text, **kw):
    cc = ts.compile_circuit(ts.parse(text))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, {}, device="cpu")
    return ts.make_tran_batch(cc, cfg, axes, **kw)


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


@pytest.mark.parametrize("text,kw,reason", [
    (_deck("half_wave_rectifier.cir"), {}, "device kinds ['D']"),
    (_deck("nmos_inverter_tran.cir"), {}, "device kinds ['M']"),
    (_deck("coupled_inductors.cir"), {}, "device kinds ['K']"),
    (RLC, {"store": "full"}, "store='full'"),
    (RLC, {"semantics": "physics"}, "semantics='physics'"),
    (RLC, {"opts": SimOptions(integration="trap")}, "integration='trap'"),
    (_many_sources(33), {}, "33 sources exceed the kernel's cap of 32"),
    (_ladder(40), {}, "np1=43 exceeds the kernel's matrix cap of 32"),
], ids=["diode", "mosfet", "mutual", "store_full", "physics", "trap",
        "source_cap", "np1_cap"])
def test_ineligible_raises_with_reason(text, kw, reason):
    with pytest.raises(NotImplementedError, match="no transient engine") as e:
        _build(text, **kw)
    assert reason in str(e.value)


def test_np1_cap_boundary():
    ok = ts.compile_circuit(ts.parse(_ladder(29)))
    assert ok.np1 == run.NP1_CAP
    assert run.run_ineligible_reason(ok, "compat", "none",
                                     SimOptions()) is None
    big = ts.compile_circuit(ts.parse(_ladder(30)))
    assert "cap" in run.run_ineligible_reason(big, "compat", "none",
                                              SimOptions())


def test_make_tran_run_refuses_ineligible():
    cc = ts.compile_circuit(ts.parse(_deck("half_wave_rectifier.cir")))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    with pytest.raises(NotImplementedError, match="device kinds"):
        run.make_tran_run(cc, cfg)


def test_eligible_decks_select_the_run_engine():
    for name in ("rc_lowpass_tran.cir", "rl_tran.cir", "rlc_ringdown.cir",
                 "pulse_drive.cir", "pwl_drive.cir", "current_sin.cir"):
        fn = _build(_deck(name))
        assert fn.engine == "run", name
        assert "whole-run kernel" in fn.engine_reason
