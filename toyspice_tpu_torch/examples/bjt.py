"""Programmatic-API example: BJT common-emitter amplifier.

Mirrors cmd/examples/bjt/main.go: 2N2222-style model, voltage-divider bias,
coupling/bypass capacitors — DC operating point, then a transient run with a
100 mV 1 kHz input and a gain estimate.
"""

import numpy as np

from .. import compile_circuit, run_op, run_transient
from ..netlist.data import AnalysisType, Element, ModelParam, NetlistData
from ..utils.formatter import format_value_factor
from ._platform import device


def create_netlist() -> NetlistData:
    data = NetlistData(title="BJT Common Emitter Amplifier Circuit")
    data.models["Q2N2222"] = ModelParam(
        type="NPN", name="Q2N2222",
        params={"type": 0.0, "is": 1.8e-14, "bf": 100, "vaf": 100, "ikf": 0.3,
                "rc": 0.3, "re": 0.2, "rb": 10, "cje": 22e-12, "cjc": 8e-12,
                "tf": 0.3e-9},
    )
    data.elements = [
        Element(type="V", name="Vcc", nodes=["vcc", "0"], value=12.0,
                params={"type": "dc"}),
        Element(type="V", name="Vin", nodes=["in", "0"], value=0.0,
                params={"type": "sin", "sin": "0 0.1 1k 0"}),
        Element(type="R", name="Rc", nodes=["vcc", "c"], value=1000.0),
        Element(type="R", name="Rb1", nodes=["vcc", "b"], value=10000.0),
        Element(type="R", name="Rb2", nodes=["b", "0"], value=2200.0),
        Element(type="R", name="Re", nodes=["e", "0"], value=220.0),
        Element(type="C", name="Cin", nodes=["in", "b"], value=10e-6),
        Element(type="C", name="Cout", nodes=["c", "out"], value=10e-6),
        Element(type="R", name="RL", nodes=["out", "0"], value=10000.0),
        Element(type="C", name="Ce", nodes=["e", "0"], value=100e-6),
        Element(type="Q", name="Q1", nodes=["c", "b", "e"],
                params={"model": "Q2N2222"}),
    ]
    return data


def main():
    print("===== BJT Common-Emitter Amplifier Example =====\n")
    data = create_netlist()

    # 1. bias point
    data.analysis = AnalysisType.OP
    cc = compile_circuit(data)
    print("Running bias point...")
    op = run_op(cc, device=device())
    for node in ("b", "e", "c"):
        print(f"  V({node}) = {format_value_factor(op[f'V({node})'][0], 'V')}")

    # 2. transient with signal
    data.analysis = AnalysisType.TRAN
    data.tran.tstep = 10e-6
    data.tran.tstop = 3e-3
    data.tran.tmax = 10e-6
    cc = compile_circuit(data)
    print("\nRunning transient analysis...")
    r = run_transient(cc, device=device())
    t = r["TIME"]
    vout = r["V(out)"]
    tail = vout[t > 1.5e-3]
    amp_out = (np.max(tail) - np.min(tail)) / 2.0
    print(f"  Output amplitude: {format_value_factor(float(amp_out), 'V')}")
    print(f"  Approx gain: {float(amp_out) / 0.1:.1f}x")
    print("\nDone!")


if __name__ == "__main__":
    main()
