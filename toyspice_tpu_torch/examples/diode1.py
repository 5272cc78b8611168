"""Programmatic-API example: half-wave rectifier with smoothing capacitor.

Mirrors cmd/examples/diode1/main.go: SIN drive, 1N4148-style model, transient
analysis, ripple report on the smoothed output.
"""

import numpy as np

from .. import compile_circuit, run_transient
from ..netlist.data import AnalysisType, Element, ModelParam, NetlistData
from ..utils.formatter import format_value_factor
from ._platform import device


def create_circuit() -> NetlistData:
    data = NetlistData(title="Diode Rectifier Circuit")
    data.analysis = AnalysisType.TRAN
    data.models["D1N4148"] = ModelParam(
        type="D", name="D1N4148",
        params={"is": 2.52e-9, "n": 1.752, "rs": 0.568, "cj0": 4e-12,
                "vj": 0.7, "bv": 100.0},
    )
    data.elements = [
        Element(type="V", name="Vin", nodes=["1", "0"], value=5.0,
                params={"type": "sin", "sin": "0 5 1k 0"}),
        Element(type="R", name="R1", nodes=["1", "2"], value=100.0),
        Element(type="D", name="D1", nodes=["2", "3"],
                params={"model": "D1N4148"}),
        Element(type="C", name="C1", nodes=["3", "0"], value=10e-6),
        Element(type="R", name="RL", nodes=["3", "0"], value=1000.0),
    ]
    data.tran.tstep = 10e-6
    data.tran.tstop = 5e-3
    data.tran.tstart = 0.0
    data.tran.tmax = 50e-6
    return data


def main():
    print("===== Diode Rectifier Example =====\n")
    data = create_circuit()
    cc = compile_circuit(data)
    print(f"  Name: {data.title}")
    print(f"  Node count: {len(cc.node_map)} (except GND)\n")

    print("Running transient analysis...")
    r = run_transient(cc, device=device())

    t = r["TIME"]
    vout = r["V(3)"]
    tail = vout[t > 2e-3]
    print(f"\nPoints: {len(t)}")
    print(f"Output (smoothed) max: {format_value_factor(float(np.max(tail)), 'V')}")
    print(f"Output (smoothed) min: {format_value_factor(float(np.min(tail)), 'V')}")
    print(f"Ripple: {format_value_factor(float(np.max(tail) - np.min(tail)), 'V')}")
    print("\nDone!")


if __name__ == "__main__":
    main()
