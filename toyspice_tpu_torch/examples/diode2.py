"""Programmatic-API example: diode I-V curve via DC sweep.

Mirrors cmd/examples/diode2/main.go: 0 -> 1.2 V in 50 mV steps through a 10Ω
series resistor.
"""

from .. import compile_circuit
from ..engine import run_dc
from ..netlist.data import AnalysisType, Element, ModelParam, NetlistData
from ..utils.formatter import format_value_factor
from ._platform import device


def create_circuit() -> NetlistData:
    data = NetlistData(title="Diode DC Sweep Circuit")
    data.analysis = AnalysisType.DC
    data.models["D1N4148"] = ModelParam(
        type="D", name="D1N4148",
        params={"is": 2.52e-9, "n": 1.752, "rs": 0.568, "cj0": 4e-12,
                "vj": 0.7, "bv": 100.0},
    )
    data.elements = [
        Element(type="V", name="Vsweep", nodes=["1", "0"], value=0.0,
                params={"type": "dc"}),
        Element(type="R", name="Rs", nodes=["1", "2"], value=10.0),
        Element(type="D", name="D1", nodes=["2", "0"],
                params={"model": "D1N4148"}),
    ]
    data.dc.source1 = "Vsweep"
    data.dc.start1 = 0.0
    data.dc.stop1 = 1.2
    data.dc.increment1 = 0.05
    return data


def main():
    print("===== Diode DC Sweep Example =====\n")
    data = create_circuit()
    cc = compile_circuit(data)
    print(f"  Name: {data.title}\n")

    print("Running DC sweep analysis...")
    r = run_dc(cc, device=device())

    print("\n  Vsweep      V(diode)      I(diode)")
    print("  " + "-" * 40)
    for i in range(len(r["SWEEP1"])):
        vs = r["SWEEP1"][i]
        vd = r["V(2)"][i]
        ida = r["I(Rs)"][i]
        print(f"  {format_value_factor(vs, 'V'):>10s}  "
              f"{format_value_factor(vd, 'V'):>11s}  "
              f"{format_value_factor(ida, 'A'):>11s}")
    print("\nDone!")


if __name__ == "__main__":
    main()
