"""Programmatic-API example: resistor-divider operating point.

Mirrors the reference's cmd/examples/rr/main.go — circuit built as Element
records in code (no .cir file), OP analysis, node/branch report plus resistor
power consumption.
"""

from .. import compile_circuit, run_op
from ..netlist.data import AnalysisType, Element, NetlistData
from ..utils.formatter import format_value_factor
from ._platform import device


def create_circuit() -> NetlistData:
    data = NetlistData(title="RR voltage divider circuit")
    data.analysis = AnalysisType.OP
    data.elements = [
        Element(type="V", name="Vsrc", nodes=["1", "0"], value=10.0,
                params={"type": "dc"}),
        Element(type="R", name="R1", nodes=["1", "2"], value=1000.0),
        Element(type="R", name="R2", nodes=["2", "0"], value=1000.0),
    ]
    return data


def main():
    print("===== Example =====\n")
    data = create_circuit()
    cc = compile_circuit(data)

    print("Information:")
    print(f"Circuit name: {data.title}")
    print(f"Node count: {len(cc.node_map)} (Except 0(GND))\n")

    print("Node map:")
    for name, idx in cc.node_map.items():
        print(f"  Node '{name}' -> index {idx}")
    print("\nBranch map:")
    for name, idx in cc.branch_map.items():
        print(f"  Branch '{name}' -> index {idx}")

    print("\nRunning bias point...")
    results = run_op(cc, device=device())

    print("\nResult:\n================\n")
    print("Node voltage:")
    for name, values in results.items():
        if name.startswith("V("):
            print(f"{name} = {format_value_factor(values[0], 'V')}")
    print("\nBranch current:")
    for name, values in results.items():
        if name.startswith("I("):
            print(f"{name} = {format_value_factor(values[0], 'A')}")

    v1 = results["V(1)"][0]
    v2 = results["V(2)"][0]
    i_r1 = (v1 - v2) / 1000.0
    i_r2 = v2 / 1000.0
    print("\nResistor power consumption:")
    print(f"P(R1) = {format_value_factor((v1 - v2) * i_r1, 'W')}")
    print(f"P(R2) = {format_value_factor(v2 * i_r2, 'W')}")
    print(f"P(Total) = {format_value_factor((v1 - v2) * i_r1 + v2 * i_r2, 'W')}")
    print("\nDone!")


if __name__ == "__main__":
    main()
