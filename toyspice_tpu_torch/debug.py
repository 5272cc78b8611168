"""Debug / observability surface: the reference's system printers.

Mirrors the reference's two debug tools (SURVEY.md §4.3):

* ``CircuitMatrix.PrintSystem`` + ``printMatrixSummary``
  (pkg/matrix/circuit.go:179-281): symbolic equation dump, dense matrix
  table with pivot/density stats, RHS listing.
* The CLI's verbose pipeline ``procWithPrintSystem``
  (cmd/spice/main.go:187-310): parse report, per-element node mapping and
  expected stamp contributions for R/V/L elements, then the assembled system.

The port's copy of the JAX package's debug.py.  Here the system snapshot is
one assemble of the compiled stamp plan (``ops/assemble.assemble_system``,
the engines' own code path) for a batch of one on the given device,
evaluated at the initial state with the zero-value status (Time=0,
Mode=OP), exactly when the reference prints (after ``SetupDevices``'s
initial stamp, circuit.go:154-160).
"""

import sys

import numpy as np

from .engine.batch import batch_params
from .engine.nlstate import init_jv
from .engine.state import init_state
from .ops.assemble import assemble_system


def _is_ground(name: str) -> bool:
    return name in ("0", "gnd")


def print_parse_report(cc, out=None):
    """The '[2] Parsing netlist' block of cmd/spice/main.go:199-209."""
    w = (out or sys.stdout).write
    nl = cc.netlist
    w(f"Analysis type: {nl.analysis.name}\n")
    w(f"Circuit elements: {len(nl.elements)}\n")
    for i, elem in enumerate(nl.elements):
        w(f"Element {i}: {elem.name} (type: {elem.type}, nodes: {elem.nodes})\n")


def print_element_details(cc, out=None):
    """'=== Circuit Element Details ===' (cmd/spice/main.go:226-297): node
    mapping per element plus expected matrix contributions for V/L/R."""
    w = (out or sys.stdout).write
    w("\n=== Circuit Element Details ===\n")
    node_map = cc.node_map
    for i, elem in enumerate(cc.netlist.elements):
        w(f"\nElement {i}: {elem.name}\n")
        w(f"Type: {elem.type}\n")
        w(f"Nodes: {elem.nodes}\n")
        w("Node mapping:\n")
        for j, nn in enumerate(elem.nodes):
            if _is_ground(nn):
                w(f"  Node {j}: {nn} -> Ground (0)\n")
            else:
                w(f"  Node {j}: {nn} -> {node_map[nn]}\n")

        def resolved(idx):
            nn = elem.nodes[idx]
            return 0 if _is_ground(nn) else node_map[nn]

        if elem.type in ("V", "L"):
            branch_idx = cc.branch_map[elem.name]
            w(f"Branch index: {branch_idx}\n")
            n1, n2 = resolved(0), resolved(1)
            w("Expected matrix contributions:\n")
            w("  KCL equations:\n")
            if n1 != 0:
                w(f"    ({n1},{branch_idx}): +1\n")
            if n2 != 0:
                w(f"    ({n2},{branch_idx}): -1\n")
            w("  Branch equations:\n")
            if n1 != 0:
                w(f"    ({branch_idx},{n1}): +1\n")
            if n2 != 0:
                w(f"    ({branch_idx},{n2}): -1\n")

        if elem.type == "R":
            g = 1.0 / elem.value
            w(f"Resistance: {elem.value:g} ohm\n")
            w(f"Conductance: {g:g} Mho\n")
            n1, n2 = resolved(0), resolved(1)
            w("Expected matrix contributions:\n")
            if n1 != 0:
                w(f"  ({n1},{n1}): +{g:g}\n")
            if n2 != 0:
                w(f"  ({n2},{n2}): +{g:g}\n")
            if n1 != 0 and n2 != 0:
                w(f"  ({n1},{n2}): -{g:g}\n")
                w(f"  ({n2},{n1}): -{g:g}\n")


def system_snapshot(cc, device="cuda"):
    """Assemble (A, b) as the reference's initial stamp sees them: initial
    state, zero linearization voltages, zero-value status (t=0, dt=0, OP
    mode, gmin=0 — circuit.go:154-160 stamps before any analysis runs);
    numpy arrays (np1, np1) and (np1,)."""
    params = batch_params(cc, {}, device=device)[0]
    a, b = assemble_system(
        cc, params, init_state(cc, device=device), init_jv(cc, device=device),
        t=0.0, dt=0.0, mode="op", status_gmin=0.0,
    )
    return a[0].cpu().numpy(), b[0].cpu().numpy()


def print_system(cc, a=None, b=None, out=None, device="cuda"):
    """PrintSystem + printMatrixSummary (pkg/matrix/circuit.go:179-281) over
    the dense padded system; rows/cols 1..n (the ground row 0 is an identity
    padding row the reference's 1-based sparse matrix doesn't have)."""
    if a is None or b is None:
        a, b = system_snapshot(cc, device)
    w = (out or sys.stdout).write
    n = cc.n
    w(f"\nCircuit Equations ({n}x{n}):\n")
    w("Node equations 1..n, followed by branch equations\n")
    for i in range(1, n + 1):
        w(f"Equation {i}:\n")
        row_has = False
        for j in range(1, n + 1):
            v = a[i, j]
            if v != 0:
                w(f"  {v:+g}*x{j} ")
                row_has = True
        if row_has:
            w(f" = {b[i]:g}\n")

    w("\nMATRIX SUMMARY\n")
    w(f"Size of matrix = {n} x {n}\n")
    w("Matrix before factorization:\n")
    w("   ")
    for j in range(1, n + 1):
        w(f"{j:>10d}")
    w("\n")
    sub = a[1:, 1:]
    nz = sub[sub != 0]
    diag = np.diag(sub)
    dnz = diag[diag != 0]
    for i in range(1, n + 1):
        w(f"{i:>4d}")
        for j in range(1, n + 1):
            w(f"{a[i, j]:>10.3f}")
        w("\n")
    w(f"Largest element in matrix = {np.max(nz) if nz.size else 0.0:.3f}\n")
    w(f"Smallest element in matrix = {np.min(nz) if nz.size else 0.0:.3f}\n")
    w(f"Largest pivot element = {np.max(dnz) if dnz.size else 0.0:.3f}\n")
    w(f"Smallest pivot element = {np.min(dnz) if dnz.size else 0.0:.3f}\n")
    w(f"Density = {nz.size * 100.0 / (n * n):.2f}%\n\n")

    w("RHS:\n")
    for i in range(1, n + 1):
        w(f"  x{i} = {b[i]:g}\n")
