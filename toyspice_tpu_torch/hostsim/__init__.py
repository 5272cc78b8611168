"""Host-side sequential simulation backend (no torch in the compute path;
a copy of the JAX package's ``hostsim``).

This is the reference algorithm in its original sequential shape — per-device
stamping, a plain Newton loop, plain adaptive timestepping — over either a
NumPy dense LU or the native C++ sparse LU (native/sparse_lu.cc via
toyspice_tpu_torch.native), selectable with ``set_solver``.  Two jobs:

* the **parity oracle** for the batched torch/CUDA engine (tests import it
  from here), deliberately sharing no compute code with it;
* a **fast interactive path** for one-shot CLI runs: no kernel build, so
  a single netlist solves in milliseconds (`python -m toyspice_tpu_torch
  deck.cir --engine host`).
"""

import numpy as np

from .engine import (
    OracleCircuit,
    oracle_ac,
    oracle_dc,
    oracle_op,
    oracle_tran,
    set_solver,
)


def run_host_analysis(cc):
    """Reference-format Results from the host engine (dispatches on the
    netlist's dot-card like engine.run_analysis)."""
    from ..engine import results as results_mod
    from ..engine.ac import frequency_points
    from ..engine.dc import sweep_values
    from ..netlist.data import AnalysisType

    if cc.analysis == AnalysisType.OP:
        x, ok = oracle_op(cc)
        if not ok:
            raise RuntimeError("operating point failed to converge")
        return results_mod.from_op(cc, x)
    if cc.analysis == AnalysisType.TRAN:
        t, xs, _acc = oracle_tran(cc)
        return results_mod.from_tran(cc, t, xs, len(t))
    if cc.analysis == AnalysisType.AC:
        ap = cc.netlist.ac
        freqs = frequency_points(ap.sweep, ap.fstart, ap.fstop, ap.points)
        xr, xi = oracle_ac(cc, freqs)
        return results_mod.from_ac(cc, freqs, xr, xi)
    if cc.analysis == AnalysisType.DC:
        dp = cc.netlist.dc
        names = [dp.source1] + ([dp.source2] if dp.source2 else [])
        sweeps = [sweep_values(dp.start1, dp.stop1, dp.increment1)]
        if dp.source2:
            sweeps.append(sweep_values(dp.start2, dp.stop2, dp.increment2))
        pts, xs = oracle_dc(cc, names, sweeps)
        if not dp.source2:
            pts = pts[:, 0]  # from_dc expects (P,) for a single sweep
        return results_mod.from_dc(cc, pts, xs, nested=bool(dp.source2))
    raise RuntimeError(f"unsupported analysis type: {cc.analysis}")


__all__ = [
    "OracleCircuit",
    "oracle_op",
    "oracle_tran",
    "oracle_dc",
    "oracle_ac",
    "run_host_analysis",
    "set_solver",
]
