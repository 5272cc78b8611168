"""Committed device state as a dict of f64 tensors (engine/state.py of the
JAX package, ``init_state`` only).  Compat semantics commits state for C and
L only (PLAN.md item 1): the D, Q, M and LM leaves exist, are read where the
reference reads them (the diode's and MOSFET's frozen previous charges, the
magnetic inductor's frozen current and core) and go out of a run
unchanged."""

from typing import Dict

import torch


def init_state(cc, device="cuda") -> Dict:
    """Zero-initialised committed state for every stateful kind present."""

    def z(kind):
        return torch.zeros(cc.kind_count(kind), dtype=torch.float64,
                           device=device)

    def leaves(kind, keys):
        return {key: z(kind) for key in keys}

    state: Dict = {}
    if "C" in cc.idx:
        state["C"] = leaves("C", ("v0", "v1", "q0", "q1", "i0", "hist"))
    if "L" in cc.idx:
        state["L"] = leaves("L", ("i0", "i1", "v0", "v1", "flux0", "hist"))
    if "LM" in cc.idx:
        state["LM"] = leaves("LM", ("i0", "i1", "v0", "v1", "flux0", "H",
                                    "Hold", "M", "Mirr", "dMdH"))
    if "D" in cc.idx:
        state["D"] = leaves("D", ("prev_vd", "prev_id", "prev_charge", "ic0",
                                  "hist"))
    if "M" in cc.idx:
        state["M"] = leaves("M", ("qgs", "qgd", "qgb", "qbs", "qbd", "icgs",
                                  "icgd", "icgb", "icbs", "icbd", "hist"))
    if "Q" in cc.idx:
        state["Q"] = leaves("Q", ("qbe", "qbc"))
    return state
