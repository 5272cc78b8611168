"""Committed device state as a dict of f64 tensors (engine/state.py of the
JAX package, ``init_state`` only, for the kinds the port runs: compat
semantics commits state for C and L only, PLAN.md item 1)."""

from typing import Dict

import torch


def init_state(cc, device="cuda") -> Dict:
    """Zero-initialised committed state for every stateful kind present."""

    def z(kind):
        return torch.zeros(cc.kind_count(kind), dtype=torch.float64,
                           device=device)

    state: Dict = {}
    if "C" in cc.idx:
        state["C"] = {"v0": z("C"), "v1": z("C"), "q0": z("C"), "q1": z("C"),
                      "i0": z("C"), "hist": z("C")}
    if "L" in cc.idx:
        state["L"] = {
            "i0": z("L"), "i1": z("L"), "v0": z("L"), "v1": z("L"),
            "flux0": z("L"), "hist": z("L"),
        }
    return state
