"""Committed device state as a dict of f64 tensors (engine/state.py of the
JAX package: ``init_state`` and ``make_op_seed``; the commit forms live in
the run kernel and its plain version, ``ops/run.py``).  Compat semantics
commits state for C and L only (PLAN.md item 1): the D, Q, M and LM leaves
exist, are read where the reference reads them (the diode's and MOSFET's
frozen previous charges, the magnetic inductor's frozen current and core)
and go out of a run unchanged.  Physics semantics commits C, L, D, M and LM:
the capacitor current and the first-step flags of the trapezoidal
companions, the diode and MOSFET charge memory, and each magnetic
winding's currents, voltages, flux and Jiles-Atherton core."""

from typing import Dict

import torch

from ..models import diode as diode_model


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


def make_op_seed(cc, temp: float = 300.15):
    """The physics transient's start at the bias point: seed(params, state,
    x) -> state, with ``x`` the OP solution (B, np1).  A capacitor starts at
    its OP voltage and charge (raw C), an inductor or a magnetic winding at
    its OP current (the branch unknown is -I; the winding's core as
    given), a diode with its physics charge Tt·id at the stamp
    temperature ``temp``; hist stays as given (0), so a trapezoidal run
    takes its first step as BE.  Compat keeps the zero state: that is
    the reference (its devices never see the OP solution,
    circuit.go:192-224)."""

    def seed(params, state, x):
        new = dict(state)

        def vdiff(kind):
            nodes = torch.as_tensor(cc.idx[kind]["nodes"], dtype=torch.long,
                                    device=x.device)
            return x[:, nodes[:, 0]] - x[:, nodes[:, 1]]

        def branch(kind):
            return x[:, torch.as_tensor(cc.idx[kind]["branch"],
                                        dtype=torch.long, device=x.device)]

        if "C" in cc.idx:
            vd = vdiff("C")
            q = params["C"]["value"] * vd
            new["C"] = {**state["C"], "v0": vd, "v1": vd, "q0": q, "q1": q}
        if "L" in cc.idx:
            vd = vdiff("L")
            i = -branch("L")
            new["L"] = {**state["L"], "i0": i, "i1": i, "v0": vd, "v1": vd}
        if "LM" in cc.idx:  # the winding's OP current; its core as given
            i = -branch("LM")
            new["LM"] = {**state["LM"], "i0": i, "i1": i}
        if "D" in cc.idx:
            pd = params["D"]
            vd = vdiff("D")
            id_, _ = diode_model.dc_eval_physics(pd, vd, temp)
            new["D"] = {"prev_vd": vd, "prev_id": id_,
                        "prev_charge": pd["tt"] * id_,
                        "ic0": torch.zeros_like(id_),
                        "hist": state["D"]["hist"]}
        return new

    return seed
