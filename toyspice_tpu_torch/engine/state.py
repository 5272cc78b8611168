"""Committed device state as a dict of f64 tensors (engine/state.py of the
JAX package: ``init_state``, ``make_op_seed``, ``make_commit`` and
``make_lte``; the kernels' commit forms live in the run kernel and its
plain version, ``ops/run.py``).  Compat semantics
commits state for C and L only (PLAN.md item 1): the D, Q, M and LM leaves
exist, are read where the reference reads them (the diode's and MOSFET's
frozen previous charges, the magnetic inductor's frozen current and core)
and go out of a run unchanged.  Physics semantics commits C, L, D, M and LM:
the capacitor current and the first-step flags of the trapezoidal
companions, the diode and MOSFET charge memory, and each magnetic
winding's currents, voltages, flux and Jiles-Atherton core."""

from typing import Dict

import numpy as np
import torch

from ..models import diode as diode_model
from ..models import magnetic as mag_model
from ..models import mosfet as mos_model


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


def _vdiff(cc, kind, x):
    nodes = torch.as_tensor(cc.idx[kind]["nodes"], dtype=torch.long,
                            device=x.device)
    return x[:, nodes[:, 0]] - x[:, nodes[:, 1]]


def _branch(cc, kind, x):
    return x[:, torch.as_tensor(cc.idx[kind]["branch"], dtype=torch.long,
                                device=x.device)]


def make_commit(cc, semantics: str = "compat", integration: str = "be",
                temp: float = 300.15):
    """The state commit of an accepted step: commit(params, state, x, dt)
    -> state, x (B, np1) and dt (B,), every leaf (B, nk).  Compat commits
    C and L only (the reference's TimeDependent devices, PLAN.md 1: the
    inductor's junk i0 = v·1e-9/L included); physics commits the
    capacitor's current (trapezoidal after its first step, from the same
    temperature-adjusted C as its stamp), the inductor's branch current,
    the diode's and MOSFET's charges and companion currents, and each
    magnetic winding's currents, flux and J-A core, H its core's summed
    mmf over the path length (``magnetic.ja_calculate`` at 300.15 K)."""
    compat = semantics == "compat"
    trap = (not compat) and integration == "trap"

    def commit(params, state, x, dt):
        new = dict(state)
        dtc = dt[:, None]
        if "C" in cc.idx:
            st = state["C"]
            vd = _vdiff(cc, "C", x)
            cval = params["C"]["value"]
            if trap:
                dtm = temp - 300.15
                c_t = cval * (1.0 + params["C"]["tc1"] * dtm
                              + params["C"]["tc2"] * dtm * dtm)
                i_be = c_t * (vd - st["v0"]) / dtc
                i_tr = 2.0 * c_t / dtc * (vd - st["v0"]) - st["i0"]
                i_new = torch.where(st["hist"] > 0, i_tr, i_be)
            elif compat:
                i_new = st["i0"] + torch.zeros_like(vd)
            else:
                i_new = cval * (vd - st["v0"]) / dtc
            new["C"] = {"v0": vd, "v1": st["v0"] + torch.zeros_like(vd),
                        "q0": cval * vd,
                        "q1": st["q0"] + torch.zeros_like(vd), "i0": i_new,
                        "hist": torch.ones_like(vd)}
        if "L" in cc.idx:
            st = state["L"]
            vd = _vdiff(cc, "L", x)
            lval = params["L"]["value"]
            # LoadState (inductor.go:81-95): BE current integration
            i_load = st["i1"] + vd * dtc / lval
            if compat:  # UpdateState's junk i0 (inductor.go:97-114)
                i0_new = vd * 1e-9 / lval
            else:  # the branch unknown is the current (x_b = -I)
                i_load = -_branch(cc, "L", x)
                i0_new = i_load
            new["L"] = {"i0": i0_new, "i1": i_load, "v0": vd,
                        "v1": st["v0"] + torch.zeros_like(vd),
                        "flux0": vd * dtc, "hist": torch.ones_like(vd)}
        if "LM" in cc.idx and not compat:
            st = state["LM"]
            pm = params["LM"]
            vd = _vdiff(cc, "LM", x)
            i_new = -_branch(cc, "LM", x)
            core_id = np.asarray(cc.idx["LM"]["core_id"])
            ti = pm["turns"] * i_new
            mmf = torch.zeros_like(ti)
            for j in range(ti.shape[1]):  # each core's windings in order
                same = torch.as_tensor(core_id == core_id[j],
                                       device=x.device)
                mmf = mmf + torch.where(same, ti[:, j:j + 1], 0.0)
            h = torch.clamp(mmf / pm["len"], -1e6, 1e6)
            core = mag_model.CoreState(H=st["H"], Hold=st["Hold"], M=st["M"],
                                       Mirr=st["Mirr"], dMdH=st["dMdH"])
            _, _, core2 = mag_model.ja_calculate(pm, core, h, 300.15)
            new["LM"] = {"i0": i_new, "i1": st["i0"] + torch.zeros_like(vd),
                         "v0": vd, "v1": st["v0"] + torch.zeros_like(vd),
                         "flux0": st["flux0"] + vd * dtc, "H": core2.H,
                         "Hold": core2.Hold, "M": core2.M,
                         "Mirr": core2.Mirr, "dMdH": core2.dMdH}
        if "D" in cc.idx and not compat:
            st = state["D"]
            pd = params["D"]
            vd = _vdiff(cc, "D", x)
            id_, _ = diode_model.dc_eval_physics(pd, vd, temp)
            q_new = pd["tt"] * id_
            if trap:
                dq = q_new - st["prev_charge"]
                ic_new = torch.where(st["hist"] > 0,
                                     2.0 * dq / dtc - st["ic0"], dq / dtc)
            else:
                ic_new = (q_new - st["prev_charge"]) / dtc
            new["D"] = {"prev_vd": vd, "prev_id": id_, "prev_charge": q_new,
                        "ic0": ic_new, "hist": torch.ones_like(vd)}
        if "M" in cc.idx and not compat:
            stm = state["M"]
            pmo = params["M"]
            level = torch.as_tensor(np.asarray(cc.idx["M"]["level"]),
                                    device=x.device)
            vgs, vds, vbs = mos_model.terminal_voltages(pmo, x,
                                                        cc.idx["M"]["nodes"])
            ev = mos_model.dc_eval(pmo, level, vgs, vds, vbs)
            qs = mos_model.charges(pmo, ev, vgs, vds, vbs)

            def ic_new(q, qk, ik):
                dq = (q - stm[qk]) / dtc
                if trap:
                    return torch.where(stm["hist"] > 0, 2.0 * dq - stm[ik],
                                       dq)
                return dq

            new["M"] = dict(zip(("qgs", "qgd", "qgb", "qbs", "qbd"), qs))
            for q, key in zip(qs, ("gs", "gd", "gb", "bs", "bd")):
                new["M"]["ic" + key] = ic_new(q, "q" + key, "ic" + key)
            new["M"]["hist"] = torch.ones_like(vgs)
        return new

    return commit


def make_lte(cc):
    """The largest local truncation error over the TimeDependent devices,
    which in the reference are C and L only (tran.go:239-250, PLAN.md 1),
    from the committed state (one accepted step behind, as in the
    reference): lte(params, state, dt) -> (B,), dt (B,)."""

    def lte(params, state, dt):
        dtc = 2.0 * dt[:, None]
        worst = torch.zeros_like(dt)
        if "C" in cc.idx:  # capacitor.go:173-178
            st = state["C"]
            cval = params["C"]["value"]
            v = (cval * st["v0"] - cval * st["v1"]).abs() / dtc
            worst = torch.maximum(worst, v.amax(dim=1))
        if "L" in cc.idx:  # inductor.go:116-121
            st = state["L"]
            cur = (st["i0"] - st["i1"]).abs() / dtc
            vol = (st["v0"] - st["v1"]).abs() / dtc
            worst = torch.maximum(worst, torch.maximum(cur, vol).amax(dim=1))
        return worst

    return lte
