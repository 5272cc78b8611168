"""Nonlinear-device linearization state ("junction voltages", jv): the JAX
package's ``engine/nlstate.py`` with batched tensors.

The reference keeps per-device voltages (diode vd, BJT vbe/vbc/vce, MOSFET
vgs/vds/vbs) updated by UpdateVoltages between Newton iterations; here they
are a dict of f64 tensors carried through the Newton loop and across
timesteps.  ``update_jv`` is UpdateVoltages plus SPICE3F5 pnjlim junction
limiting on the diode and BJT junctions, and under physics semantics the
breakdown-frame limit of the diode; MOSFET terminal voltages carry
unlimited.
"""

from typing import Dict

import torch

from ..consts import BOLTZMANN, CHARGE, TEMP_DEFAULT
from ..models.limiter import pnjlim, vcrit
from ..models.mosfet import terminal_voltages

VT_NOM = BOLTZMANN * TEMP_DEFAULT / CHARGE  # the limiter's fixed Vt


def init_jv(cc, device="cuda") -> Dict:
    """Zero junction voltages for every nonlinear kind present."""

    def z(kind):
        return torch.zeros(cc.kind_count(kind), dtype=torch.float64,
                           device=device)

    jv: Dict = {}
    if "D" in cc.idx:
        jv["D"] = {"vd": z("D")}
    if "Q" in cc.idx:
        jv["Q"] = {"vbe": z("Q"), "vbc": z("Q"), "vce": z("Q")}
    if "M" in cc.idx:
        jv["M"] = {"vgs": z("M"), "vds": z("M"), "vbs": z("M")}
    return jv


def limiter_constants(p, n_key, is_key):
    """(vte, vcrit) of one junction family: vte = N·Vt at the nominal
    temperature, vcrit from the untempered saturation current."""
    vte = p[n_key] * VT_NOM
    return vte, vcrit(vte, p[is_key])


def update_jv(idx, params, x, jv_prev: Dict,
              semantics: str = "compat") -> Dict:
    """Device voltages from the solution ``x`` (..., np1), limited against
    the previous iteration's values; leaves broadcast as (..., nk).  ``idx``
    is the deck's ``cc.idx`` (the D/Q/M node tables are what it reads).
    Under physics a diode voltage below min(0, -Bv + 10·vte) (SPICE3F5
    diode.c) is limited as -(Bv + vd) like a forward junction, gated on
    the NEW voltage only, so that a jump from breakdown to forward bias
    keeps the forward limit."""
    jv: Dict = {}

    def node(kind, col):
        nodes = torch.as_tensor(idx[kind]["nodes"], dtype=torch.long,
                                device=x.device)
        return x[..., nodes[:, col]]

    if "D" in idx:
        pd = params["D"]
        vte, vc = limiter_constants(pd, "n", "is_")
        vd = node("D", 0) - node("D", 1)
        vd_old = jv_prev["D"]["vd"]
        vlim = pnjlim(vd, vd_old, vte, vc)
        if semantics == "physics":
            vbk = pnjlim(-(pd["bv"] + vd), -(pd["bv"] + vd_old), vte, vc)
            gate = torch.clamp_max(-pd["bv"] + 10.0 * vte, 0.0)
            vlim = torch.where(vd < gate, -pd["bv"] - vbk, vlim)
        jv["D"] = {"vd": vlim}

    if "Q" in idx:
        pq = params["Q"]
        vc_, vb, ve = (node("Q", c) for c in range(3))
        pnp = pq["sign"] < 0
        vbe = torch.where(pnp, ve - vb, vb - ve)
        vbc = torch.where(pnp, vc_ - vb, vb - vc_)
        vte_f, vc_f = limiter_constants(pq, "nf", "ies")
        vte_r, vc_r = limiter_constants(pq, "nr", "ics")
        vbe = pnjlim(vbe, jv_prev["Q"]["vbe"], vte_f, vc_f)
        vbc = pnjlim(vbc, jv_prev["Q"]["vbc"], vte_r, vc_r)
        # vce stays consistent with the (possibly limited) junctions
        jv["Q"] = {"vbe": vbe, "vbc": vbc, "vce": vbe - vbc}

    if "M" in idx:  # terminal voltages carry unlimited
        vgs, vds, vbs = terminal_voltages(params["M"], x, idx["M"]["nodes"])
        jv["M"] = {"vgs": vgs, "vds": vds, "vbs": vbs}
    return jv
