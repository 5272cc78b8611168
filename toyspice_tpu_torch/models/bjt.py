"""Ebers-Moll BJT (reference pkg/device/bjt.go), batched f64 torch: the JAX
package's ``models/bjt.py``.

Exponential arguments are clamped at 40 (the JAX package's PLAN.md 10
deviation: the reference's unclamped exp overflows on its own fixtures), and
the stamp uses the closed-form Jacobian of the same current equations.
Leaves of ``p`` are f64 tensors that broadcast against the voltages;
``temp`` is a Python float in kelvin.
"""

import torch

from ..consts import BOLTZMANN, CHARGE, TEMP_DEFAULT

EXP_CLAMP = 40.0


def thermal_voltage(temp):
    t = TEMP_DEFAULT if temp <= 0 else temp
    return BOLTZMANN * t / CHARGE


def cold_start_bias(p, temp):
    """The reference's cold-start guess (bjt.go:110-120): vbe0 =
    Nf·Vt·ln(1e-3/Ies), vce0 = max(2, vbe0+1), vbc0 = vbe0 - vce0."""
    vt = thermal_voltage(temp)
    vbe0 = p["nf"] * vt * torch.log(1e-3 / p["ies"])
    vce0 = torch.clamp_min(vbe0 + 1.0, 2.0)
    return vbe0, vbe0 - vce0, vce0


def cold_start(p, vbe, vbc, vce, temp):
    """Replace an all-zero bias (vbe = vce = 0) with the cold-start guess
    (triggered at bjt.go:323-331)."""
    vbe0, vbc0, vce0 = cold_start_bias(p, temp)
    cold = (vbe == 0.0) & (vce == 0.0)
    return (torch.where(cold, vbe0, vbe), torch.where(cold, vbc0, vbc),
            torch.where(cold, vce0, vce))


def currents(p, vbe, vbc, temp):
    """(ic, ib): calculateCurrents (bjt.go:214-255) with the exp-arg clamp,
    Early voltage and knee roll-off."""
    vt = thermal_voltage(temp)
    sign = p["sign"]
    exp_vbe = torch.exp(torch.clamp_max(vbe / (p["nf"] * vt), EXP_CLAMP))
    exp_vbc = torch.exp(torch.clamp_max(vbc / (p["nr"] * vt), EXP_CLAMP))
    i_f = sign * p["ies"] * (exp_vbe - 1.0)
    i_r = sign * p["ics"] * (exp_vbc - 1.0)
    i_f = torch.where(p["vaf"] > 0, i_f * (1.0 - vbc / p["vaf"]), i_f)
    i_r = torch.where(p["var"] > 0, i_r * (1.0 + vbe / p["var"]), i_r)
    qb = torch.where(p["vaf"] > 0, 1.0 / (1.0 - vbc / p["vaf"]), 1.0)
    i_f = torch.where(p["ikf"] > 0,
                      i_f / (1.0 + i_f.abs() / (p["ikf"] * qb)), i_f)
    i_r = torch.where(p["ikr"] > 0,
                      i_r / (1.0 + i_r.abs() / (p["ikr"] * qb)), i_r)
    ie = sign * (i_f - i_r)
    ic = sign * ((p["alphaf"] * i_f - i_r) / qb)
    return ic, ie - ic


def inverses(p, temp):
    """The per-device reciprocals ``jacobian`` needs: 1/(Nf·Vt), 1/(Nr·Vt),
    and 1/Vaf, 1/Var, 1/Ikf, 1/Ikr (0 where the parameter is off)."""
    vt = thermal_voltage(temp)
    return {
        "invnfvt": 1.0 / (p["nf"] * vt),
        "invnrvt": 1.0 / (p["nr"] * vt),
        "invvaf": torch.where(p["vaf"] > 0, 1.0 / p["vaf"], 0.0),
        "invvar": torch.where(p["var"] > 0, 1.0 / p["var"], 0.0),
        "invikf": torch.where(p["ikf"] > 0, 1.0 / p["ikf"], 0.0),
        "invikr": torch.where(p["ikr"] > 0, 1.0 / p["ikr"], 0.0),
    }


def jacobian(p, vbe, vbc, temp, inv=None):
    """(ic, ib, g11, g12, g21, g22): the currents of ``currents`` and their
    exact derivatives wrt (vbe, vbc) (the JAX package's closed form:
    Shockley exponentials with zero slope where clamped, Early factors, the
    quotient rule through the knee roll-off).  ``inv`` may be passed
    precomputed from ``inverses``."""
    if inv is None:
        inv = inverses(p, temp)
    sign = p["sign"]
    invnfvt, invnrvt = inv["invnfvt"], inv["invnrvt"]
    invvaf, invvar = inv["invvaf"], inv["invvar"]
    invikf, invikr = inv["invikf"], inv["invikr"]
    a1 = vbe * invnfvt
    a2 = vbc * invnrvt
    e1 = torch.exp(torch.clamp_max(a1, EXP_CLAMP))
    e2 = torch.exp(torch.clamp_max(a2, EXP_CLAMP))
    # stage 1: raw Shockley currents (the clamped exp has zero slope)
    f0 = sign * p["ies"] * (e1 - 1.0)
    r0 = sign * p["ics"] * (e2 - 1.0)
    df0 = torch.where(a1 <= EXP_CLAMP, sign * p["ies"] * e1 * invnfvt, 0.0)
    dr0 = torch.where(a2 <= EXP_CLAMP, sign * p["ics"] * e2 * invnrvt, 0.0)
    # stage 2: Early factors; u = 1/qb = 1 - vbc/vaf (1 when vaf is off)
    u = 1.0 - vbc * invvaf
    wv = 1.0 + vbe * invvar
    f1 = f0 * u
    r1 = r0 * wv
    df1_be = df0 * u
    df1_bc = -f0 * invvaf
    dr1_be = r0 * invvar
    dr1_bc = dr0 * wv
    # stage 3: knee roll-off i/(1 + |i|·inv_ik·u), quotient rule
    sf = torch.sign(f1)
    sr = torch.sign(r1)
    den_f = 1.0 + f1.abs() * invikf * u
    den_r = 1.0 + r1.abs() * invikr * u
    f2 = f1 / den_f
    r2 = r1 / den_r
    ddenf_be = sf * df1_be * invikf * u
    ddenf_bc = sf * df1_bc * invikf * u - f1.abs() * invikf * invvaf
    ddenr_be = sr * dr1_be * invikr * u
    ddenr_bc = sr * dr1_bc * invikr * u - r1.abs() * invikr * invvaf
    df2_be = (df1_be - f2 * ddenf_be) / den_f
    df2_bc = (df1_bc - f2 * ddenf_bc) / den_f
    dr2_be = (dr1_be - r2 * ddenr_be) / den_r
    dr2_bc = (dr1_bc - r2 * ddenr_bc) / den_r
    # stage 4: terminal currents ic = sign·(af·f2 - r2)·u, ib = ie - ic
    af = p["alphaf"]
    ic0 = sign * (af * f2 - r2) * u
    ie0 = sign * (f2 - r2)
    ib0 = ie0 - ic0
    g11 = sign * (af * df2_be - dr2_be) * u
    g12 = sign * ((af * df2_bc - dr2_bc) * u - (af * f2 - r2) * invvaf)
    g21 = sign * (df2_be - dr2_be) - g11
    g22 = sign * (df2_bc - dr2_bc) - g12
    return ic0, ib0, g11, g12, g21, g22


def junction_caps(p, vbe, vbc, gm):
    """(cbe, cbc): depletion capacitances Cj0/(1 - v/Vj)^M below Vj (the
    argument floored at 1e-30) and linearized above it, plus the diffusion
    capacitance Tf·|gm| on b-e (bjt.go:196-212); ``gm`` is the consistent
    forward transconductance.  AC path only."""

    def depletion(v, cj, vj, mj):
        rev = cj / torch.pow(torch.clamp_min(1.0 - v / vj, 1e-30), mj)
        fwd = cj * (1.0 + mj * (v - vj) / vj)
        return torch.where(v < vj, rev, fwd)

    cbe = depletion(vbe, p["cje"], p["vje"], p["mje"]) + p["tf"] * gm.abs()
    return cbe, depletion(vbc, p["cjc"], p["vjc"], p["mjc"])
