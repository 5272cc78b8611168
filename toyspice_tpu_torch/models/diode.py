"""Shockley diode model (reference pkg/device/diode.go), batched f64 torch:
the JAX package's ``models/diode.py``, compat (``dc_eval``) and physics
(``dc_eval_physics``: the Bv breakdown and the series resistance Rs).

Leaves of ``p`` are f64 tensors that broadcast against the voltages;
``temp`` is a Python float in kelvin.
"""

import torch

from ..consts import BOLTZMANN, CHARGE, TEMP_DEFAULT


def thermal_voltage(temp):
    t = TEMP_DEFAULT if temp <= 0 else temp
    return BOLTZMANN * t / CHARGE


def temperature_adjusted_is(p, temp):
    """is(T2) = is(T1)·(T2/T1)^(XTI/N)·exp(-Eg/(2Vt)·(T2/T1 - 1))
    (diode.go:108-117; T1 = 273.15+27)."""
    ktemp = TEMP_DEFAULT
    vt = thermal_voltage(temp)
    ratio = temp / ktemp
    egfact = -p["eg"] / (2.0 * vt) * (temp / ktemp - 1.0)
    return p["is_"] * torch.pow(torch.as_tensor(ratio, dtype=torch.float64,
                                                device=p["xti"].device),
                                p["xti"] / p["n"]) * torch.exp(egfact)


def dc_eval(p, vd, temp, nvt=None, is_t=None):
    """(id, gd) at junction voltage vd (diode.go:119-148): forward and weak
    reverse (vd > -3nVt) with the exp argument clamped at 40, strong reverse
    -Is; conductance (|id|+Is)/nVt + Gmin.  ``nvt``/``is_t`` may be passed
    precomputed (they depend only on the parameters and temp)."""
    if nvt is None:
        nvt = p["n"] * thermal_voltage(temp)
    if is_t is None:
        is_t = temperature_adjusted_is(p, temp)
    fwd = vd > -3.0 * nvt
    arg = torch.clamp_max(vd / nvt, 40.0)
    i_fwd = is_t * (torch.exp(arg) - 1.0)
    id_ = torch.where(fwd, i_fwd, -is_t)
    gd = torch.where(fwd, (id_.abs() + is_t) / nvt + p["gmin"], p["gmin"])
    return id_, gd


def _raw_physics(p, vj, nvt, is_t):
    """(i, g) of the junction at vj: the compat regions plus the Bv
    breakdown exponential -Is_t·exp(-(Bv+vj)/nVt) for vj <= -Bv."""
    fwd = vj > -3.0 * nvt
    bkd = vj <= -p["bv"]
    arg = torch.clamp_max(vj / nvt, 40.0)
    barg = torch.clamp_max(-(p["bv"] + vj) / nvt, 40.0)
    eb = torch.exp(barg)
    i_fwd = is_t * (torch.exp(arg) - 1.0)
    i_bkd = -is_t * eb
    id_ = torch.where(fwd, i_fwd, torch.where(bkd, i_bkd, -is_t))
    g_fwd = (i_fwd.abs() + is_t) / nvt
    g_bkd = is_t * eb / nvt
    zero = torch.zeros_like(g_fwd)
    g = torch.where(fwd, g_fwd, torch.where(bkd, g_bkd, zero)) + p["gmin"]
    return id_, g


def dc_eval_physics(p, vd, temp, nvt=None, is_t=None, rs_any=True):
    """Physics-mode (id, gd) (models/diode.py dc_eval_physics of the JAX
    package): the reference parses Rs and Bv and never uses them
    (diode.go:65-69); physics mode cashes both.

    Bv: for vd <= -Bv the reverse current turns on exponentially, continuous
    with the -Is_t flat region at -Bv.  Rs is folded into the terminal
    characteristic: the junction voltage vj solving vj + Rs·i(vj) = vd by a
    fixed 8-step inner Newton seeded from the current-limited junction
    voltage (forward nVt·ln(1 + vd/(Rs·Is)), breakdown mirrored around
    -Bv), then id = i(vj) and gd = g(vj)/(1 + Rs·g(vj)).  At Rs = 0 the seed
    is vd and every step subtracts 0, so ``rs_any=False`` (every Rs is 0)
    skips the steps with the same result."""
    if nvt is None:
        nvt = p["n"] * thermal_voltage(temp)
    if is_t is None:
        is_t = temperature_adjusted_is(p, temp)
    rs = p["rs"]
    vj = vd
    if rs_any:
        rs_pos = rs > 0
        rs_is = torch.where(rs_pos, rs, torch.ones_like(rs)) * is_t
        fwd_cap = nvt * torch.log1p(torch.clamp_min(vd, 0.0) / rs_is)
        bkd_cap = -p["bv"] - nvt * torch.log1p(
            torch.clamp_min(-vd - p["bv"], 0.0) / rs_is)
        vj = torch.where(rs_pos & (vd > 0), torch.minimum(vd, fwd_cap),
                         torch.where(rs_pos & (vd < -p["bv"]),
                                     torch.maximum(vd, bkd_cap), vd))
        for _ in range(8):
            ij, gj = _raw_physics(p, vj, nvt, is_t)
            f = vj + rs * ij - vd
            vj = vj - f / (1.0 + rs * gj)
    ij, gj = _raw_physics(p, vj, nvt, is_t)
    return ij, gj / (1.0 + rs * gj)


def junction_cap(p, vd):
    """Depletion capacitance Cj0/(1-v/Vj)^M with arg floor 0.1 in reverse,
    linearized in forward (diode.go:151-166).  AC path only."""
    arg = (1.0 - vd / p["vj"]).clamp_min(0.1)
    rev = p["cj0"] / torch.pow(arg, p["m"])
    fwdc = p["cj0"] * (1.0 + p["m"] * vd / p["vj"])
    cj = torch.where(vd < 0, rev, fwdc)
    return torch.where(p["cj0"] == 0, 0.0, cj)
