"""Shockley diode model (reference pkg/device/diode.go), compat semantics,
batched f64 torch: the JAX package's ``models/diode.py`` without the
physics-mode ``dc_eval_physics``.

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


def junction_cap(p, vd):
    """Depletion capacitance Cj0/(1-v/Vj)^M with arg floor 0.1 in reverse,
    linearized in forward (diode.go:151-166).  AC path only."""
    arg = (1.0 - vd / p["vj"]).clamp_min(0.1)
    rev = p["cj0"] / torch.pow(arg, p["m"])
    fwdc = p["cj0"] * (1.0 + p["m"] * vd / p["vj"])
    cj = torch.where(vd < 0, rev, fwdc)
    return torch.where(p["cj0"] == 0, 0.0, cj)
