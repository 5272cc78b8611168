"""Independent source waveforms (reference vsource.go / isource.go) as
batched f64 torch functions: the spec that ``csrc/run_kernel.cu`` follows
operation for operation.

Every function takes per-lane times ``t`` of shape (B,) and per-source
leaves that are (nS,) shared or (B, nS) batched; PWL knot tables are (nS, P)
shared or (B, nS, P) batched.  Results are (B, nS), batch axis first.
"""

import math

import numpy as np
import torch

from ..compiler import SRC_PULSE, SRC_PWL, SRC_SIN
from ..utils.tensor import true_div

TWO_PI = 2.0 * math.pi


def floor_mod(a, b):
    """``a mod b`` with the sign of ``b`` (jnp.mod, Python's %): the exact
    fmod, shifted by b when the signs differ."""
    r = torch.fmod(a, b)
    shift = (r != 0) & ((r < 0) != (b < 0))
    return torch.where(shift, r + b, r)


def sin_value(p, t, dc):
    """SIN(dc ampl freq phase): dc + ampl*sin(2*pi*freq*t + phase*pi/180),
    with the offset ``dc`` given (eval_sources scales it)."""
    tq = t[:, None]
    return dc + p["amplitude"] * torch.sin(
        TWO_PI * p["freq"] * tq + true_div(p["phase"] * math.pi, 180.0))


def pulse_value(p, t):
    """PULSE(v1 v2 delay rise fall width period), getPulseVoltage
    (vsource.go:179-209): rise==0/fall==0 edges and the period wrap."""
    tq = t[:, None]
    v1, v2 = p["v1"], p["v2"]
    delay, rise, fall = p["delay"], p["rise"], p["fall"]
    width, period = p["width"], p["period"]

    tp = tq - delay
    per_pos = period > 0
    wrapped = floor_mod(tp, torch.where(per_pos, period, 1.0))
    tp = torch.where(per_pos, wrapped, tp)

    rise_safe = torch.where(rise == 0, 1.0, rise)
    fall_safe = torch.where(fall == 0, 1.0, fall)
    fall_start = rise + width
    in_rise = torch.where(rise == 0, v2, v1 + (v2 - v1) * tp / rise_safe)
    in_fall = torch.where(fall == 0, v1,
                     v2 - (v2 - v1) * (tp - fall_start) / fall_safe)
    val = torch.where(tp < rise, in_rise,
                 torch.where(tp < fall_start, v2,
                        torch.where(tp < fall_start + fall, in_fall, v1)))
    return torch.where(tq < delay, v1, val)


def pwl_interp(times, values, t):
    """PWL interpolation (vsource.go:211-231): segment = #(knots < t)
    clipped to [1, P-1]; before the first knot the first value.  Knot
    tables are padded with far-future points at the last value."""
    b = t.shape[0]
    P = times.shape[-1]
    tq = t[:, None]
    times = times.expand(b, *times.shape[-2:])
    values = values.expand(b, *values.shape[-2:])
    cnt = (times < tq[..., None]).sum(dim=-1)
    idx = cnt.clamp(1, P - 1)[..., None]
    t1 = times.gather(-1, idx - 1)[..., 0]
    t2 = times.gather(-1, idx)[..., 0]
    w1 = values.gather(-1, idx - 1)[..., 0]
    w2 = values.gather(-1, idx)[..., 0]
    slope = (w2 - w1) / torch.where(t2 == t1, 1.0, t2 - t1)
    val = w1 + slope * (tq - t1)
    return torch.where(tq <= times[..., 0], values[..., 0], val)


def eval_sources(stype, p, t, dc_scale=1.0):
    """Value of every source of one kind at per-lane times t: (B, nS).

    ``stype`` is the deck's static type code per source (host numpy).  Each
    waveform present is computed for all sources at once and each source
    takes its own type's column, so no device-side type mask is needed.
    ``dc_scale`` is the OP's source stepping (op.go:113-169): it scales the
    dcValue field, the level of a DC source and the offset of a SIN."""
    stype = [int(v) for v in np.asarray(stype).tolist()]
    dc = p["dc"] * dc_scale
    branch = {}
    for s in set(stype):
        if s == SRC_SIN:
            branch[s] = sin_value(p, t, dc)
        elif s == SRC_PULSE:
            branch[s] = pulse_value(p, t)
        elif s == SRC_PWL:
            branch[s] = pwl_interp(p["pwl_t"], p["pwl_v"], t)
        else:  # SRC_DC
            branch[s] = dc + torch.zeros_like(t)[:, None]
    if len(branch) == 1:
        return branch[stype[0]]
    return torch.stack([branch[s][:, k] for k, s in enumerate(stype)], dim=1)


def eval_sources_ac(p):
    """Complex phasor (real, imag) of every source for AC analysis
    (vsource.go:155-176, isource.go:150-165): ac_mag·cos and ac_mag·sin of
    the phase in degrees; a source without an AC spec has ac_mag 0.  Leaves
    (nS,) or (B, nS), results alike."""
    phase_rad = true_div(p["ac_phase"] * math.pi, 180.0)
    return (p["ac_mag"] * torch.cos(phase_rad),
            p["ac_mag"] * torch.sin(phase_rad))
