"""Jiles-Atherton magnetic core and magnetic inductor (models/magnetic.py of
the JAX package, reference magnetic.go), as f64 torch functions.

Compat semantics (PLAN.md item 1): the reference never commits a magnetic
inductor's state, so its current stays frozen, the J-A core never moves and
a transient stamps L0 = mu0·N²·A/len unless a user-given i0 says otherwise
(magnetic.go:239-251).  The port evaluates these functions once per run on
the host side, at the frozen core, as run constants of the whole-run
kernel (``ops/run_plan.const_stack``): the branch's ``l_effective`` and
each mutual partner's ``value_for_mutual``.  Physics semantics commits the
core on every accepted step (``ja_step`` in the run kernel and its plain
version) and stamps the incremental inductance ``l_incremental``.

Parameter leaves are (nk,) shared or (B, nk) batched tensors; the core
state leaves likewise.
"""

from typing import NamedTuple

import torch

from ..consts import MU0
from ..utils.tensor import scalar_div


class CoreState(NamedTuple):
    """Per-winding J-A state (frozen in compat)."""

    H: torch.Tensor
    Hold: torch.Tensor
    M: torch.Tensor
    Mirr: torch.Tensor
    dMdH: torch.Tensor


def _where(cond, a: float, b: float, like):
    """torch.where of two Python floats in ``like``'s dtype (two Python
    scalars alone would give float32)."""
    return torch.where(cond, torch.full_like(like, a),
                       torch.full_like(like, b))


def saturation(p, temp):
    """Ms at ``temp``: ms·((tc - temp)/tc)**beta with a Curie temperature
    tc > 0, else ms (magnetic.go:95-98)."""
    tc = p["tc"]
    return p["ms"] * torch.where(tc > 0, torch.pow((tc - temp) / tc,
                                                   p["beta"]),
                                 torch.ones_like(tc))


def ja_calculate(p, st: CoreState, h, temp):
    """One J-A update step (magnetic.go:88-132): returns (M, dMdH,
    new_state), with every guard of the reference (the |dH| < 1e-12
    early-out, the linearised anhysteretic at small He, the denominator
    clamp at ±1e-12) and the stable Langevin split of the JAX package."""
    return ja_step(p, saturation(p, temp), st, h)


def ja_step(p, mst, st: CoreState, h):
    """``ja_calculate`` with Ms at the temperature given as ``mst``: the
    physics commit's form (its temperature is fixed, so the run kernel
    reads mst as a run constant; csrc/run_kernel.cuh ``ja_step`` is the
    same arithmetic)."""
    dH = h - st.Hold
    small = dH.abs() < 1e-12
    delta = _where(dH < 0, -1.0, 1.0, dH)

    he = h + p["alpha"] * st.M
    he_safe = torch.where(he.abs() < 1e-6, 1.0, he)
    man_lin = mst * he / (3.0 * p["a"])
    # Langevin L(x) = coth(x) - 1/x: the Bernoulli series below |x| = 0.25,
    # where the direct difference cancels most of its digits
    x = he_safe / p["a"]
    x2 = x * x
    series = x * (1.0 / 3.0 + x2 * (-1.0 / 45.0 + x2 * (
        2.0 / 945.0 + x2 * (-1.0 / 4725.0 + x2 * (
            2.0 / 93555.0 + x2 * (-1382.0 / 638512875.0))))))
    x_safe = torch.where(x.abs() < 1e-30, 1.0, x)
    direct = scalar_div(1.0, torch.tanh(x_safe)) - scalar_div(1.0, x_safe)
    langevin = torch.where(x.abs() < 0.25, series, direct)
    man_coth = mst * langevin
    man = torch.where(he.abs() < 1e-6, man_lin, man_coth)

    denom = p["k"] * delta - p["alpha"] * (man - st.Mirr)
    denom = torch.where(denom.abs() < 1e-12,
                        1e-12 * torch.sign(denom + 1e-300), denom)
    d_mirr_dh = (man - st.Mirr) / denom

    mirr_new = st.Mirr + d_mirr_dh * dH
    m_new = mirr_new + p["c"] * (man - mirr_new)
    dh_safe = torch.where(small, 1.0, dH)
    dmdh_new = (m_new - st.M) / dh_safe

    m_out = torch.where(small, st.M, m_new)
    dmdh_out = torch.where(small, st.dMdH, dmdh_new)
    new_state = CoreState(
        H=torch.where(small, st.H, h),
        Hold=torch.where(small, st.Hold, h),
        M=m_out,
        Mirr=torch.where(small, st.Mirr, mirr_new),
        dMdH=dmdh_out,
    )
    return m_out, dmdh_out, new_state


def l_zero(p):
    """Vacuum-permeability inductance L0 = mu0·N²·A/len
    (magnetic.go:240-241)."""
    return MU0 * p["turns"] * p["turns"] * p["area"] / p["len"]


def l_effective(p, st: CoreState, i0, temp):
    """State-dependent effective inductance with the reference's clamps
    (magnetic.go:253-263); also returns the updated core state."""
    h = torch.clamp(p["turns"] * i0 / p["len"], -1e6, 1e6)
    _, dmdh, new_state = ja_calculate(p, st, h, temp)
    dmdh = torch.clamp(dmdh, -1e3, 1e3)
    leff = MU0 * (1.0 + dmdh) * p["turns"] * p["turns"] * p["area"] / p["len"]
    return torch.maximum(torch.full_like(leff, 1e-12), leff), new_state


def value_for_mutual(p, st: CoreState, i0, temp):
    """GetValue() as the mutual stamp sees it (magnetic.go:147-154): a J-A
    evaluation at the winding's own current, no clamps."""
    h = p["turns"] * i0 / p["len"]
    _, dmdh, _ = ja_calculate(p, st, h, temp)
    return (MU0 * p["turns"] * p["turns"] * p["area"] * (1.0 + dmdh)
            / p["len"])


def l_incremental(l0, dmdh):
    """The physics branch's and mutual's inductance from the committed core
    (assemble.py's physics LM block): max(1e-12, L0·(1 + clip(dMdH,
    ±1e3)))."""
    l_used = l0 * (1.0 + torch.clamp(dmdh, -1e3, 1e3))
    return torch.maximum(torch.full_like(l_used, 1e-12), l_used)
