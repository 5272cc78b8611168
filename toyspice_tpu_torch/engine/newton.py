"""Newton-Raphson of a linear deck: the JAX package's ``engine/newton.py``
linear fast path (``make_nr`` returns ``nr_linear`` when the deck has no
diode, BJT or MOSFET).

With no nonlinear device the assembled system does not depend on x, so the
reference's two mandatory rounds solve the same system twice: one assemble
and one stamped solve (``ops/solve_stamped.py``, the kernel
``csrc/stamped_solve.cu`` on the card) give the same result, and
convergence is "the solution is finite" (a singular system gives a
non-finite one).  The nonlinear decks' Newton runs inside the kernels
(``csrc/newton.cuh``); the general ``make_nr`` is not ported.
"""

from typing import NamedTuple

import torch

from ..ops.assemble import assemble_entries
from ..ops.solve_stamped import solve_lanes, solve_stamped_for
from .options import DEFAULTS, SimOptions


class NRResult(NamedTuple):
    x: torch.Tensor  # (B, np1) the solution
    jv: dict  # the linearization state: empty on a linear deck
    converged: torch.Tensor  # (B,) bool: x finite
    iters: torch.Tensor  # (B,) int32: 1


def make_nr_linear(cc, opts: SimOptions = DEFAULTS,
                   semantics: str = "compat", solve=solve_lanes):
    """nr_linear(params, state, gmin, dc_scale) -> NRResult with leading
    batch axes: one assemble and one stamped solve, the JAX package's
    nr_linear at t = 0, dt = 0 (its jv_carry and x_init do not change a
    linear deck's solve; ``gmin`` goes both into the stamps, as the status
    gmin, and onto the solver's diagonal).  ``solve`` is the per-launch
    solver (``solve_lanes``; ``solve_plain`` to run the plain version on
    the card)."""
    if any(k in cc.idx for k in ("D", "Q", "M")):
        raise NotImplementedError(
            "nr_linear serves linear decks; the nonlinear Newton runs in the "
            "kernels (ops/op.py, ops/dc.py, ops/run.py)")

    def nr_linear(params, state, gmin, dc_scale) -> NRResult:
        rows, cols, vals, rrows, rvals = assemble_entries(
            cc, params, state, gmin, dc_scale, temp=opts.temp,
            semantics=semantics, gmin_floor=opts.gmin)
        x = solve_stamped_for(cc.np1, rows, cols, rrows, solve)(vals, rvals,
                                                                gmin)
        conv = torch.isfinite(x).all(dim=1)
        return NRResult(x=x, jv={}, converged=conv,
                        iters=torch.ones_like(conv, dtype=torch.int32))

    return nr_linear
