"""Operating point (engine/op.py of the JAX package): the rescue constants,
the result container, and ``make_op`` for linear decks.

A nonlinear deck's OP is the OP kernel under the host rescue ladders
(``ops/op.make_op_fused``).  A linear deck's Newton is one stamped solve
(``engine/newton.nr_linear``), and ``make_op`` gives the result of the
reference's ladder around it (plain NR, then the gmin ladder and its
gmin = 0 polish, then source stepping and its full-scale polish), which on
a linear deck is plain NR's.  The linear-devices-only initial estimate only
seeds ``x_init``, which ``nr_linear`` does not read, so it is not
computed.
"""

from typing import NamedTuple

import torch

from .options import DEFAULTS, SimOptions


def _go_factors():
    """Source-stepping scale factors with the reference's float
    accumulation (op.go:147: for factor := 0.1; factor <= 1.0; factor +=
    0.1): the last factor is 0.9999999999999999."""
    out = []
    f = 0.1
    while f <= 1.0:
        out.append(f)
        f += 0.1
    return out


SOURCE_FACTORS = _go_factors()
GMIN_STEPS = 10  # op.go:193


class OPResult(NamedTuple):
    x: torch.Tensor
    jv: dict
    converged: torch.Tensor
    stage: torch.Tensor  # rescue stage that converged: 0 plain NR, 1 gmin
    #                      stepping, 2 source stepping


def make_op(cc, opts: SimOptions = DEFAULTS, semantics: str = "compat",
            solve=None):
    """Batched OP of a linear deck: fn(params, state0) -> OPResult with
    leading batch axes, per lane the JAX package's op_execute under vmap,
    in one stamped solve of every lane.  ``solve`` is the stamped solve's
    per-launch solver (None: the kernel on the card, the plain version on
    the CPU)."""
    from .newton import make_nr_linear

    kw = {} if solve is None else {"solve": solve}
    nr = make_nr_linear(cc, opts, semantics, **kw)

    def op_execute(params, state0) -> OPResult:
        # The rescue ladder cannot change a linear lane's result: nr_linear
        # ignores its seed, and the ladder ends with the gmin = 0 polish and
        # then the full-scale polish, each plain NR's system again.  So a
        # lane that fails plain NR ends at stage 2, not converged, with
        # plain NR's x (a singular deck shows it).
        r0 = nr(params, state0, 0.0, 1.0)
        stage = torch.where(r0.converged, 0, 2).to(torch.int32)
        return OPResult(x=r0.x, jv={}, converged=r0.converged, stage=stage)

    return op_execute
