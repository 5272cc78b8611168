"""Operating-point constants and result container (engine/op.py of the JAX
package, lines 20-40).  The port's one OP engine is the fused OP kernel,
``ops/op.make_op_fused``; the general ``make_op`` is not ported."""

from typing import NamedTuple

import torch


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
