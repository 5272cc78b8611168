"""AC small-signal analysis (engine/ac.py of the JAX package; reference
ac.go): the bias point first, then one solve per (instance, frequency).

The frequency grid reproduces the reference, including its quirk that
``numPoints`` is the TOTAL point count for DEC, OCT and LIN alike
(ac.go:100-126).  ``make_ac_batch`` takes the JAX package's fused layout:
the AC system is exactly linear in omega, so one assemble per instance at
omega = 1 gives G and B^, and one launch of the AC kernel
(``ops/ac.py``) builds and solves every (instance, frequency) system.
"""

import math

import numpy as np
import torch

from .options import DEFAULTS, SimOptions


def frequency_points(sweep: str, fstart: float, fstop: float,
                     num_points: int):
    """The analysis frequencies (numpy f64), as the JAX package computes
    them."""
    with np.errstate(divide="ignore", invalid="ignore"):
        n = np.float64(num_points - 1)
        i = np.arange(num_points, dtype=np.float64)
        if sweep == "DEC":
            lo, hi = np.log10(fstart), np.log10(fstop)
            return np.power(10.0, lo + i * ((hi - lo) / n))
        if sweep == "OCT":
            lo, hi = np.log2(fstart), np.log2(fstop)
            return np.power(2.0, lo + i * ((hi - lo) / n))
        return fstart + i * ((fstop - fstart) / n)  # LIN


def make_ac_batch(cc, in_axes=None, opts: SimOptions = DEFAULTS,
                  semantics: str = "compat", op_solve=None, ac_solve=None):
    """Batched AC: fn(params, state0, freqs) -> (xr, xi, opr) with xr, xi
    (B, F, np1).  The bias is the OP kernel under its rescue ladders on a
    nonlinear deck (``ops/op.make_op_fused``) and the linear OP
    (``engine/op.make_op``) on a linear one; then one
    ``assemble_ac_blocks`` of every instance at freq = 1/(2 pi) and one
    AC solve of every (instance, frequency) pair.  ``in_axes`` keeps the
    JAX package's call shape (the port reads the batch axis from the
    tensors).  ``op_solve``/``ac_solve`` override the per-launch solvers
    (the plain versions on the card)."""
    from ..ops.ac import ac_ineligible_reason, ac_solve_batch
    from ..ops.assemble import assemble_ac_blocks
    from ..ops.op import make_op_fused
    from ..ops.run_plan import nonlinear
    from .op import make_op

    why = ac_ineligible_reason(cc, semantics, opts)
    if why is not None:
        raise NotImplementedError(f"no AC engine for this deck in the "
                                  f"port: {why}")
    np1 = cc.np1
    kw = {} if op_solve is None else {"solve": op_solve}
    bias = (make_op_fused(cc, opts, semantics=semantics, **kw)
            if nonlinear(cc) else make_op(cc, opts, semantics, **kw))

    def ac_batch_execute(params, state0, freqs):
        opr = bias(params, state0)
        freq_unit = 1.0 / (2.0 * math.pi)
        omega_used = 2.0 * math.pi * freq_unit  # 1.0 to the last ulp
        g, bh, br, bi = assemble_ac_blocks(cc, params, state0, opr.jv,
                                           freq_unit, opts.temp, semantics)
        if omega_used != 1.0:  # recover the exact unit susceptance
            bh = bh / torch.full_like(bh, omega_used)
        x2 = ac_solve_batch(g, bh, torch.cat([br, bi], dim=1), freqs,
                            solve=ac_solve)
        return x2[..., :np1], x2[..., np1:], opr

    ac_batch_execute.bias = bias
    return ac_batch_execute
