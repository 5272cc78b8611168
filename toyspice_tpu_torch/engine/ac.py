"""AC small-signal analysis (engine/ac.py of the JAX package; reference
ac.go): the bias point first, then one solve per (instance, frequency).

The frequency grid reproduces the reference, including its quirk that
``numPoints`` is the TOTAL point count for DEC, OCT and LIN alike
(ac.go:100-126).  ``make_ac_batch`` takes the JAX package's fused layout
where the AC kernel serves the deck, as the JAX package does at every
np1: the AC system is exactly linear in omega, so one assemble per
instance at omega = 1 gives G and B^, and one launch of the AC kernel
(``ops/ac.py``) builds and solves every (instance, frequency) system,
with no (B, F, 2np1, 2np1) tensor in memory.  Where the bias is one the
OP kernel does not serve (its caps), or under ``TOYSPICE_AC=general``, it
takes the general branch, ``make_ac``: the general OP as the bias, the
dense (2np1, 2np1) system of every (instance, frequency) assembled at its
own omega (``assemble_system_ac``), and one dense solve of all B·F
systems (``ops/solve.linear_solve``; on the card ``csrc/gj_kernel.cu``).
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


def make_ac(cc, opts: SimOptions = DEFAULTS, semantics: str = "compat",
            solve=None, dense_solve=None, bias=None):
    """The general AC, batched: fn(params, state0, freqs) -> (xr, xi, opr)
    with xr, xi (B, F, np1); per lane the JAX package's make_ac_batch
    general branch.  The bias is ``engine/op.make_op`` (the general OP, or
    a linear deck's one stamped solve) unless ``bias`` gives another OP
    function; then the (B, F, 2np1, 2np1) systems and one dense solve of
    all B·F of them.  ``solve``/``dense_solve`` override the stamped and
    the dense solve (the plain versions on the card)."""
    from ..ops.assemble import assemble_system_ac
    from ..ops.solve import linear_solve
    from .op import make_op

    dense = dense_solve or linear_solve
    np1 = cc.np1
    bias = bias or make_op(cc, opts, semantics, solve=solve,
                           dense_solve=dense_solve)

    def ac_execute(params, state0, freqs):
        opr = bias(params, state0)
        b = opr.x.shape[0]
        nf = len(freqs)
        n2 = 2 * np1
        a2 = torch.empty((b, nf, n2, n2), dtype=torch.float64,
                         device=opr.x.device)
        b2 = torch.empty((b, nf, n2), dtype=torch.float64,
                         device=opr.x.device)
        for f, freq in enumerate(np.asarray(freqs, dtype=np.float64)):
            assemble_system_ac(cc, params, state0, opr.jv, float(freq),
                               opts.temp, semantics,
                               out=(a2[:, f], b2[:, f]))
        x2 = dense(a2.view(b * nf, n2, n2), b2.view(b * nf, n2))
        x2 = x2.view(b, nf, n2)
        return x2[..., :np1], x2[..., np1:], opr

    ac_execute.bias = bias
    return ac_execute


def make_ac_batch(cc, in_axes=None, opts: SimOptions = DEFAULTS,
                  semantics: str = "compat", op_solve=None, ac_solve=None):
    """Batched AC: fn(params, state0, freqs) -> (xr, xi, opr) with xr, xi
    (B, F, np1), and ``.engine`` "fused" or "general" (the AC solve) with
    ``.engine_reason``, and ``.bias_engine`` (the OP's, as
    ``engine/batch.select_op_engine`` names it).  Fused: one
    ``assemble_ac_blocks`` of every instance at freq = 1/(2 pi) and one
    AC solve of every (instance, frequency) pair, at any np1.  General:
    ``make_ac``'s dense systems, where the OP kernel does not serve a
    nonlinear deck's bias (``ops/ac.ac_ineligible_reason``), under
    ``TOYSPICE_AC=general``, and under ``TOYSPICE_SOLVER=xla`` unless
    ``TOYSPICE_AC=fused``.  The bias is the OP kernel under its rescue
    ladders on a nonlinear deck (``ops/op.make_op_fused``), else
    ``engine/op.make_op`` (engine/ac.py:91-111 of the JAX package, with
    ``TOYSPICE_OP`` as there); the solves and kernels are those the
    overrides choose (``engine/overrides.py``).  ``in_axes`` keeps the JAX
    package's call shape (the port reads the batch axis from the tensors).
    ``op_solve``/``ac_solve`` override the per-launch solvers (the plain
    versions on the card: the stamped solve and the AC kernel, or on the
    general branch the stamped and the dense solve)."""
    from ..ops.ac import ac_ineligible_reason, ac_plain, ac_solve_batch
    from ..ops.assemble import assemble_ac_blocks
    from ..ops.op import make_op_fused, op_lanes, op_plain
    from . import overrides
    from .batch import general_ineligible_reason, select_op_engine
    from .op import make_op

    why = overrides.general_reason(
        "AC", ac_ineligible_reason(cc, semantics, opts))
    if why is not None:
        why_not = general_ineligible_reason(cc, semantics)
        if why_not is not None:
            raise NotImplementedError(f"no AC engine for this deck in the "
                                      f"port: {why}; {why_not}")
    plain = overrides.kernels_plain()
    solves = overrides.solves()
    if why is not None and ac_solve is None:
        ac_solve = solves.get("dense_solve")
    elif ac_solve is None and plain:
        ac_solve = ac_plain
    bias_engine, _ = select_op_engine(cc, semantics, opts)
    if bias_engine == "fused":
        bias = make_op_fused(cc, opts, semantics=semantics, solve=(
            op_solve or (op_plain if plain else op_lanes)))
    else:  # the general branch's dense solve seeds it too
        bias = make_op(cc, opts, semantics, solve=(
            op_solve or solves.get("solve")), dense_solve=(
                ac_solve if why is not None else solves.get("dense_solve")))
    if why is not None:
        fn = make_ac(cc, opts, semantics, dense_solve=ac_solve, bias=bias)
        fn.engine = "general"
        fn.engine_reason = why + overrides.note(False)
        fn.bias_engine = bias_engine
        return fn
    np1 = cc.np1

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
    ac_batch_execute.bias_engine = bias_engine
    ac_batch_execute.engine = "fused"
    ac_batch_execute.engine_reason = (f"AC kernel eligible ({semantics})"
                                      + overrides.note(True))
    return ac_batch_execute
