"""Newton-Raphson over assemble + stamped solve, batched over lanes: the
JAX package's ``engine/newton.py`` (``make_nr``).

Three flavours of the reference, by two switches:

* OP (op.go:25-88): the junction voltages are updated from the previous
  solution at every iteration, iteration 0 included (seeded by x_init);
  convergence |new - old| <= reltol·max(|new|, |old|) + abstol;
* transient (tran.go:157-216): iteration 0 stamps the carried junction
  voltages (``warm_start``); the same convergence;
* DC sweep (dc.go:142-187): the transient's warm start with ``conv="dc"``,
  |new - old| <= abstol or <= reltol·|new| (anlysis.go:46-59).

Convergence is tested from iteration 1 on, and a non-finite solution does
not converge.  Each iteration is one ``ops/assemble.assemble_entries`` and
one stamped solve of every lane (``ops/solve_stamped.py``; on the card
``csrc/stamped_solve.cu``, one warp per lane past np1 = 32, one block
past 64).  The JAX
package's vmapped ``lax.while_loop`` is a host loop here: every lane has
its own iteration count, a lane that converged or reached ``max_iter`` (or
that the caller's ``act`` leaves out) keeps its x, jv and count, and the
loop ends when no lane is active (one host sync per iteration).

A linear deck (no diode, BJT or MOSFET) takes the JAX package's fast path:
its system does not depend on x, so one assemble and one solve give the
reference's two rounds, and convergence is "x is finite".
"""

from typing import NamedTuple

import torch

from ..ops.assemble import assemble_entries
from ..ops.run_plan import nonlinear
from ..ops.solve_stamped import solve_lanes, solve_stamped_for
from .nlstate import update_jv
from .options import DEFAULTS, SimOptions

I32 = torch.int32


class NRResult(NamedTuple):
    x: torch.Tensor  # (B, np1) the last solution
    jv: dict  # the junction voltages on exit, (B, nk) leaves ({} if linear)
    converged: torch.Tensor  # (B,) bool
    iters: torch.Tensor  # (B,) int32


def tree_where(mask, new, old):
    """Each leaf of ``new`` where the (B,) ``mask`` is set, else ``old``'s
    (a {kind: {key: tensor}} tree)."""
    m = mask[:, None]
    return {kind: {key: torch.where(m, leaf, old[kind][key])
                   for key, leaf in tbl.items()}
            for kind, tbl in new.items()}


def make_nr(cc, mode: str, warm_start: bool, conv: str = "op",
            semantics: str = "compat", opts: SimOptions = DEFAULTS,
            solve=solve_lanes):
    """nr(params, state, jv_carry, x_init, t, dt, gmin, dc_scale,
    act=None) -> NRResult with the batch axis first; ``t``, ``dt``,
    ``gmin`` and ``dc_scale`` are floats or (B,) tensors, ``act`` (B,) the
    lanes to solve (default all).  ``solve`` is the stamped solve's
    per-launch solver (``solve_lanes``; ``solve_plain`` to run the plain
    version on the card)."""
    max_iter, abstol, reltol = opts.max_iter, opts.abstol, opts.reltol

    def solve_iteration(params, state, jv_used, t, dt, gmin, dc_scale):
        rows, cols, vals, rrows, rvals = assemble_entries(
            cc, params, state, jv_used, t, dt, mode, status_gmin=gmin,
            dc_scale=dc_scale, temp=opts.temp, semantics=semantics,
            gmin_floor=opts.gmin, integration=opts.integration)
        return solve_stamped_for(cc.np1, rows, cols, rrows, solve)(
            vals, rvals, gmin)

    def nr_linear(params, state, jv_carry, x_init, t, dt, gmin, dc_scale,
                  act=None) -> NRResult:
        x = solve_iteration(params, state, jv_carry, t, dt, gmin, dc_scale)
        converged = torch.isfinite(x).all(dim=1)
        return NRResult(x=x, jv=jv_carry, converged=converged,
                        iters=torch.ones_like(converged, dtype=I32))

    def nr(params, state, jv_carry, x_init, t, dt, gmin, dc_scale,
           act=None) -> NRResult:
        b = x_init.shape[0]
        device = x_init.device
        if act is None:
            act = torch.ones(b, dtype=torch.bool, device=device)
        k = torch.zeros(b, dtype=I32, device=device)
        done = torch.zeros(b, dtype=torch.bool, device=device)
        x, jv = x_init, jv_carry
        while True:
            active = act & ~done & (k < max_iter)
            if not bool(active.any()):
                break
            jv_next = update_jv(cc.idx, params, x, jv, semantics=semantics)
            jv_used = (tree_where(k == 0, jv_carry, jv_next) if warm_start
                       else jv_next)
            xn = solve_iteration(params, state, jv_used, t, dt, gmin,
                                 dc_scale)
            diff = (xn - x).abs()
            if conv == "dc":
                ok = (diff <= abstol) | (diff <= reltol * xn.abs())
            else:
                ok = diff <= reltol * torch.maximum(xn.abs(), x.abs()) \
                    + abstol
            conv_n = (k > 0) & torch.isfinite(xn).all(dim=1) & ok.all(dim=1)
            x = torch.where(active[:, None], xn, x)
            jv = tree_where(active, jv_used, jv)
            done = torch.where(active, conv_n, done)
            k = k + active.to(I32)
        return NRResult(x=x, jv=jv, converged=done, iters=k)

    return nr if nonlinear(cc) else nr_linear
