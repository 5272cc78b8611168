"""Operating point with the reference's three-stage rescue ladder (engine/
op.py of the JAX package; op.go): plain NR seeded by the linear-devices-
only solve, then gmin stepping and its gmin = 0 polish, then source
stepping and its full-scale polish.

``make_op`` is the general engine's OP, batched: every lane takes the
rungs its own convergence leads it to (each ``lax.cond`` of the JAX
package is a lane mask), and the host looks at the device once per rung
(is any lane still active?) and once per Newton iteration.  The initial
estimate is one dense solve of every lane (``ops/solve.linear_solve``; on
the card ``csrc/gj_kernel.cu``).  A linear deck keeps its shortcut: its
Newton ignores the seed and the ladder ends with polishes that solve plain
NR's system again, so plain NR's one stamped solve is the answer.  A
nonlinear deck the OP kernel serves runs ``ops/op.make_op_fused``
instead (``engine/batch.select_op_engine``).
"""

from typing import NamedTuple

import torch

from ..ops.assemble import assemble_system
from ..ops.run_plan import first_leaf, infer_batch, nonlinear
from ..ops.solve import linear_solve
from .newton import make_nr, tree_where
from .nlstate import init_jv
from .options import DEFAULTS, SimOptions

I32 = torch.int32


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


def lanes_of(tree, b):
    """Every leaf of a {kind: {key: tensor}} tree as (b, nk)."""
    return {kind: {key: leaf.expand(b, leaf.shape[-1]).clone()
                   for key, leaf in tbl.items()}
            for kind, tbl in tree.items()}


def make_op(cc, opts: SimOptions = DEFAULTS, semantics: str = "compat",
            solve=None, dense_solve=None):
    """Batched OP: fn(params, state0) -> OPResult with the batch axis
    first, per lane the JAX package's op_execute under vmap.  ``solve`` is
    the stamped solve's per-launch solver and ``dense_solve`` the initial
    estimate's (None: the kernels on the card, the plain versions on the
    CPU; ``solve_plain`` and ``gj_plain`` run the plain versions on the
    card)."""
    kw = {} if solve is None else {"solve": solve}
    dense_solve = dense_solve or linear_solve
    nr = make_nr(cc, "op", warm_start=False, conv="op", semantics=semantics,
                 opts=opts, **kw)

    if not nonlinear(cc):
        def op_linear(params, state0) -> OPResult:
            # a lane that fails plain NR ends at stage 2, not converged,
            # with plain NR's x (a singular deck shows it)
            r0 = nr(params, state0, {}, None, 0.0, 0.0, 0.0, 1.0)
            stage = torch.where(r0.converged, 0, 2).to(I32)
            return OPResult(x=r0.x, jv={}, converged=r0.converged,
                            stage=stage)

        return op_linear

    def initial_estimate(params, state, dc_scale, b):
        """The linear-devices-only solve (op.go:90-111), stamped with the
        zero-value status (t = 0, gmin 0, the JAX package's defaults:
        compat, BE); a non-finite solution falls back to zeros."""
        a, rhs = assemble_system(cc, params, state, None, 0.0, 0.0, "op",
                                 0.0, dc_scale, linear_only=True,
                                 temp=opts.temp, gmin_floor=opts.gmin)
        if a.shape[0] != b:
            a = a.expand(b, -1, -1)
            rhs = rhs.expand(b, -1)
        x = dense_solve(a.contiguous(), rhs.contiguous())
        return torch.where(torch.isfinite(x).all(dim=1, keepdim=True), x,
                           0.0)

    g0 = cc.n * 0.001 * (10.0 ** GMIN_STEPS)  # op.go:193

    def op_execute(params, state0) -> OPResult:
        b = infer_batch(params, state0)
        jv0 = lanes_of(init_jv(cc, device=first_leaf(params).device), b)
        seed = initial_estimate(params, state0, 1.0, b)
        r0 = nr(params, state0, jv0, seed, 0.0, 0.0, 0.0, 1.0)
        x, jv, conv = r0.x, r0.jv, r0.converged
        stage = torch.zeros(b, dtype=I32, device=x.device)
        need = ~conv
        if not bool(need.any()):
            return OPResult(x=x, jv=jv, converged=conv, stage=stage)
        # gmin stepping (op.go:192-214): each rung from the last converged
        cur, jv_c, active, gmin = r0.x, r0.jv, need, g0
        for _ in range(GMIN_STEPS + 1):
            if not bool(active.any()):
                break
            r = nr(params, state0, jv_c, cur, 0.0, 0.0, gmin, 1.0, active)
            upd = active & r.converged
            cur = torch.where(upd[:, None], r.x, cur)
            jv_c = tree_where(upd, r.jv, jv_c)
            active = upd
            gmin = gmin / 10.0
        rp = nr(params, state0, jv_c, cur, 0.0, 0.0, 0.0, 1.0, need)
        x = torch.where(need[:, None], rp.x, x)
        jv = tree_where(need, rp.jv, jv)
        conv = torch.where(need, rp.converged, conv)
        stage = torch.where(need, 1, stage).to(I32)
        need2 = need & ~rp.converged
        if not bool(need2.any()):
            return OPResult(x=x, jv=jv, converged=conv, stage=stage)
        # source stepping (op.go:113-169): V sources from 10 % up, the
        # first step from the estimate at 10 %, every step from the last
        cur = initial_estimate(params, state0, SOURCE_FACTORS[0], b)
        jv_c, ok = rp.jv, need2
        for factor in SOURCE_FACTORS:
            if not bool(ok.any()):
                break
            r = nr(params, state0, jv_c, cur, 0.0, 0.0, 0.0, factor, ok)
            cur = torch.where(ok[:, None], r.x, cur)
            jv_c = tree_where(ok, r.jv, jv_c)
            ok = ok & r.converged
        # the full-scale polish (op.go:224)
        rf = nr(params, state0, jv_c, cur, 0.0, 0.0, 0.0, 1.0, need2)
        x = torch.where(need2[:, None], rf.x, x)
        jv = tree_where(need2, rf.jv, jv)
        conv = torch.where(need2, ok & rf.converged, conv)
        stage = torch.where(need2, 2, stage).to(I32)
        return OPResult(x=x, jv=jv, converged=conv, stage=stage)

    return op_execute
