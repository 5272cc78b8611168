"""DC sweep (engine/dc.py of the JAX package; reference dc.go): one or two
nested V-source sweeps.

``sweep_values`` keeps the reference's float accumulation.  ``make_dc`` is
the general engine's sweep: each point a warm-started Newton with the DC
convergence test (``conv="dc"``), its junction voltages carried from the
last point (dc.go:142-187), the JAX package's ``lax.scan`` a host loop
over the points.  On a linear deck every point is one ``nr_linear``
(engine/newton.py) independent of the others, so the B·P systems of a
batch go through one stamped solve.  A nonlinear deck the DC sweep
kernel serves runs ``ops/dc.make_dc_fused`` instead
(``engine/batch.run_dc_batch``).
"""

import torch

from .options import DEFAULTS, SimOptions

F64 = torch.float64


def sweep_values(start: float, stop: float, inc: float):
    """Go-exact accumulation: for v := start; v <= stop; v += inc
    (dc.go:36-42); the float64 rounding decides the point count."""
    vals = []
    v = start
    while v <= stop:
        vals.append(v)
        v += inc
    return vals


def _repeat_lanes(tree, npts):
    """Each batched leaf of a {kind: {key: tensor}} tree repeated npts
    times along the batch axis (lane b·P + p)."""
    out = {}
    for kind, tbl in tree.items():
        out[kind] = {}
        for key, leaf in tbl.items():
            batched = leaf.ndim == (3 if key in ("pwl_t", "pwl_v") else 2)
            out[kind][key] = (leaf.repeat_interleave(npts, dim=0) if batched
                              else leaf)
    return out


def make_dc(cc, src_slots, opts: SimOptions = DEFAULTS,
            semantics: str = "compat", solve=None):
    """Batched DC sweep: fn(params, state0, points) -> (xs (B, P, np1),
    conv (B, P)), per lane the JAX package's dc_execute under vmap.
    ``points`` is (P,) or (P, 2) for a nested sweep (expanded on the
    host); ``src_slots`` index the swept sources in the V table.
    ``solve`` is the stamped solve's per-launch solver (None: the kernel on
    the card, the plain version on the CPU)."""
    from ..ops.dc import swept_dc
    from ..ops.run_plan import first_leaf, infer_batch, lanes, nonlinear
    from .newton import make_nr
    from .nlstate import init_jv
    from .op import lanes_of

    kw = {} if solve is None else {"solve": solve}
    nr = make_nr(cc, "op", warm_start=True, conv="dc", semantics=semantics,
                 opts=opts, **kw)
    slots = tuple(int(s) for s in src_slots)

    def dc_linear(params, state0, points):
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        pts = torch.as_tensor(points, dtype=F64, device=device)
        npts = pts.shape[0]
        dc = swept_dc(lanes(params["V"]["dc"], b), slots, pts)
        p2 = _repeat_lanes(params, npts)
        p2["V"] = dict(p2["V"], dc=dc.reshape(b * npts, -1))
        r = nr(p2, _repeat_lanes(state0, npts), {}, None, 0.0, 0.0, 0.0, 1.0)
        return (r.x.reshape(b, npts, -1),
                r.converged.reshape(b, npts))

    def dc_execute(params, state0, points):
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        pts = torch.as_tensor(points, dtype=F64, device=device)
        dc = swept_dc(lanes(params["V"]["dc"], b), slots, pts)
        jv = lanes_of(init_jv(cc, device=device), b)
        zeros = torch.zeros((b, cc.np1), dtype=F64, device=device)
        xs, conv = [], []
        for p in range(pts.shape[0]):
            p2 = dict(params, V=dict(params["V"], dc=dc[:, p]))
            r = nr(p2, state0, jv, zeros, 0.0, 0.0, 0.0, 1.0)
            jv = r.jv
            xs.append(r.x)
            conv.append(r.converged)
        return torch.stack(xs, dim=1), torch.stack(conv, dim=1)

    return dc_execute if nonlinear(cc) else dc_linear
