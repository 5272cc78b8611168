"""Batched DC sweep for nonlinear decks, compat or physics: every sweep
point of every lane in one kernel launch.

The counterpart of ``ops/pallas_op.py``'s ``_dc_sweep_core``,
``_dc_sweep_call`` and ``make_dc_fused`` in the JAX package, which compute
``vmap(engine/dc.py make_dc)``: per lane the junction voltages start at
zero and carry from point to point, and each point is a DC-flavour Newton
from x = 0 (warm start at iteration 0, OP stamps with status gmin 0,
CheckConvergence); physics changes only the diode (its Bv/Rs evaluation
and the breakdown-frame limit).  Three pieces live here:

* ``launch_dc_kernel``: the wrapper of ``csrc/dc_sweep_kernel.cu`` (a
  warp segment of 4, 8, 16 or 32 threads per lane, f64).  Its dyn rows
  are ``[isrc(nI), lrhs(nL)]`` and
  its source table ``vs`` holds each point's V-source values, (P, nV)
  shared by every lane or (B, P, nV).  It counts its launches in
  ``.launches``.
* ``dc_plain``: the same arithmetic as batched torch operations
  (``ops/newton.py``), looking at the host once every ``CHECK_EVERY``
  Newton iterations.
* ``make_dc_fused``: the tables of one deck and the sweep entry.

The JAX package falls back to one launch per point above
``TOYSPICE_DC_SWEEP_KERNEL_MAX_PTS`` points, a limit of Mosaic's scoped
memory; the CUDA kernel indexes its point directly and has no such limit,
so every sweep is one launch.
"""

from typing import NamedTuple

import torch

from ..models.sources import eval_sources
from ..utils.tensor import true_div
from . import _build
from .newton import Builder, Devices
from .op import op_fused_ineligible_reason, op_mag_terms
from .run import check_caps, check_rows, newton_doubles
from .run_plan import (const_stack, first_leaf, infer_batch, lanes,
                       make_plan)

CHECK_EVERY = 8  # plain version: Newton iterations between host checks

F64 = torch.float64
I32 = torch.int32


class DCScalars(NamedTuple):
    """The Newton scalars of one sweep; ``physics`` picks the physics
    diode."""

    reltol: float
    abstol: float
    max_iter: int
    gmin_floor: float  # the capacitor leak's floor (SimOptions.gmin)
    physics: bool = False


class DCResult(NamedTuple):
    xs: torch.Tensor  # (B, P, np1) f64 each point's last solution
    conv: torch.Tensor  # (B, P) bool
    iters: torch.Tensor  # (B, P) int32 Newton iterations


def dyn_width(plan):
    return plan.counts[4] + plan.counts[2]  # nI + nL


def lane_doubles(plan):
    """Doubles a lane keeps in its segment's slice of the DC sweep
    kernel's shared memory beside the elimination's rows: its dyn row, the
    point's nV source values, then its junction voltages and value slots
    (``newton_doubles``)."""
    return dyn_width(plan) + plan.counts[3] + newton_doubles(plan)


def _check_inputs(plan, dev, dyn, vs):
    if plan.mode != "op":
        raise ValueError("the DC sweep kernel takes a plan of mode 'op'")
    b = dev.shape[0]
    check_rows(b, dev.device, (("dev", dev, plan.nd),
                               ("dyn", dyn, dyn_width(plan))))
    nv = plan.counts[3]
    if vs.dtype != F64:
        raise TypeError(f"vs must be float64, got {vs.dtype}")
    if vs.ndim not in (2, 3) or vs.shape[-1] != nv or (
            vs.ndim == 3 and vs.shape[0] != b):
        raise ValueError(f"vs must be (P, {nv}) or ({b}, P, {nv}), got "
                         f"{tuple(vs.shape)}")
    if not vs.is_contiguous() or vs.device != dev.device:
        raise ValueError("vs must be contiguous and on dev's device")


# ------------------------------------------------------------ the kernel


def launch_dc_kernel(plan, dev, dyn, vs, sc: DCScalars) -> DCResult:
    """Every sweep point of every lane with ``csrc/dc_sweep_kernel.cu``."""
    if not dev.is_cuda:
        raise ValueError("launch_dc_kernel needs CUDA tensors")
    _check_inputs(plan, dev, dyn, vs)
    check_caps(plan)
    lib = _build.load("dc")
    device = dev.device
    b, npts, n = dev.shape[0], vs.shape[-2], plan.np1
    topo = torch.as_tensor(plan.topo, device=device)
    xs = torch.empty((b, npts, n), dtype=F64, device=device)
    iters = torch.empty((b, npts), dtype=I32, device=device)
    conv = torch.empty((b, npts), dtype=I32, device=device)
    stride = npts * plan.counts[3] if vs.ndim == 3 else 0
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsr_dc_sweep(
            plan.np1, topo.data_ptr(), int(plan.topo.size),
            lane_doubles(plan), dev.data_ptr(),
            dyn.data_ptr(), vs.data_ptr(), stride, npts, xs.data_ptr(),
            iters.data_ptr(), conv.data_ptr(), b, float(sc.reltol),
            float(sc.abstol), int(sc.max_iter), float(sc.gmin_floor),
            int(sc.physics), stream)
    if err != 0:
        raise RuntimeError(f"DC sweep kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err, 'dc')})")
    _build.count(launch_dc_kernel)
    return DCResult(xs, conv > 0, iters)


launch_dc_kernel.launches = 0


# ------------------------------------------------------- the plain version


def dc_plain(plan, dev, dyn, vs, sc: DCScalars) -> DCResult:
    """The kernel's arithmetic as batched torch operations on any device."""
    _check_inputs(plan, dev, dyn, vs)
    device = dev.device
    b, npts, n = dev.shape[0], vs.shape[-2], plan.np1
    nr, nc, nl, nv, ni = plan.counts[:5]
    bld = Builder(plan, device)
    devs = Devices(plan, dev, sc.physics)
    lval = dev[:, nr + 2 * nc:nr + 2 * nc + nl]
    gc = torch.maximum(torch.zeros((b, 1), dtype=F64, device=device),
                       torch.full((b, 1), sc.gmin_floor, dtype=F64,
                                  device=device))
    head = [dev[:, :nr], gc.expand(b, nc), true_div(lval, 1e-9),
            torch.ones((b, 1), dtype=F64, device=device),
            torch.zeros((b, nc), dtype=F64, device=device), dyn[:, ni:]]
    isrc = dyn[:, :ni]
    mag = op_mag_terms(plan, b, device)
    jvs = torch.zeros((b, plan.kj), dtype=F64, device=device)
    xs, iters, convs = [], [], []
    for p in range(npts):
        vsrc = vs[:, p] if vs.ndim == 3 else vs[p].expand(b, nv)
        base = torch.cat(head + [vsrc, isrc, mag], dim=1)
        x = torch.zeros((b, n), dtype=F64, device=device)
        k = torch.zeros(b, dtype=I32, device=device)
        conv = torch.zeros(b, dtype=torch.bool, device=device)
        for it in range(sc.max_iter):
            if it % CHECK_EVERY == 0 and not bool(
                    (~conv & (k < sc.max_iter)).any()):
                break
            active = ~conv & (k < sc.max_iter)
            # warm start: every lane is at its iteration `it` of the point
            jv_used = jvs if it == 0 else devs.limit(x, jvs)
            xn = bld.solve(torch.cat([base, devs.values(jv_used)], dim=1))
            d = (xn - x).abs()
            ok = ((d <= sc.abstol) | (d <= sc.reltol * xn.abs())).all(dim=1)
            conv_n = (k > 0) & ok & torch.isfinite(xn).all(dim=1)
            a = active[:, None]
            x = torch.where(a, xn, x)
            jvs = torch.where(a, jv_used, jvs)
            conv = torch.where(active, conv_n, conv)
            k = k + active.to(I32)
        xs.append(x)
        iters.append(k)
        convs.append(conv)
    return DCResult(torch.stack(xs, dim=1), torch.stack(convs, dim=1),
                    torch.stack(iters, dim=1))


def dc_lanes(plan, dev, dyn, vs, sc: DCScalars) -> DCResult:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.is_cuda:
        return launch_dc_kernel(plan, dev, dyn, vs, sc)
    if dev.device.type == "cpu":
        return dc_plain(plan, dev, dyn, vs, sc)
    raise ValueError(f"no DC sweep kernel for device {dev.device}")


# ------------------------------------------------------------ the tables


def swept_dc(dc, src_slots, points):
    """The V sources' dc leaf at every point: (P, nV) from a (nV,) leaf,
    (B, P, nV) from a (B, nV) one; ``points`` (P,) or (P, len(src_slots))
    with the swept slots' values (dc.py ``set_source``)."""
    pts = points.reshape(points.shape[0], -1)
    if dc.ndim == 1:
        out = dc[None].repeat(pts.shape[0], 1)
        for j, slot in enumerate(src_slots):
            out[:, slot] = pts[:, j]
        return out
    out = dc[:, None, :].repeat(1, pts.shape[0], 1)
    for j, slot in enumerate(src_slots):
        out[:, :, slot] = pts[None, :, j]
    return out


def source_table(cc, params, src_slots, points, b):
    """The per-point V-source values at t = 0 with the swept dc slots
    replaced: (P, nV) when no V leaf is batched (one table for every lane,
    as _dc_sweep_call's unbatched branch), else (B, P, nV)."""
    pv = params["V"]
    stype = cc.idx["V"]["stype"]
    device = pv["dc"].device
    batched = any(v.ndim == (3 if k in ("pwl_t", "pwl_v") else 2)
                  for k, v in pv.items())
    npts = points.shape[0]
    if not batched:  # the points are the lanes of one evaluation
        dc = swept_dc(pv["dc"], src_slots, points)
        return eval_sources(stype, {**pv, "dc": dc},
                            torch.zeros(npts, dtype=F64, device=device))
    t0 = torch.zeros(b, dtype=F64, device=device)
    dc = swept_dc(lanes(pv["dc"], b), src_slots, points)
    return torch.stack([eval_sources(stype, {**pv, "dc": dc[:, p]}, t0)
                        for p in range(npts)], dim=1).contiguous()


def make_dc_fused(cc, src_slots, opts, semantics: str = "compat",
                  solve=dc_lanes):
    """Batched DC sweep of an eligible deck: fn(params, state0, points) ->
    DCResult, exactly vmap(make_dc) of the general engine.  ``points`` is
    (P,) for one swept V source or (P, 2) for a nested sweep (expanded on
    the host), ``src_slots`` the swept sources' indices in the V table;
    ``solve`` is the per-launch solver (``dc_lanes``; ``dc_plain`` to run
    the plain version on the card)."""
    # what the OP kernel serves: decks of the port's kinds with a diode,
    # BJT or MOSFET (a linear deck's points are stamped solves,
    # engine/dc.make_dc)
    why = op_fused_ineligible_reason(cc, semantics, opts)
    if why is not None:
        raise NotImplementedError(
            f"circuit not eligible for the DC sweep kernel: {why}")
    if "V" not in cc.idx:
        raise ValueError("a DC sweep sweeps V sources; the deck has none")
    plan = make_plan(cc, "op")
    nl, ni = plan.counts[2], plan.counts[4]
    sc = DCScalars(float(opts.reltol), float(opts.abstol),
                   int(opts.max_iter), float(opts.gmin),
                   semantics == "physics")
    slots = tuple(int(s) for s in src_slots)

    def dc_fused(params, state0, points) -> DCResult:
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        pts = torch.as_tensor(points, dtype=F64, device=device)
        dev = const_stack(plan, params, b, device, opts.temp, state0)
        t0 = torch.zeros(b, dtype=F64, device=device)
        cols = [torch.zeros((b, 0), dtype=F64, device=device)]
        if ni:
            cols.append(eval_sources(plan.stype["I"], params["I"], t0))
        if nl:
            lval = lanes(params["L"]["value"], b)
            i1 = (lanes(state0["L"]["i1"], b) if "L" in state0
                  else torch.zeros_like(lval))
            cols.append(true_div(lval, 1e-9) * i1)
        dyn = torch.cat(cols, dim=1).contiguous()
        return solve(plan, dev, dyn, source_table(cc, params, slots, pts, b),
                     sc)

    dc_fused.plan = plan
    return dc_fused
