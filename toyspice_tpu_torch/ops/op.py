"""Batched operating point for nonlinear decks, compat or physics: one OP
Newton solve per lane per kernel launch, and the reference's rescue
ladders on the host.

The counterpart of ``ops/pallas_op.py`` in the JAX package
(``op_fused_ineligible_reason``, ``FusedOPResult``, ``_op_core`` with the
``op`` flavour and ``make_op_fused``).  Physics semantics (the
``phys_be`` flavour) changes only the diode: its Bv/Rs evaluation and the
breakdown-frame limit; the OP has no companions.  Three pieces live here:

* ``launch_op_kernel``: the wrapper of ``csrc/op_kernel.cu`` (a warp
  segment of 4, 8, 16 or 32 threads per lane, f64).  Its dyn rows are
  ``[status_gmin, use_seed, act, vsrc(nV), isrc(nI), lrhs(nL)]``: the
  stamp-visible gmin of the rung, a flag to start from the
  linear-devices-only estimate (else from ``x0``), the lanes to solve, the
  source values at t = 0 and the inductor companion RHS.  It counts its
  launches in ``.launches``.
* ``op_plain``: the same arithmetic as batched f64 torch operations
  (``ops/newton.py``), looking at the host once every ``CHECK_EVERY``
  Newton iterations.
* ``make_op_fused``: plain NR from the linear estimate, then the gmin
  ladder (op.go:192-214) and its gmin = 0 polish, then source stepping
  over ``SOURCE_FACTORS`` (op.go:113-169) seeded from the estimate at 10 %
  and its full-scale polish; the stage is chosen per lane, and each rung
  is one launch on the lanes still active.  The host reads the device once
  per rung (is any lane still active?), never once per lane.

OP stamps (assemble.py mode "op"): capacitors leak max(status_gmin, gmin
floor), inductors stamp the dt = 1e-9 companion, the MOSFET drain and
source diagonals and every non-ground diagonal carry status_gmin, and
there are no charge stamps.  The OP Newton updates the junction voltages
from x at every iteration, iteration 0 included (op.go:25-88).
"""

import ctypes
from typing import NamedTuple

import torch

from ..engine.op import GMIN_STEPS, SOURCE_FACTORS
from ..models.sources import eval_sources
from ..utils.tensor import true_div
from . import _build
from .newton import Builder, Devices, converged
from .run import (check_caps, check_rows, kernel_caps_reason,
                  newton_doubles)
from .run_plan import (SLICE_KINDS, const_stack, first_leaf, infer_batch,
                       jv_tree, lanes, make_plan, nonlinear,
                       semantics_reason, source_leaves, source_stack)

CHECK_EVERY = 8  # plain version: Newton iterations between host checks

F64 = torch.float64
I32 = torch.int32


def op_fused_ineligible_reason(cc, semantics: str = "compat", opts=None):
    """Why this deck can NOT use the OP kernel; None when it can.  The
    kernel serves compat and physics decks of the port's kinds with at
    least one nonlinear device."""
    why = semantics_reason(semantics)
    if why is not None:
        return why
    extra = set(cc.idx.keys()) - set(SLICE_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (the port "
                "runs R, C, L, LM, K, V, I, D, Q and M)")
    if not nonlinear(cc):
        return ("linear circuit (the OP kernel serves decks with a diode, "
                "BJT or MOSFET; a linear OP is one solve, not ported)")
    return kernel_caps_reason(make_plan(cc, "op"))


class OPScalars(NamedTuple):
    """The Newton scalars of one OP; ``physics`` picks the physics diode."""

    reltol: float
    abstol: float
    max_iter: int
    gmin_floor: float  # the capacitor leak's floor (SimOptions.gmin)
    physics: bool = False


class OPLaunch(NamedTuple):
    x: torch.Tensor  # (B, n) the last solution (x0 on inactive lanes)
    iters: torch.Tensor  # (B,) int32 Newton iterations (0 when inactive)
    conv: torch.Tensor  # (B,) bool (False when inactive)
    jv: torch.Tensor  # (B, kj) the last junction voltages


class FusedOPResult(NamedTuple):
    x: torch.Tensor  # (B, np1) f64
    jv: dict  # nlstate tree, (B, nk) f64 leaves
    converged: torch.Tensor  # (B,) bool
    stage: torch.Tensor  # (B,) int32: 0 plain NR, 1 gmin, 2 source step
    iters: torch.Tensor  # (B,) int32: plain-NR (stage-0) iterations
    iters_all: torch.Tensor  # (B,) int32: Newton iterations of every rung


def op_mag_terms(plan, b, device):
    """The magnetic term columns of an OP plan (``ops/newton.Builder``
    order): each LM's branch diagonal as -1e-3 against the plan's sign -1
    (magnetic.go:216-217), then zeros where the transient has its LM
    memory and K stamps (the OP plan has none)."""
    nlm, nk = plan.nlm, plan.nk
    return torch.cat([torch.full((b, nlm), -1e-3, dtype=F64, device=device),
                      torch.zeros((b, nlm + 3 * nk), dtype=F64,
                                  device=device)], dim=1)


def dyn_width(plan):
    nl, nv, ni = plan.counts[2], plan.counts[3], plan.counts[4]
    return 3 + nv + ni + nl


def lane_doubles(plan):
    """Doubles a lane keeps in its segment's slice of the OP kernel's
    shared memory beside the elimination's rows: its dyn row, then its
    junction voltages and value slots (``newton_doubles``)."""
    return dyn_width(plan) + newton_doubles(plan)


def segment_shape(plan, b, lane):
    """The OP or DC sweep kernel's launch for b lanes of ``plan`` with
    ``lane`` doubles a lane (``lane_doubles`` of ``ops/op.py`` or of
    ``ops/dc.py``), as the op library computes it (``csrc/newton.cuh``
    ``opdc_shape``): (W, lanes a block, blocks, threads a block, bytes of
    shared memory a block)."""
    out = (ctypes.c_int * 5)()
    err = _build.load("op").tsr_opdc_seg_shape(
        plan.np1, b, int(plan.topo.size), lane, ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"np1={plan.np1} has no segment launch")
    return tuple(out)


def _check_inputs(plan, dev, dyn, x0, jv0):
    if plan.mode != "op":
        raise ValueError("the OP kernel takes a plan of mode 'op'")
    check_rows(dev.shape[0], dev.device,
               (("dev", dev, plan.nd), ("dyn", dyn, dyn_width(plan)),
                ("x0", x0, plan.np1), ("jv0", jv0, plan.kj)))


# ------------------------------------------------------------ the kernel


def launch_op_kernel(plan, dev, dyn, x0, jv0, sc: OPScalars) -> OPLaunch:
    """One OP Newton solve per active lane with ``csrc/op_kernel.cu``."""
    if not dev.is_cuda:
        raise ValueError("launch_op_kernel needs CUDA tensors")
    _check_inputs(plan, dev, dyn, x0, jv0)
    check_caps(plan)
    lib = _build.load("op")
    device = dev.device
    b = dev.shape[0]
    topo = torch.as_tensor(plan.topo, device=device)
    x = torch.empty_like(x0)
    jv = torch.empty_like(jv0)
    iters = torch.empty(b, dtype=I32, device=device)
    conv = torch.empty(b, dtype=I32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsr_op(
            plan.np1, topo.data_ptr(), int(plan.topo.size),
            lane_doubles(plan), dev.data_ptr(),
            dyn.data_ptr(), x0.data_ptr(), jv0.data_ptr(), x.data_ptr(),
            jv.data_ptr(), iters.data_ptr(), conv.data_ptr(), b,
            float(sc.reltol), float(sc.abstol), int(sc.max_iter),
            float(sc.gmin_floor), int(sc.physics), stream)
    if err != 0:
        raise RuntimeError(f"OP kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err, 'op')})")
    _build.count(launch_op_kernel)
    return OPLaunch(x, iters, conv > 0, jv)


launch_op_kernel.launches = 0


# ------------------------------------------------------- the plain version


def op_plain(plan, dev, dyn, x0, jv0, sc: OPScalars) -> OPLaunch:
    """The kernel's arithmetic as batched torch operations on any device."""
    _check_inputs(plan, dev, dyn, x0, jv0)
    device = dev.device
    b = dev.shape[0]
    nr, nc, nl, nv, ni = plan.counts[:5]
    bld = Builder(plan, device)
    lin = Builder(plan, device, plan.entries[:plan.n_lin])
    devs = Devices(plan, dev, sc.physics)
    gmin = dyn[:, 0:1]
    use_seed = dyn[:, 1] > 0.5
    act = dyn[:, 2] > 0.5
    lval = dev[:, nr + 2 * nc:nr + 2 * nc + nl]
    mag = op_mag_terms(plan, b, device)

    def terms(status_gmin):
        gc = torch.maximum(status_gmin, torch.full_like(status_gmin,
                                                        sc.gmin_floor))
        return [dev[:, :nr], gc.expand(b, nc), true_div(lval, 1e-9),
                torch.ones((b, 1), dtype=F64, device=device),
                torch.zeros((b, nc), dtype=F64, device=device),
                dyn[:, 3 + nv + ni:], dyn[:, 3:3 + nv + ni], mag]

    # the linear-devices-only initial estimate (op.go:90-111): status gmin
    # 0, no gmin diagonal, non-finite -> the zero vector
    seed = lin.solve(torch.cat(terms(torch.zeros_like(gmin)), dim=1))
    seed = torch.where(torch.isfinite(seed).all(dim=1, keepdim=True), seed,
                       0.0)
    x = torch.where(use_seed[:, None], seed, x0)
    jvs = jv0.clone()
    base = torch.cat(terms(gmin), dim=1)
    k = torch.zeros(b, dtype=I32, device=device)
    conv = torch.zeros(b, dtype=torch.bool, device=device)
    for it in range(sc.max_iter):
        if it % CHECK_EVERY == 0 and not bool(
                (act & ~conv & (k < sc.max_iter)).any()):
            break
        active = act & ~conv & (k < sc.max_iter)
        jv_used = devs.limit(x, jvs)
        xn = bld.solve(torch.cat([base, devs.values(jv_used, gmin=gmin)],
                                 dim=1), gmin=gmin)
        conv_n = (k > 0) & converged(xn, x, sc.reltol, sc.abstol)
        a = active[:, None]
        x = torch.where(a, xn, x)
        jvs = torch.where(a, jv_used, jvs)
        conv = torch.where(active, conv_n, conv)
        k = k + active.to(I32)
    return OPLaunch(x, k, conv, jvs)


def op_lanes(plan, dev, dyn, x0, jv0, sc: OPScalars) -> OPLaunch:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.is_cuda:
        return launch_op_kernel(plan, dev, dyn, x0, jv0, sc)
    if dev.device.type == "cpu":
        return op_plain(plan, dev, dyn, x0, jv0, sc)
    raise ValueError(f"no OP kernel for device {dev.device}")


# ---------------------------------------------------------- the OP entry


def make_op_fused(cc, opts, semantics: str = "compat", solve=op_lanes):
    """Batched OP of an eligible deck: fn(params, state0) -> FusedOPResult
    with leading batch axes, exactly the general engine's op_execute under
    vmap (engine/op.py): plain NR, then the gmin ladder, then source
    stepping, each lane taking the first stage that converges.  ``solve``
    is the per-launch solver (``op_lanes``; ``op_plain`` to run the plain
    version on the card)."""
    why = op_fused_ineligible_reason(cc, semantics, opts)
    if why is not None:
        raise NotImplementedError(
            f"circuit not eligible for the OP kernel: {why}")
    plan = make_plan(cc, "op")
    n, kj = plan.np1, plan.kj
    nl, nv, ni = plan.counts[2], plan.counts[3], plan.counts[4]
    sc = OPScalars(float(opts.reltol), float(opts.abstol), int(opts.max_iter),
                   float(opts.gmin), semantics == "physics")
    g0 = cc.n * 0.001 * (10.0 ** GMIN_STEPS)  # op.go:193

    def op_fused(params, state0) -> FusedOPResult:
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        dev = const_stack(plan, params, b, device, opts.temp, state0)
        src = source_stack(plan, params, b, device)
        t0 = torch.zeros(b, dtype=F64, device=device)
        pv = source_leaves(plan, src, "V") if nv else None
        fixed = []
        if ni:
            fixed.append(eval_sources(plan.stype["I"],
                                      source_leaves(plan, src, "I"), t0))
        if nl:
            lval = lanes(params["L"]["value"], b)
            i1 = (lanes(state0["L"]["i1"], b) if "L" in state0
                  else torch.zeros_like(lval))
            fixed.append(lval / 1e-9 * i1)

        def dyn(gmin, scale, act, seed):
            cols = [torch.full((b, 1), gmin, dtype=F64, device=device),
                    torch.full((b, 1), seed, dtype=F64, device=device),
                    act.to(F64)[:, None]]
            if nv:
                cols.append(eval_sources(plan.stype["V"], pv, t0, scale))
            return torch.cat(cols + fixed, dim=1).contiguous()

        iters_all = torch.zeros(b, dtype=I32, device=device)

        def call(gmin, scale, act, seed, x0, jv0):
            r = solve(plan, dev, dyn(gmin, scale, act, seed), x0, jv0, sc)
            iters_all.add_(r.iters)
            return r

        everyone = torch.ones(b, dtype=torch.bool, device=device)
        r0 = call(0.0, 1.0, everyone, 1.0,
                  torch.zeros((b, n), dtype=F64, device=device),
                  torch.zeros((b, kj), dtype=F64, device=device))
        x, jvs, conv = r0.x, r0.jv, r0.conv
        stage = torch.zeros(b, dtype=I32, device=device)
        need = ~r0.conv
        if bool(need.any()):
            # gmin ladder: each rung from the last converged one
            cur, jv_c, active, gmin = r0.x, r0.jv, need, g0
            for _ in range(GMIN_STEPS + 1):
                if not bool(active.any()):
                    break
                r = call(gmin, 1.0, active, 0.0, cur, jv_c)
                upd = active & r.conv
                cur = torch.where(upd[:, None], r.x, cur)
                jv_c = torch.where(upd[:, None], r.jv, jv_c)
                active = upd
                gmin = gmin / 10.0
            rp = call(0.0, 1.0, need, 0.0, cur, jv_c)  # gmin = 0 polish
            x = torch.where(need[:, None], rp.x, x)
            jvs = torch.where(need[:, None], rp.jv, jvs)
            conv = torch.where(need, rp.conv, conv)
            stage = torch.where(need, 1, stage).to(I32)
            need2 = need & ~rp.conv
            if bool(need2.any()):
                # source stepping: the first step from the linear estimate
                # at 10 %, every step takes its solution
                cur, jv_c, ok = rp.x, rp.jv, need2
                for j, factor in enumerate(SOURCE_FACTORS):
                    if not bool(ok.any()):
                        break
                    r = call(0.0, factor, ok, float(j == 0), cur, jv_c)
                    cur = torch.where(ok[:, None], r.x, cur)
                    jv_c = torch.where(ok[:, None], r.jv, jv_c)
                    ok = ok & r.conv
                rf = call(0.0, 1.0, need2, 0.0, cur, jv_c)  # full scale
                x = torch.where(need2[:, None], rf.x, x)
                jvs = torch.where(need2[:, None], rf.jv, jvs)
                conv = torch.where(need2, ok & rf.conv, conv)
                stage = torch.where(need2, 2, stage).to(I32)
        return FusedOPResult(x=x, jv=jv_tree(plan, jvs), converged=conv,
                             stage=stage, iters=r0.iters,
                             iters_all=iters_all)

    op_fused.plan = plan
    return op_fused
