"""Whole-run transient for compat decks: each Monte-Carlo lane's complete
adaptive time loop in one launch.

The counterpart of ``ops/pallas_run.py`` in the JAX package
(``run_ineligible_reason``, ``_run_const64``, ``_source_vals``,
``_run_core`` and ``make_tran_run``), for R/C/L/V/I decks with DC, SIN,
PULSE and PWL sources, plus diodes, BJTs and MOSFETs.  Three pieces live
here:

* ``launch_run_kernel``: the wrapper of ``csrc/run_kernel.cu`` (one thread
  per lane, f64).  It checks its inputs, allocates the outputs, launches on
  the current stream and counts its launches in ``.launches``.
* ``run_plain``: the same arithmetic as batched f64 torch operations with
  per-lane masks.  The CPU tests use it, and ``chip_smoke.py`` holds the
  kernel against it on the card.  Each of its steps is one Newton
  iteration of every lane (one attempt of a linear deck), so lanes at
  different points of their runs advance together; it looks at the host
  for pending lanes once every ``CHECK_EVERY`` steps.
* ``run_lanes``: takes the plain version for CPU tensors only; on CUDA
  tensors it launches the kernel or raises.

Each attempt is the reference's tran.go:96-152 (the general engine,
engine/tran.py:145-200): clamp dt at tstop; evaluate the sources at the OLD
time t (PLAN.md 2); solve the companion system: one Gauss-Jordan solve for
a linear deck, else the Newton of ``ops/newton.py`` from x = 0 with the
carried junction voltages at iteration 0; take the LTE from the COMMITTED
C/L state; accept (commit, grow dt x2 or x1.1 up to tmax) or reject (halve
dt while dt > minstep, else a hard fail).  The junction voltages of the
last Newton iteration carry to the next attempt whether it accepted or
not.  A lane stops when it reaches tstop, hard-fails or runs
``max_attempts`` attempts; a non-finite t or dt does not stop it early, as
in the general engine.
"""

from typing import NamedTuple

import torch

from ..engine.nlstate import init_jv
from ..engine.options import DEFAULTS
from ..engine.tran import TranOutput
from ..models.sources import eval_sources
from . import _build
from .newton import MAX_NL_DEVICES, Builder, Devices, converged
from .run_plan import (const_stack, first_leaf,
                       fused_ineligible_reason, infer_batch,
                       init_state_stack, jv_stack, jv_tree, make_plan,
                       source_leaves, source_stack, unpack_state)

NP1_CAP = 32  # largest matrix the kernel is compiled for (NMAX 8/16/32)
MAX_SOURCES = 32  # per-thread source-value array of the kernel
MAX_TOPO = 12288  # int32 words of shared memory for the plan (48 KB)
CHECK_EVERY = 256  # plain version: steps between host checks (linear)
CHECK_EVERY_NL = 64  # the same for a Newton deck (longer steps)

F64 = torch.float64
I32 = torch.int32


def kernel_caps_reason(plan):
    """Why the kernels' fixed per-thread arrays and shared table can NOT
    hold this deck; None when they can (the run and the OP kernel)."""
    if plan.np1 > NP1_CAP:
        return (f"np1={plan.np1} exceeds the kernel's matrix cap of "
                f"{NP1_CAP}")
    nsrc = sum(len(v) for v in plan.stype.values())
    if nsrc > MAX_SOURCES:
        return f"{nsrc} sources exceed the kernel's cap of {MAX_SOURCES}"
    n_nl = sum(plan.counts[5:])
    if n_nl > MAX_NL_DEVICES:
        return (f"{n_nl} diodes, BJTs and MOSFETs exceed the kernel's cap "
                f"of {MAX_NL_DEVICES} (its per-thread junction and value "
                "arrays)")
    if plan.topo.size > MAX_TOPO:
        return "stamp plan exceeds the kernel's shared-memory table"
    return None


def check_caps(plan):
    """Raise unless the kernels can hold the plan (see above)."""
    why = kernel_caps_reason(plan)
    if why is not None:
        raise ValueError(f"deck exceeds the kernel's caps: {why}")


def run_ineligible_reason(cc, semantics: str, store: str, opts):
    """Why this run can NOT use the whole-run kernel; None when it can."""
    why = fused_ineligible_reason(cc, semantics, store, opts)
    if why is not None:
        return why
    return kernel_caps_reason(make_plan(cc))


class RunScalars(NamedTuple):
    """The step-control and Newton scalars of one run."""

    tstop: float
    minstep: float
    tmax: float
    trtol: float
    max_attempts: int
    reltol: float = DEFAULTS.reltol
    abstol: float = DEFAULTS.abstol
    max_iter: int = DEFAULTS.max_iter


class RunResult(NamedTuple):
    state: torch.Tensor  # (B, ks) committed state on exit
    t: torch.Tensor  # (B,) f64
    dt: torch.Tensor  # (B,) f64
    accepted: torch.Tensor  # (B,) int32
    attempts: torch.Tensor  # (B,) int32
    fail: torch.Tensor  # (B,) int32, 0 or 1
    jv: torch.Tensor  # (B, kj) junction voltages on exit ((B, 1) if linear)
    nr_iters: torch.Tensor  # (B,) int32 Newton iterations (linear: attempts)


# ------------------------------------------------------------ the kernel


def check_rows(b, device, rows):
    """Each (name, tensor, width) must be a contiguous (b, width) f64 tensor
    on ``device``."""
    for name, x, width in rows:
        if x.dtype != F64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.shape != (b, width):
            raise ValueError(f"{name} must be ({b}, {width}), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, dev on {device}")


def _check_inputs(plan, dev, src, state, jv):
    check_rows(dev.shape[0], dev.device,
               (("dev", dev, plan.nd), ("src", src, plan.nrc),
                ("state", state, plan.ks), ("jv", jv, max(plan.kj, 1))))


def _jv0(plan, dev, jv):
    if jv is None:
        return torch.zeros((dev.shape[0], max(plan.kj, 1)), dtype=F64,
                           device=dev.device)
    return jv


def launch_run_kernel(plan, dev, src, state, sc: RunScalars,
                      jv=None) -> RunResult:
    """Run every lane's transient with ``csrc/run_kernel.cu``.

    ``dev``/``src``/``state``/``jv`` are the (B, ·) f64 CUDA rows of
    ``ops/run_plan`` (``jv`` None: zero junction voltages); the inputs are
    not modified."""
    if not dev.is_cuda:
        raise ValueError("launch_run_kernel needs CUDA tensors")
    jv = _jv0(plan, dev, jv)
    _check_inputs(plan, dev, src, state, jv)
    if plan.mode != "tran":
        raise ValueError("the run kernel takes a plan of mode 'tran'")
    check_caps(plan)
    lib = _build.load("run")
    device = dev.device
    b = dev.shape[0]
    topo = torch.as_tensor(plan.topo, device=device)
    st = state.clone()
    jv_out = jv.clone()
    t = torch.empty(b, dtype=F64, device=device)
    dt = torch.empty(b, dtype=F64, device=device)
    acc = torch.empty(b, dtype=I32, device=device)
    att = torch.empty(b, dtype=I32, device=device)
    fail = torch.empty(b, dtype=I32, device=device)
    nri = torch.empty(b, dtype=I32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsr_run(
            plan.np1, int(plan.nonlinear), topo.data_ptr(),
            int(plan.topo.size), dev.data_ptr(), src.data_ptr(),
            st.data_ptr(), jv_out.data_ptr(), t.data_ptr(), dt.data_ptr(),
            acc.data_ptr(), att.data_ptr(), fail.data_ptr(), nri.data_ptr(),
            b, float(sc.tstop), float(sc.minstep), float(sc.tmax),
            float(sc.trtol), int(sc.max_attempts), float(sc.reltol),
            float(sc.abstol), int(sc.max_iter), stream)
    if err != 0:
        raise RuntimeError(f"run kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    launch_run_kernel.launches += 1
    return RunResult(st, t, dt, acc, att, fail, jv_out, nri)


launch_run_kernel.launches = 0


# ------------------------------------------------------- the plain version


def run_plain(plan, dev, src, state, sc: RunScalars, jv=None) -> RunResult:
    """The kernel's arithmetic as batched torch operations on any device."""
    jv = _jv0(plan, dev, jv)
    _check_inputs(plan, dev, src, state, jv)
    device = dev.device
    b = dev.shape[0]
    n = plan.np1
    nr, nc, nl, nv, ni = plan.counts[:5]
    nonlin = plan.nonlinear
    L = plan.layout
    bld = Builder(plan, device)
    devs = Devices(plan, dev) if nonlin else None
    g = dev[:, :nr]
    cadj = dev[:, nr:nr + nc]
    craw = dev[:, nr + nc:nr + 2 * nc]
    lval = dev[:, nr + 2 * nc:nr + 2 * nc + nl]
    pv = source_leaves(plan, src, "V") if nv else None
    pi = source_leaves(plan, src, "I") if ni else None
    ones = torch.ones((b, 1), dtype=F64, device=device)
    cn = torch.as_tensor(plan.c_nodes, dtype=torch.long, device=device)
    ln = torch.as_tensor(plan.l_nodes, dtype=torch.long, device=device)
    tstop = torch.tensor(sc.tstop, dtype=F64, device=device)
    tmax = torch.tensor(sc.tmax, dtype=F64, device=device)
    grow2 = torch.tensor(2.0, dtype=F64, device=device)
    grow11 = torch.tensor(1.1, dtype=F64, device=device)
    zero_i = torch.zeros((), dtype=I32, device=device)

    def rows(st, key, nk):
        return st[:, L[key]:L[key] + nk]

    def step(carry):
        st, t, dt, done, fail, acc, att, nri, jv, k, x, jvs = carry
        running = ~done & (att < sc.max_attempts)

        tpdt = t + dt
        over = tpdt > sc.tstop
        next_t = torch.where(over, tstop, tpdt)
        dte = torch.where(over, tstop - t, dt)
        dtl = torch.where(dte > 0, dte, 1e-9)
        dte_c, dtl_c = dte[:, None], dtl[:, None]

        terms = [g, cadj / dte_c, lval / dtl_c, ones,
                 rows(st, "c_q1", nc) / dte_c,
                 (lval / dtl_c) * rows(st, "l_i1", nl)]
        if nv:
            terms.append(eval_sources(plan.stype["V"], pv, t))
        if ni:
            terms.append(eval_sources(plan.stype["I"], pi, t))
        if nonlin:
            # iteration 0 of an attempt: x = 0 and the carried junction
            # voltages (warm start); later ones limit the new solution
            start = (k == 0)[:, None]
            xp = torch.where(start, 0.0, x)
            jv_used = torch.where(start, jv, devs.limit(xp, jvs))
            terms.append(devs.values(jv_used, dte_c))
        xn = bld.solve(torch.cat(terms, dim=1))
        if nonlin:
            kn = k + 1
            nr_ok = (k > 0) & converged(xn, xp, sc.reltol, sc.abstol)
            end = running & (nr_ok | (kn >= sc.max_iter))
        else:  # one solve; converged when finite
            kn = torch.ones_like(k)
            nr_ok = torch.isfinite(xn).all(dim=1)
            end = running

        # LTE from the committed state (capacitor.go:173-178,
        # inductor.go:116-121)
        lte = torch.zeros(b, dtype=F64, device=device)
        two_dt = 2.0 * dte_c
        if nc:
            v = (craw * rows(st, "c_v0", nc)
                 - craw * rows(st, "c_v1", nc)).abs() / two_dt
            lte = torch.maximum(lte, v.amax(dim=1))
        if nl:
            cur = (rows(st, "l_i0", nl) - rows(st, "l_i1", nl)).abs() / two_dt
            vol = (rows(st, "l_v0", nl) - rows(st, "l_v1", nl)).abs() / two_dt
            lte = torch.maximum(lte, torch.maximum(cur, vol).amax(dim=1))

        can_halve = dte > sc.minstep
        hard_fail = ~nr_ok & ~can_halve
        reject = (~nr_ok & can_halve) | (nr_ok & (lte > sc.trtol) & can_halve)
        accept = nr_ok & ~reject
        acc_act = accept & end

        # compat commit (capacitor.go:155-171, inductor.go:81-114)
        new = []
        if nc:
            vd = xn[:, cn[:, 0]] - xn[:, cn[:, 1]]
            new += [craw * vd, rows(st, "c_q0", nc), vd, rows(st, "c_v0", nc)]
        if nl:
            vd = xn[:, ln[:, 0]] - xn[:, ln[:, 1]]
            new += [vd * 1e-9 / lval, rows(st, "l_i1", nl) + vd * dte_c / lval,
                    vd, rows(st, "l_v0", nl), vd * dte_c]
        if new:
            st = torch.where(acc_act[:, None], torch.cat(new, dim=1), st)

        t = torch.where(acc_act, next_t, t)
        grow = torch.where(lte < sc.trtol / 100.0, grow2, grow11)
        dt_g = torch.minimum(dte * grow, tmax)
        dt_grown = torch.where((next_t < sc.tstop) & (dte < sc.tmax), dt_g,
                               dte)
        dt = torch.where(end, torch.where(accept, dt_grown, dte / 2.0), dt)
        done = done | (end & ((accept & (next_t >= sc.tstop)) | hard_fail))
        fail = fail | (end & hard_fail)
        acc = acc + acc_act.to(I32)
        att = att + end.to(I32)
        nri = nri + torch.where(end, kn, zero_i)
        if nonlin:
            run_c = running[:, None]
            jv = torch.where(end[:, None], jv_used, jv)
            x = torch.where(run_c, xn, x)
            jvs = torch.where(run_c, jv_used, jvs)
            k = torch.where(running, torch.where(end, zero_i, kn), k)
        return (st, t, dt, done, fail, acc, att, nri, jv, k, x, jvs)

    # the loop carry lives in fixed buffers; a chunk of steps reads them
    # and writes its result back, so on the card it can be replayed as one
    # captured CUDA graph (the same operations without the host's per-op
    # launch cost)
    carry = (state.clone(),
             torch.zeros(b, dtype=F64, device=device),
             torch.full((b,), sc.minstep, dtype=F64, device=device),
             torch.full((b,), sc.tstop <= 0.0, dtype=torch.bool,
                        device=device),
             torch.zeros(b, dtype=torch.bool, device=device),
             torch.zeros(b, dtype=I32, device=device),
             torch.zeros(b, dtype=I32, device=device),
             torch.zeros(b, dtype=I32, device=device),
             jv.clone(),
             torch.zeros(b, dtype=I32, device=device),
             torch.zeros((b, n), dtype=F64, device=device),
             jv.clone())
    every = CHECK_EVERY_NL if nonlin else CHECK_EVERY

    def chunk():
        c = carry
        for _ in range(every):
            c = step(c)
        for buf, val in zip(carry, c):
            buf.copy_(val)

    def pending():
        done, att = carry[3], carry[6]
        return bool((~done & (att < sc.max_attempts)).any())

    run_chunk = chunk
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            chunk()  # eager first chunk: warms up, and is real progress
        torch.cuda.current_stream(device).wait_stream(side)
        if pending():
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                chunk()
            run_chunk = graph.replay
    # every step of a running lane advances its attempt, and an attempt
    # takes at most max_iter steps, so all lanes stop within this bound
    steps = (sc.max_attempts + 1) * (sc.max_iter if nonlin else 1)
    for _ in range(0, steps, every):
        if not pending():
            break
        run_chunk()
    st, t, dt, _, fail, acc, att, nri, jv = carry[:9]
    return RunResult(st, t, dt, acc, att, fail.to(I32), jv, nri)


# ------------------------------------------------------------ dispatch


def run_lanes(plan, dev, src, state, sc: RunScalars, jv=None) -> RunResult:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.is_cuda:
        return launch_run_kernel(plan, dev, src, state, sc, jv)
    if dev.device.type == "cpu":
        return run_plain(plan, dev, src, state, sc, jv)
    raise ValueError(f"no whole-run transient for device {dev.device}")


def make_tran_run(cc, cfg, opts=DEFAULTS, semantics: str = "compat"):
    """Batched whole-run transient: fn(params, state0) -> TranOutput.

    ``params``/``state0`` are dicts of f64 tensors on one device (shared
    leaves (nk,), batched leaves (B, nk)); the run happens there.  A
    nonlinear deck first takes its operating point through the OP kernel
    (``ops/op.make_op_fused``, rescue ladders included) unless ``cfg.uic``:
    its junction voltages warm-start the transient, whose committed state
    stays the given one (compat, tran.go:57-75)."""
    why = run_ineligible_reason(cc, semantics, "none", opts)
    if why is not None:
        raise NotImplementedError(
            f"circuit not eligible for the whole-run kernel: {why}")
    plan = make_plan(cc)
    sc = RunScalars(float(cfg.tstop), float(cfg.minstep), float(cfg.tmax),
                    float(opts.trtol), int(cfg.max_attempts),
                    float(opts.reltol), float(opts.abstol),
                    int(opts.max_iter))
    need_op = plan.nonlinear and not cfg.uic
    op_fn = None
    if need_op:
        from .op import make_op_fused

        op_fn = make_op_fused(cc, opts, semantics=semantics)

    def tran_run(params, state0) -> TranOutput:
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        dev = const_stack(plan, params, b, device, opts.temp, state0)
        src = source_stack(plan, params, b, device)
        st0 = init_state_stack(plan, state0, b, device)
        jv0 = None
        if plan.nonlinear:  # warm start: the OP's junctions, or 0 (UIC)
            jv0 = jv_stack(plan, op_fn(params, state0).jv if need_op
                           else init_jv(cc, device), b)
        res = run_lanes(plan, dev, src, st0, sc, jv0)
        state = unpack_state(plan, res.state, state0, res.accepted, b)
        zeros_i = torch.zeros(b, dtype=I32, device=device)
        return TranOutput(
            out_x=torch.zeros((b, 1, cc.np1), dtype=F64, device=device),
            out_t=torch.zeros((b, 1), dtype=F64, device=device),
            out_n=zeros_i,
            fail=res.fail > 0,
            accepted=res.accepted,
            attempts=res.attempts,
            nr_iters=res.nr_iters,
            t_final=res.t,
            state=state,
            jv=jv_tree(plan, res.jv) if plan.nonlinear else {},
            store_overflow=torch.zeros(b, dtype=torch.bool, device=device),
            dt_final=res.dt,
        )

    tran_run.op = op_fn
    return tran_run

