"""Whole-run transient for linear compat decks: each Monte-Carlo lane's
complete adaptive time loop in one launch.

The counterpart of ``ops/pallas_run.py`` in the JAX package
(``run_ineligible_reason``, ``_run_const64``, ``_source_vals``,
``_run_core`` and ``make_tran_run``), for R/C/L/V/I decks with DC, SIN,
PULSE and PWL sources.  Three pieces live here:

* ``launch_run_kernel``: the wrapper of ``csrc/run_kernel.cu`` (one thread
  per lane, f64).  It checks its inputs, allocates the outputs, launches on
  the current stream and counts its launches in ``.launches``.
* ``run_plain``: the same arithmetic as batched f64 torch operations with
  per-lane masks.  The CPU tests use it, and ``chip_smoke.py`` holds the
  kernel against it on the card.  It looks at the host for pending lanes
  only once every ``CHECK_EVERY`` attempts.
* ``run_lanes``: takes the plain version for CPU tensors only; on CUDA
  tensors it launches the kernel or raises.

Each attempt is the reference's tran.go:96-152 (the general engine,
engine/tran.py:145-200): clamp dt at tstop; evaluate the sources at the OLD
time t (PLAN.md 2); build the companion system and solve it by Gauss-Jordan
with partial pivoting (largest |pivot| among unused rows, lowest row on a
tie; a zero pivot poisons the row so x goes non-finite); take the LTE from
the COMMITTED C/L state; accept (commit, grow dt x2 or x1.1 up to tmax) or
reject (halve dt while dt > minstep, else a hard fail).  A lane stops when
it reaches tstop, hard-fails, runs ``max_attempts`` attempts, or finds its
t or dt non-finite (then it is marked failed too).
"""

from typing import NamedTuple

import torch

from ..engine.options import DEFAULTS
from ..engine.tran import TranOutput
from ..models.sources import eval_sources
from . import _build
from .run_plan import (TAG_CEQ, TAG_G, TAG_GEQ, TAG_ISRC, TAG_LRHS,
                       TAG_LTERM, TAG_ONE, TAG_VSRC, const_stack,
                       fused_ineligible_reason, infer_batch,
                       init_state_stack, make_plan, source_leaves,
                       source_stack, unpack_state)

NP1_CAP = 32  # largest matrix the kernel is compiled for (NMAX 8/16/32)
MAX_SOURCES = 32  # per-thread source-value array of the kernel
MAX_TOPO = 12288  # int32 words of shared memory for the plan (48 KB)
CHECK_EVERY = 256  # plain version: attempts between host checks

F64 = torch.float64
I32 = torch.int32


def run_ineligible_reason(cc, semantics: str, store: str, opts):
    """Why this run can NOT use the whole-run kernel; None when it can."""
    why = fused_ineligible_reason(cc, semantics, store, opts)
    if why is not None:
        return why
    if cc.np1 > NP1_CAP:
        return (f"np1={cc.np1} exceeds the kernel's matrix cap of "
                f"{NP1_CAP}")
    nsrc = sum(cc.kind_count(k) for k in ("V", "I") if k in cc.idx)
    if nsrc > MAX_SOURCES:
        return f"{nsrc} sources exceed the kernel's cap of {MAX_SOURCES}"
    if make_plan(cc).topo.size > MAX_TOPO:
        return "stamp plan exceeds the kernel's shared-memory table"
    return None


class RunScalars(NamedTuple):
    """The step-control scalars of one run."""

    tstop: float
    minstep: float
    tmax: float
    trtol: float
    max_attempts: int


class RunResult(NamedTuple):
    state: torch.Tensor  # (B, ks) committed state on exit
    t: torch.Tensor  # (B,) f64
    dt: torch.Tensor  # (B,) f64
    accepted: torch.Tensor  # (B,) int32
    attempts: torch.Tensor  # (B,) int32
    fail: torch.Tensor  # (B,) int32, 0 or 1


# ------------------------------------------------------------ the kernel


def _check_inputs(plan, dev, src, state):
    b = dev.shape[0]
    for name, x, width in (("dev", dev, plan.nd), ("src", src, plan.nrc),
                           ("state", state, plan.ks)):
        if x.dtype != F64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if x.shape != (b, width):
            raise ValueError(f"{name} must be ({b}, {width}), got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != dev.device:
            raise ValueError(f"{name} is on {x.device}, dev on {dev.device}")


def launch_run_kernel(plan, dev, src, state, sc: RunScalars) -> RunResult:
    """Run every lane's transient with ``csrc/run_kernel.cu``.

    ``dev``/``src``/``state`` are the (B, ·) f64 CUDA rows of
    ``ops/run_plan``; ``state`` is not modified."""
    if not dev.is_cuda:
        raise ValueError("launch_run_kernel needs CUDA tensors")
    _check_inputs(plan, dev, src, state)
    if plan.np1 > NP1_CAP or plan.topo.size > MAX_TOPO:
        raise ValueError("deck exceeds the kernel's caps "
                         "(see run_ineligible_reason)")
    lib = _build.load()
    device = dev.device
    b = dev.shape[0]
    topo = torch.as_tensor(plan.topo, device=device)
    st = state.clone()
    t = torch.empty(b, dtype=F64, device=device)
    dt = torch.empty(b, dtype=F64, device=device)
    acc = torch.empty(b, dtype=I32, device=device)
    att = torch.empty(b, dtype=I32, device=device)
    fail = torch.empty(b, dtype=I32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsr_run(
            plan.np1, topo.data_ptr(), int(plan.topo.size),
            dev.data_ptr(), src.data_ptr(), st.data_ptr(), t.data_ptr(),
            dt.data_ptr(), acc.data_ptr(), att.data_ptr(), fail.data_ptr(),
            b, float(sc.tstop), float(sc.minstep), float(sc.tmax),
            float(sc.trtol), int(sc.max_attempts), stream)
    if err != 0:
        raise RuntimeError(f"run kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err)})")
    launch_run_kernel.launches += 1
    return RunResult(st, t, dt, acc, att, fail)


launch_run_kernel.launches = 0


# ------------------------------------------------------- the plain version


def _plain_tables(plan, device):
    """Gather tables of the plain version: where each stamp entry reads
    its term, and the per-cell entry lists in scatter order (slots)."""
    nr, nc, nl, nv, ni = plan.counts
    base = {TAG_G: 0, TAG_GEQ: nr, TAG_LTERM: nr + nc,
            TAG_ONE: nr + nc + nl, TAG_CEQ: nr + nc + nl + 1,
            TAG_LRHS: nr + 2 * nc + nl + 1, TAG_VSRC: nr + 2 * nc + 2 * nl + 1,
            TAG_ISRC: nr + 2 * nc + 2 * nl + 1 + nv}
    n = plan.np1
    term_col, sign, cells = [], [], {}
    for e, (row, col, tag, idx, sgn) in enumerate(plan.entries.tolist()):
        term_col.append(base[tag] + (0 if tag == TAG_ONE else idx))
        sign.append(float(sgn))
        cells.setdefault(row * (n + 1) + col, []).append(e)
    flat = list(cells)
    nslot = max((len(v) for v in cells.values()), default=0)
    slot_entry = [[cells[c][s] if s < len(cells[c]) else 0 for c in flat]
                  for s in range(nslot)]
    slot_mask = [[s < len(cells[c]) for c in flat] for s in range(nslot)]

    def lt(v):
        return torch.as_tensor(v, dtype=torch.long, device=device)

    return dict(
        term_col=lt(term_col),
        sign=torch.as_tensor(sign, dtype=F64, device=device),
        cell_flat=lt(flat),
        slot_entry=[lt(v) for v in slot_entry],
        slot_mask=[torch.as_tensor(v, device=device) for v in slot_mask],
        c_nodes=lt(plan.c_nodes), l_nodes=lt(plan.l_nodes),
    )


def _gauss_jordan(m, poison):
    """Batched Gauss-Jordan on (B, n, n+1) augmented systems with the
    kernel's pivot rule; returns x (B, n), non-finite where singular.
    ``poison`` (n, n+1) holds the row a zero pivot at stage k leaves:
    inf everywhere but 1 at column k."""
    b, n, _ = m.shape
    lane = torch.arange(b, device=m.device)
    used = torch.zeros((b, n), dtype=torch.bool, device=m.device)
    perm, col_max = [], []
    for k in range(n):
        mk = m[:, :, k]
        col = mk.abs().masked_fill(used, -1.0)
        mx = col.amax(dim=1, keepdim=True)  # NaN if any unused entry is
        col_max.append(mx)
        # first row holding the largest |entry| among the unused rows
        p = (col == mx).to(torch.uint8).argmax(dim=1)
        prow = m[lane, p]  # (B, n+1)
        piv = prow[:, k:k + 1]
        bad = piv == 0
        prow = torch.where(bad, poison[k], prow / torch.where(bad, 1.0, piv))
        f = mk.scatter(1, p[:, None], 0.0)
        m = m - f[:, :, None] * prow[:, None, :]
        m[lane, p] = prow
        used = used.scatter(1, p[:, None], True)
        perm.append(p)
    x = m[:, :, n].gather(1, torch.stack(perm, dim=1))
    nan_col = torch.isnan(torch.cat(col_max, dim=1)).any(dim=1, keepdim=True)
    return torch.where(nan_col, float("nan"), x)


def run_plain(plan, dev, src, state, sc: RunScalars) -> RunResult:
    """The kernel's arithmetic as batched torch operations on any device."""
    _check_inputs(plan, dev, src, state)
    device = dev.device
    b = dev.shape[0]
    n = plan.np1
    nr, nc, nl, nv, ni = plan.counts
    L = plan.layout
    tb = _plain_tables(plan, device)
    g = dev[:, :nr]
    cadj = dev[:, nr:nr + nc]
    craw = dev[:, nr + nc:nr + 2 * nc]
    lval = dev[:, nr + 2 * nc:nr + 2 * nc + nl]
    pv = source_leaves(plan, src, "V") if nv else None
    pi = source_leaves(plan, src, "I") if ni else None
    ones = torch.ones((b, 1), dtype=F64, device=device)
    cn, ln = tb["c_nodes"], tb["l_nodes"]
    tstop = torch.tensor(sc.tstop, dtype=F64, device=device)
    tmax = torch.tensor(sc.tmax, dtype=F64, device=device)
    grow2 = torch.tensor(2.0, dtype=F64, device=device)
    grow11 = torch.tensor(1.1, dtype=F64, device=device)
    poison = torch.full((n, n + 1), float("inf"), dtype=F64, device=device)
    poison[torch.arange(n), torch.arange(n)] = 1.0

    def rows(st, key, nk):
        return st[:, L[key]:L[key] + nk]

    def attempt(carry):
        st, t, dt, done, fail, acc, att = carry
        active = ~done & (att < sc.max_attempts)
        bad = active & ~(torch.isfinite(t) & torch.isfinite(dt))
        done = done | bad
        fail = fail | bad
        active = active & ~bad

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
        vals = torch.cat(terms, dim=1)[:, tb["term_col"]] * tb["sign"]
        cell = torch.zeros((b, len(tb["cell_flat"])), dtype=F64, device=device)
        for ent, mask in zip(tb["slot_entry"], tb["slot_mask"]):
            cell = cell + torch.where(mask, vals[:, ent], 0.0)
        m = torch.zeros((b, n * (n + 1)), dtype=F64, device=device)
        m[:, tb["cell_flat"]] = cell
        m[:, 0] = 1.0  # ground row: x[0] = 0
        x = _gauss_jordan(m.view(b, n, n + 1), poison)

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

        nr_ok = torch.isfinite(x).all(dim=1)
        can_halve = dte > sc.minstep
        hard_fail = ~nr_ok & ~can_halve
        reject = (~nr_ok & can_halve) | (nr_ok & (lte > sc.trtol) & can_halve)
        accept = nr_ok & ~reject
        acc_act = accept & active

        # compat commit (capacitor.go:155-171, inductor.go:81-114)
        new = []
        if nc:
            vd = x[:, cn[:, 0]] - x[:, cn[:, 1]]
            new += [craw * vd, rows(st, "c_q0", nc), vd, rows(st, "c_v0", nc)]
        if nl:
            vd = x[:, ln[:, 0]] - x[:, ln[:, 1]]
            new += [vd * 1e-9 / lval, rows(st, "l_i1", nl) + vd * dte_c / lval,
                    vd, rows(st, "l_v0", nl), vd * dte_c]
        if new:
            st = torch.where(acc_act[:, None], torch.cat(new, dim=1), st)

        t = torch.where(acc_act, next_t, t)
        grow = torch.where(lte < sc.trtol / 100.0, grow2, grow11)
        dt_g = torch.minimum(dte * grow, tmax)
        dt_grown = torch.where((next_t < sc.tstop) & (dte < sc.tmax), dt_g,
                               dte)
        dt = torch.where(active, torch.where(accept, dt_grown, dte / 2.0), dt)
        done = done | (active & ((accept & (next_t >= sc.tstop)) | hard_fail))
        fail = fail | (active & hard_fail)
        return (st, t, dt, done, fail, acc + acc_act.to(I32),
                att + active.to(I32))

    # the loop carry lives in fixed buffers; a chunk of attempts reads them
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
             torch.zeros(b, dtype=I32, device=device))

    def chunk():
        c = carry
        for _ in range(CHECK_EVERY):
            c = attempt(c)
        for buf, val in zip(carry, c):
            buf.copy_(val)

    def pending():
        _, _, _, done, _, _, att = carry
        return bool((~done & (att < sc.max_attempts)).any())

    step = chunk
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
            step = graph.replay
    # every active attempt counts, so all lanes stop within max_attempts
    for _ in range(0, sc.max_attempts + 1, CHECK_EVERY):
        if not pending():
            break
        step()
    st, t, dt, _, fail, acc, att = carry
    return RunResult(st, t, dt, acc, att, fail.to(I32))


# ------------------------------------------------------------ dispatch


def run_lanes(plan, dev, src, state, sc: RunScalars) -> RunResult:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.is_cuda:
        return launch_run_kernel(plan, dev, src, state, sc)
    if dev.device.type == "cpu":
        return run_plain(plan, dev, src, state, sc)
    raise ValueError(f"no whole-run transient for device {dev.device}")


def _first_leaf(tree):
    for tbl in tree.values():
        for leaf in tbl.values():
            return leaf
    raise ValueError("empty parameter tree")


def make_tran_run(cc, cfg, opts=DEFAULTS, semantics: str = "compat"):
    """Batched whole-run transient: fn(params, state0) -> TranOutput.

    ``params``/``state0`` are dicts of f64 tensors on one device (shared
    leaves (nk,), batched leaves (B, nk)); the run happens there."""
    why = run_ineligible_reason(cc, semantics, "none", opts)
    if why is not None:
        raise NotImplementedError(
            f"circuit not eligible for the whole-run kernel: {why}")
    plan = make_plan(cc)
    sc = RunScalars(float(cfg.tstop), float(cfg.minstep), float(cfg.tmax),
                    float(opts.trtol), int(cfg.max_attempts))

    def tran_run(params, state0) -> TranOutput:
        device = _first_leaf(params).device
        b = infer_batch(params, state0)
        dev = const_stack(plan, params, b, device, opts.temp)
        src = source_stack(plan, params, b, device)
        st0 = init_state_stack(plan, state0, b, device)
        res = run_lanes(plan, dev, src, st0, sc)
        state = unpack_state(plan, res.state, state0, res.accepted, b)
        zeros_i = torch.zeros(b, dtype=I32, device=device)
        return TranOutput(
            out_x=torch.zeros((b, 1, cc.np1), dtype=F64, device=device),
            out_t=torch.zeros((b, 1), dtype=F64, device=device),
            out_n=zeros_i,
            fail=res.fail > 0,
            accepted=res.accepted,
            attempts=res.attempts,
            nr_iters=res.attempts.clone(),
            t_final=res.t,
            state=state,
            jv={},
            store_overflow=torch.zeros(b, dtype=torch.bool, device=device),
            dt_final=res.dt,
        )

    return tran_run
