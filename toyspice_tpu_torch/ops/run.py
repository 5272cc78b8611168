"""Whole-run transient under compat or physics semantics: each Monte-Carlo
lane's complete adaptive time loop in one launch.

The counterpart of ``ops/pallas_run.py`` in the JAX package
(``run_ineligible_reason``, ``_run_const64``, ``_source_vals``,
``_run_core`` and ``make_tran_run``), for R/C/L/V/I decks with DC, SIN,
PULSE and PWL sources, plus magnetic inductors and mutual couplings,
and diodes, BJTs and MOSFETs; and, through the kernel's store
instantiation, of ``ops/pallas_tran.py``'s ``make_tran_fused``
(``store='full'``, the streamed store and resume). The pieces:

* ``launch_run_kernel`` and ``launch_store_kernel``: the wrappers of
  ``csrc/run_kernel.cu`` (compat), ``csrc/run_kernel_phys.cu`` (physics)
  and ``csrc/run_kernel_mag.cu`` (physics with LM or K, compat LM or K
  with a Newton), the instantiations of ``csrc/run_kernel.cuh`` (one
  segment of a warp per lane, a thread a row of the system and, in a
  Newton deck, a thread a device, f64), without and with the waveform
  store. Each
  checks its inputs, allocates the outputs, launches on the current
  stream and counts its launches in ``.launches``.
* ``run_plain`` and ``store_plain``: the same arithmetic as batched f64
  torch operations with per-lane masks.  The CPU tests use them, and
  ``chip_smoke.py`` holds the kernels against them on the card.  Each
  step is one Newton iteration of every lane (one attempt of a linear
  deck), so lanes at different points of their runs advance together; the
  host looks for pending lanes once every ``CHECK_EVERY`` steps.
* ``run_lanes`` and ``store_lanes``: the plain versions for CPU tensors
  only; on CUDA tensors they launch the kernel or raise.

A run without the store starts every lane at t = 0; the store
instantiation starts each lane from its own t, dt and attempt count
(``RunStart``; a fresh run: 0, minstep, 0), so a resumed or streamed run
continues the exact adaptive trajectory and ``max_attempts`` binds the
whole run.  A resumed run without waveforms is the store instantiation
with ``NO_STORE``.

Each attempt is the reference's tran.go:96-152 (the general engine,
engine/tran.py:145-200): clamp dt at tstop; evaluate the sources at the OLD
time t (PLAN.md 2; trapezoidal physics at next_t); solve the companion
system (compat, or physics: BE with the previous step's charge, or the
trapezoidal companions after each device's first committed step): one
Gauss-Jordan solve for a linear deck, else the Newton of ``ops/newton.py``
from x = 0 with the carried junction voltages at iteration 0; take the LTE
from the COMMITTED C/L state; accept (commit, grow dt x2 or x1.1 up to
tmax) or reject (halve dt while dt > minstep, else a hard fail). Compat
commits the reference's C/L state; physics also the capacitor current, the
inductor current from its branch row, the diode and MOSFET charge memory
re-evaluated at the raw solution, each magnetic winding's currents,
voltages, flux and J-A core (its core's summed mmf, one J-A step), and the
first-step flags (engine/state.py make_commit).  A physics attempt stamps
each LM's incremental inductance from its committed core (backward Euler
under trap too) and each K's M = k·sqrt(La·Lb) of the live inductances.
The junction voltages of the last Newton iteration carry to the next
attempt whether it accepted or not. A lane stops when it reaches
tstop, hard-fails or runs ``max_attempts`` attempts; a non-finite t or dt
does not stop it early, as in the general engine. With the store, an
accepted attempt at next_t >= tstart keeps the solution (ground row
included) and next_t as the lane's next row (tran.go:141-143); the streamed
store pauses a lane whose ``max_store`` rows are full, the plain store
drops the row and flags the lane's overflow.
"""

import ctypes
from typing import NamedTuple

import torch

from ..engine.nlstate import init_jv
from ..engine.options import DEFAULTS
from ..engine.state import make_op_seed
from ..engine.tran import TranOutput
from ..models import magnetic
from ..models.sources import eval_sources
from . import _build
from .newton import MAX_NL_DEVICES, Builder, Devices, converged
from .run_plan import (CORE_KEYS, LM_PHYS_ROWS, NL_SLOTS, const_stack,
                       first_leaf, fused_ineligible_reason, infer_batch,
                       init_state_stack, jv_stack, jv_tree, mag_width,
                       make_plan, source_leaves, source_stack, unpack_state)

NP1_CAP = 32  # largest matrix the kernel is compiled for (NMAX 8/16/32)
MAX_SOURCES = 32  # source values a lane keeps in the run kernel's slice
MAX_TOPO = 12288  # int32 words of shared memory for the plan (48 KB)
CHECK_EVERY = 256  # plain version: steps between host checks (linear)
CHECK_EVERY_NL = 64  # the same for a Newton deck (longer steps)

F64 = torch.float64
I32 = torch.int32


def kernel_caps_reason(plan):
    """Why the kernels' segments and shared table can NOT hold this deck;
    None when they can (the run, OP and DC sweep kernels)."""
    if plan.np1 > NP1_CAP:
        return (f"np1={plan.np1} exceeds the kernel's matrix cap of "
                f"{NP1_CAP}")
    nsrc = sum(len(v) for v in plan.stype.values())
    if nsrc > MAX_SOURCES:
        return f"{nsrc} sources exceed the kernel's cap of {MAX_SOURCES}"
    n_nl = sum(plan.counts[5:])
    if n_nl > MAX_NL_DEVICES:
        return (f"{n_nl} diodes, BJTs and MOSFETs exceed the kernel's cap "
                f"of {MAX_NL_DEVICES} (the junction voltages and value "
                "slots a warp segment keeps in shared memory)")
    if plan.base_len > MAX_TOPO:
        return "stamp plan exceeds the kernel's shared-memory table"
    return None


def newton_doubles(plan):
    """Doubles a lane of a Newton deck keeps in its segment's slice of the
    run kernel's shared memory: its junction voltages and its value slots
    (0 for a linear deck)."""
    if not plan.nonlinear:
        return 0
    return plan.kj + sum(NL_SLOTS[kind] * cnt
                         for kind, cnt in zip("DQM", plan.counts[5:]))


def segment_shape(plan, b):
    """The run kernel's launch for b lanes of ``plan`` as the compat
    library computes it (``csrc/run_kernel.cuh`` ``seg_shape``, the shape
    ``launch`` launches, linear or Newton): (W, lanes a block, blocks,
    threads a block, bytes of shared memory a block)."""
    out = (ctypes.c_int * 5)()
    err = _build.load("run").tsr_run_seg_shape(
        plan.np1, b, int(plan.topo.size), newton_doubles(plan),
        ctypes.addressof(out))
    if err != 0:
        raise ValueError(f"np1={plan.np1} has no segment launch")
    return tuple(out)


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
    """The step-control and Newton scalars of one run; ``trap`` picks the
    trapezoidal companions (a plan with the physics state rows only)."""

    tstop: float
    minstep: float
    tmax: float
    trtol: float
    max_attempts: int
    reltol: float = DEFAULTS.reltol
    abstol: float = DEFAULTS.abstol
    max_iter: int = DEFAULTS.max_iter
    trap: bool = False


class RunStart(NamedTuple):
    """Each lane's start: t (B,) f64, dt (B,) f64, attempts (B,) int32."""

    t: torch.Tensor
    dt: torch.Tensor
    attempts: torch.Tensor


class Store(NamedTuple):
    """The waveform store of one run."""

    tstart: float
    max_store: int
    stream: bool = False  # pause a lane whose rows are full


NO_STORE = Store(0.0, 0)  # keeps no row: a resumed run without waveforms


class Waveforms(NamedTuple):
    out_x: torch.Tensor  # (B, max_store, np1) f64, zero past out_n
    out_t: torch.Tensor  # (B, max_store) f64, zero past out_n
    out_n: torch.Tensor  # (B,) int32 rows kept
    overflow: torch.Tensor  # (B,) bool: a row was dropped


class RunResult(NamedTuple):
    state: torch.Tensor  # (B, ks) committed state on exit
    t: torch.Tensor  # (B,) f64
    dt: torch.Tensor  # (B,) f64
    accepted: torch.Tensor  # (B,) int32 (this call's)
    attempts: torch.Tensor  # (B,) int32 (cumulative from the start's)
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


def _check_inputs(plan, dev, src, state, jv, start):
    b = dev.shape[0]
    check_rows(b, dev.device,
               (("dev", dev, plan.nd), ("src", src, plan.nrc),
                ("state", state, plan.ks), ("jv", jv, max(plan.kj, 1))))
    if start is None:
        return
    for name, x, dtype in (("start.t", start.t, F64),
                           ("start.dt", start.dt, F64),
                           ("start.attempts", start.attempts, I32)):
        if x.dtype != dtype or x.shape != (b,) or x.device != dev.device:
            raise ValueError(f"{name} must be a ({b},) {dtype} tensor on "
                             f"{dev.device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")


def _check_trap(plan, sc):
    if sc.trap and not plan.physics:
        raise ValueError("trapezoidal integration needs a physics plan "
                         "(make_plan(cc, physics=True))")


def _jv0(plan, dev, jv):
    if jv is None:
        return torch.zeros((dev.shape[0], max(plan.kj, 1)), dtype=F64,
                           device=dev.device)
    return jv


def fresh_start(b, sc: RunScalars, device) -> RunStart:
    """t = 0, dt = minstep, no attempts: the start of a run from t = 0."""
    return RunStart(torch.zeros(b, dtype=F64, device=device),
                    torch.full((b,), sc.minstep, dtype=F64, device=device),
                    torch.zeros(b, dtype=I32, device=device))


def _waves(b, m, np1, device, out):
    """The store's outputs: new zeroed out_x/out_t, or ``out``'s after a
    check (the kernel writes only the rows it keeps)."""
    if out is None:
        return (torch.zeros((b, m, np1), dtype=F64, device=device),
                torch.zeros((b, m), dtype=F64, device=device))
    for name, x, shape in (("out.out_x", out.out_x, (b, m, np1)),
                           ("out.out_t", out.out_t, (b, m))):
        if x.dtype != F64 or x.shape != shape or x.device != device \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} float64 "
                             f"tensor on {device}, got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    return out.out_x, out.out_t


def _launch(plan, dev, src, state, sc, jv, start, store, out=None):
    """One launch of ``csrc/run_kernel.cu``, with the store when ``store``
    is given (from ``start``; without the store every lane starts at 0);
    returns (RunResult, Waveforms or None)."""
    if not dev.is_cuda:
        raise ValueError("the run kernel needs CUDA tensors")
    jv = _jv0(plan, dev, jv)
    device = dev.device
    b = dev.shape[0]
    if store is not None and start is None:
        start = fresh_start(b, sc, device)
    _check_inputs(plan, dev, src, state, jv, start)
    if plan.mode != "tran":
        raise ValueError("the run kernel takes a plan of mode 'tran'")
    _check_trap(plan, sc)
    check_caps(plan)
    # the library (and its entry point tsr_<name>) of this instantiation:
    # run_kernel_mag.cu holds physics with LM or K and compat LM or K with
    # a Newton, run_kernel_phys.cu the rest of physics, run_kernel.cu the
    # rest of compat
    mag = plan.nlm + plan.nk > 0
    family = ("run_mag" if mag and (plan.physics or plan.nonlinear)
              else "run_phys" if plan.physics else "run")
    name = family + ("" if store is None else "_store")
    lib = _build.load(name)
    topo = torch.as_tensor(plan.topo, device=device)
    st = state.clone()
    jv_out = jv.clone()
    if store is None:  # the kernel starts at 0 and writes these
        t = torch.empty(b, dtype=F64, device=device)
        dt = torch.empty(b, dtype=F64, device=device)
        att = torch.empty(b, dtype=I32, device=device)
    else:
        t = start.t.clone()
        dt = start.dt.clone()
        att = start.attempts.clone()
    acc = torch.empty(b, dtype=I32, device=device)
    fail = torch.empty(b, dtype=I32, device=device)
    nri = torch.empty(b, dtype=I32, device=device)
    args = [plan.np1, int(plan.nonlinear), int(mag), int(plan.physics),
            int(sc.trap), topo.data_ptr(), int(plan.topo.size),
            newton_doubles(plan), dev.data_ptr(), src.data_ptr(),
            st.data_ptr(), jv_out.data_ptr(), t.data_ptr(), dt.data_ptr(),
            acc.data_ptr(), att.data_ptr(), fail.data_ptr(), nri.data_ptr(),
            b, float(sc.tstop), float(sc.minstep),
            float(sc.tmax), float(sc.trtol), int(sc.max_attempts),
            float(sc.reltol), float(sc.abstol), int(sc.max_iter)]
    wave = None
    if store is not None:
        m = int(store.max_store)
        wave = Waveforms(
            *_waves(b, m, plan.np1, device, out),
            torch.empty(b, dtype=I32, device=device),
            torch.empty(b, dtype=I32, device=device))
        args += [float(store.tstart), m, int(store.stream),
                 wave.out_x.data_ptr(), wave.out_t.data_ptr(),
                 wave.out_n.data_ptr(), wave.overflow.data_ptr()]
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, f"tsr_{name}")(*args, stream)
    if err != 0:
        raise RuntimeError(f"run kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err, name)})")
    res = RunResult(st, t, dt, acc, att, fail, jv_out, nri)
    if wave is not None:
        wave = wave._replace(overflow=wave.overflow > 0)
    return res, wave


def launch_run_kernel(plan, dev, src, state, sc: RunScalars,
                      jv=None) -> RunResult:
    """Run every lane's transient from t = 0 with ``csrc/run_kernel.cu``.

    ``dev``/``src``/``state``/``jv`` are the (B, ·) f64 CUDA rows of
    ``ops/run_plan`` (``jv`` None: zero junction voltages); the inputs are
    not modified."""
    res, _ = _launch(plan, dev, src, state, sc, jv, None, None)
    _build.count(launch_run_kernel)
    return res


launch_run_kernel.launches = 0


def launch_store_kernel(plan, dev, src, state, sc: RunScalars,
                        store: Store, jv=None, start: RunStart = None,
                        out: Waveforms = None):
    """The same run through the store instantiation of
    ``csrc/run_kernel.cu``, each lane from ``start`` (None:
    ``fresh_start``); returns (RunResult, Waveforms).  The counterpart of
    ``_fused_kernel`` and the waveform store around it.  ``out`` gives
    zeroed out_x and out_t to write into (its out_n and overflow are not
    read) in place of new ones."""
    res = _launch(plan, dev, src, state, sc, jv, start, store, out)
    _build.count(launch_store_kernel)
    return res


launch_store_kernel.launches = 0


# ------------------------------------------------------- the plain version


def run_plain(plan, dev, src, state, sc: RunScalars, jv=None) -> RunResult:
    """The kernel's arithmetic as batched torch operations on any device."""
    return _plain(plan, dev, src, state, sc, jv, None, None)[0]


def store_plain(plan, dev, src, state, sc: RunScalars, store: Store,
                jv=None, start: RunStart = None):
    """The store instantiation's arithmetic in torch: (RunResult,
    Waveforms)."""
    return _plain(plan, dev, src, state, sc, jv, start, store)


def _plain(plan, dev, src, state, sc, jv, start, store):
    jv = _jv0(plan, dev, jv)
    device = dev.device
    b = dev.shape[0]
    start = fresh_start(b, sc, device) if start is None else start
    _check_inputs(plan, dev, src, state, jv, start)
    _check_trap(plan, sc)
    n = plan.np1
    phys, trap = plan.physics, bool(sc.trap)
    nr, nc, nl, nv, ni = plan.counts[:5]
    nlm, nk = plan.nlm, plan.nk
    nonlin = plan.nonlinear
    L = plan.layout
    bld = Builder(plan, device)
    devs = Devices(plan, dev, phys) if nonlin else None
    g = dev[:, :nr]
    cadj = dev[:, nr:nr + nc]
    craw = dev[:, nr + nc:nr + 2 * nc]
    lval = dev[:, nr + 2 * nc:nr + 2 * nc + nl]
    mag = dev[:, nr + 2 * nc + nl:
              nr + 2 * nc + nl + mag_width(nlm, nk, phys)]
    if phys:  # the J-A leaves of each LM, each K's coefficient
        lmp = {key: mag[:, r * nlm:(r + 1) * nlm]
               for r, key in enumerate(LM_PHYS_ROWS)}
        kcoef = mag[:, len(LM_PHYS_ROWS) * nlm:]
    else:  # the frozen-core run constants
        lm_l0, lm_leff, lm_i0, lm_i1 = (mag[:, r * nlm:(r + 1) * nlm]
                                        for r in range(4))
        mij = mag[:, 4 * nlm:]
    # each K's partners as columns of [L | LM]
    kp = plan.kpairs.astype("int64")
    ka_col, kb_col = (torch.as_tensor(kp[:, c + 1] + (kp[:, c] != 0) * nl,
                                      device=device) for c in (0, 2))
    # trap's 2M/dt pairs: both windings linear, read through their L hist
    k_lin = (kp[:, 0] == 0) & (kp[:, 2] == 0)
    k_trap = trap and bool(k_lin.any())
    if k_trap:
        k_lin_t = torch.as_tensor(k_lin, device=device)
        ka_l, kb_l = (torch.as_tensor(kp[:, c + 1] * (kp[:, c] == 0),
                                      device=device) for c in (0, 2))
    if phys and nlm:
        lm_tab = torch.as_tensor(plan.lm_tab, dtype=torch.long,
                                 device=device)
        # same_core[:, j]: the windings that winding j's mmf adds to
        same_core = torch.as_tensor(plan.core[:, None] == plan.core[None],
                                    device=device)
    pv = source_leaves(plan, src, "V") if nv else None
    pi = source_leaves(plan, src, "I") if ni else None
    ones = torch.ones((b, 1), dtype=F64, device=device)
    cn = torch.as_tensor(plan.c_nodes, dtype=torch.long, device=device)
    ln = torch.as_tensor(plan.l_nodes, dtype=torch.long, device=device)
    lb = torch.as_tensor(plan.l_branch, dtype=torch.long, device=device)
    tstop = torch.tensor(sc.tstop, dtype=F64, device=device)
    tmax = torch.tensor(sc.tmax, dtype=F64, device=device)
    grow2 = torch.tensor(2.0, dtype=F64, device=device)
    grow11 = torch.tensor(1.1, dtype=F64, device=device)
    zero_i = torch.zeros((), dtype=I32, device=device)

    def rows(st, key, nk):
        return st[:, L[key]:L[key] + nk]

    def step(carry):
        st, t, dt, done, fail, acc, att, nri, jv, k, x, jvs = carry[:12]
        running = ~done & (att < sc.max_attempts)
        if store is not None:
            n_kept, dropped = carry[12:]
            if store.stream:  # a full buffer pauses the lane
                running = running & (n_kept < store.max_store)

        tpdt = t + dt
        over = tpdt > sc.tstop
        next_t = torch.where(over, tstop, tpdt)
        dte = torch.where(over, tstop - t, dt)
        dtl = torch.where(dte > 0, dte, 1e-9)
        dte_c, dtl_c = dte[:, None], dtl[:, None]

        geq, lterm = cadj / dte_c, lval / dtl_c
        # compat charges with the reference's lagged q1, physics BE with
        # q0 (assemble.py's C block)
        ceq = rows(st, "c_q0" if phys else "c_q1", nc) / dte_c
        lrhs = lterm * rows(st, "l_i1", nl)
        if trap:  # the trapezoidal companions, BE on the first step
            c_on = rows(st, "c_hist", nc) > 0
            geq = torch.where(c_on, 2.0 * cadj / dte_c, geq)
            ceq = torch.where(c_on, geq * rows(st, "c_v0", nc)
                              + rows(st, "c_i0", nc), ceq)
            l_on = rows(st, "l_hist", nl) > 0
            lterm = torch.where(l_on, 2.0 * lval / dtl_c, lterm)
            lrhs = lterm * rows(st, "l_i1", nl) + torch.where(
                l_on, rows(st, "l_v0", nl), 0.0)
        terms = [g, geq, lterm, ones, ceq, lrhs]
        # trapezoidal physics takes the sources at the end of the step
        # (engine/tran.py), BE at the old time (PLAN.md 2)
        t_src = next_t if trap else t
        if nv:
            terms.append(eval_sources(plan.stype["V"], pv, t_src))
        if ni:
            terms.append(eval_sources(plan.stype["I"], pi, t_src))
        if nlm and phys:  # the incremental L of the committed core,
            # backward Euler under trap too (assemble.py's physics LM)
            l_used = magnetic.l_incremental(lmp["l0"],
                                            rows(st, "lm_dMdH", nlm))
            lmterm = l_used / dtl_c
            terms += [lmterm, lmterm * rows(st, "lm_i1", nlm)]
        elif nlm:  # the compat LM branch value (assemble.py LM tran)
            use_l0 = (t[:, None] < dtl_c) | (lm_i0.abs() < 1e-9)
            lmterm = torch.where(use_l0, lm_l0, lm_leff) / dtl_c
            terms += [lmterm, lmterm * lm_i1]
        if nk and phys:
            # M = k·sqrt(La·Lb) from the live inductances and the +M/dt
            # memory of the partner's committed current; the plan's sign
            # on the RHS is -1 (compat's), so these values carry the minus
            lv = torch.cat([lval, l_used] if nlm else [lval], dim=1)
            i1s = torch.cat([rows(st, "l_i1", nl)]
                            + ([rows(st, "lm_i1", nlm)] if nlm else []),
                            dim=1)
            mk = kcoef * torch.sqrt(lv[:, ka_col] * lv[:, kb_col])
            if trap:  # 2M/dt on both-linear pairs once both have history
                mcoef = mk / dte_c
                if k_trap:
                    hist = rows(st, "l_hist", nl)
                    use_tr = k_lin_t & (hist[:, ka_l] > 0) & (hist[:, kb_l]
                                                              > 0)
                    mcoef = torch.where(use_tr, 2.0 * mk / dte_c, mcoef)
                terms += [mcoef, -(mcoef * i1s[:, kb_col]),
                          -(mcoef * i1s[:, ka_col])]
            else:
                terms += [mk / dte_c, -((mk * i1s[:, kb_col]) / dte_c),
                          -((mk * i1s[:, ka_col]) / dte_c)]
        elif nk:  # -M/dt and the junk-i0 memory (mutual.go:114-115)
            i0s = torch.cat([rows(st, "l_i0", nl), lm_i0], dim=1)
            terms += [mij / dte_c, (mij * i0s[:, kb_col]) / dte_c,
                      (mij * i0s[:, ka_col]) / dte_c]
        if nonlin:
            # iteration 0 of an attempt: x = 0 and the carried junction
            # voltages (warm start); later ones limit the new solution
            first = (k == 0)[:, None]
            xp = torch.where(first, 0.0, x)
            jv_used = torch.where(first, jv, devs.limit(xp, jvs))
            terms.append(devs.values(jv_used, dte_c, st=st, trap=trap))
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

        # the commit: compat (capacitor.go:155-171, inductor.go:81-114) or
        # physics (engine/state.py make_commit), rows in state_layout order
        new, tail = [], []
        if nc:
            vd = xn[:, cn[:, 0]] - xn[:, cn[:, 1]]
            v0 = rows(st, "c_v0", nc)
            new += [craw * vd, rows(st, "c_q0", nc), vd, v0]
            if phys:
                dv = vd - v0
                if trap:  # the stamp's C_t: the TR recursion must match it
                    i0 = torch.where(rows(st, "c_hist", nc) > 0,
                                     2.0 * cadj / dte_c * dv
                                     - rows(st, "c_i0", nc),
                                     cadj * dv / dte_c)
                else:
                    i0 = craw * dv / dte_c
                tail += [i0, torch.ones_like(vd)]
        if nl:
            vd = xn[:, ln[:, 0]] - xn[:, ln[:, 1]]
            if phys:  # the branch unknown is the current: x_b = -I
                i = -xn[:, lb]
                new += [i, i, vd, rows(st, "l_v0", nl), vd * dte_c]
                tail.append(torch.ones_like(vd))
            else:
                new += [vd * 1e-9 / lval,
                        rows(st, "l_i1", nl) + vd * dte_c / lval,
                        vd, rows(st, "l_v0", nl), vd * dte_c]
        if phys and nonlin:
            tail += devs.commit(xn, dte_c, st, trap)
        if phys and nlm:  # the live J-A commit (engine/state.py)
            vd = xn[:, lm_tab[:, 0]] - xn[:, lm_tab[:, 1]]
            i_new = -xn[:, lm_tab[:, 2]]
            ti = lmp["turns"] * i_new
            mmf = torch.zeros_like(ti)
            for j in range(nlm):  # segment_sum by core, in winding order
                mmf = mmf + torch.where(same_core[:, j], ti[:, j:j + 1], 0.0)
            h = torch.clamp(mmf / lmp["len"], -1e6, 1e6)
            core = magnetic.CoreState(*(rows(st, f"lm_{key}", nlm)
                                        for key in CORE_KEYS))
            _, _, core = magnetic.ja_step(lmp, lmp["mst"], core, h)
            tail += [i_new, rows(st, "lm_i0", nlm), vd,
                     rows(st, "lm_v0", nlm),
                     rows(st, "lm_flux0", nlm) + vd * dte_c, *core]
        new += tail
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
        out = (st, t, dt, done, fail, acc, att, nri, jv, k, x, jvs)
        if store is None:
            return out
        # tran.go:141-143: the row lands at the lane's n_kept, a row that
        # is not kept in the trash row past every lane's block
        want = acc_act & (next_t >= store.tstart)
        keep = want & (n_kept < store.max_store)
        slot = torch.where(keep, lane_row + n_kept, trash)
        wave_x.index_copy_(0, slot, xn)
        wave_t.index_copy_(0, slot, next_t)
        return out + (n_kept + keep.to(I32), dropped | (want & ~keep))

    # the loop carry lives in fixed buffers; a chunk of steps reads them
    # and writes its result back, so on the card it can be replayed as one
    # captured CUDA graph (the same operations without the host's per-op
    # launch cost)
    carry = (state.clone(),
             start.t.clone(),
             start.dt.clone(),
             (start.t >= sc.tstop) | (sc.tstop <= 0.0),
             torch.zeros(b, dtype=torch.bool, device=device),
             torch.zeros(b, dtype=I32, device=device),
             start.attempts.clone(),
             torch.zeros(b, dtype=I32, device=device),
             jv.clone(),
             torch.zeros(b, dtype=I32, device=device),
             torch.zeros((b, n), dtype=F64, device=device),
             jv.clone())
    if store is not None:
        m = int(store.max_store)
        # (b·m + 1) rows, the last one the trash row
        wave_x = torch.zeros((b * m + 1, n), dtype=F64, device=device)
        wave_t = torch.zeros(b * m + 1, dtype=F64, device=device)
        lane_row = torch.arange(b, device=device) * m
        trash = torch.full((b,), b * m, dtype=torch.long, device=device)
        carry += (torch.zeros(b, dtype=I32, device=device),
                  torch.zeros(b, dtype=torch.bool, device=device))
    every = CHECK_EVERY_NL if nonlin else CHECK_EVERY

    def chunk():
        c = carry
        for _ in range(every):
            c = step(c)
        for buf, val in zip(carry, c):
            buf.copy_(val)

    def pending():
        done, att = carry[3], carry[6]
        live = ~done & (att < sc.max_attempts)
        if store is not None and store.stream:
            live = live & (carry[12] < store.max_store)
        return bool(live.any())

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
    res = RunResult(st, t, dt, acc, att, fail.to(I32), jv, nri)
    if store is None:
        return res, None
    return res, Waveforms(wave_x[:b * m].view(b, m, n),
                          wave_t[:b * m].view(b, m), carry[12], carry[13])


# ------------------------------------------------------------ dispatch


def run_lanes(plan, dev, src, state, sc: RunScalars, jv=None) -> RunResult:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if dev.is_cuda:
        return launch_run_kernel(plan, dev, src, state, sc, jv)
    if dev.device.type == "cpu":
        return run_plain(plan, dev, src, state, sc, jv)
    raise ValueError(f"no whole-run transient for device {dev.device}")


def store_lanes(plan, dev, src, state, sc: RunScalars, store: Store,
                jv=None, start: RunStart = None):
    """The store instantiation for CUDA tensors, its plain version for CPU
    tensors: (RunResult, Waveforms)."""
    if dev.is_cuda:
        return launch_store_kernel(plan, dev, src, state, sc, store, jv,
                                   start)
    if dev.device.type == "cpu":
        return store_plain(plan, dev, src, state, sc, store, jv, start)
    raise ValueError(f"no whole-run transient for device {dev.device}")


def lane_vector(v, b, default, dtype, device):
    """A per-lane start value: None (``default``), a scalar, or (b,)."""
    v = default if v is None else v
    v = torch.as_tensor(v, dtype=dtype, device=device)
    if v.ndim == 0:
        return v.expand(b).clone()
    if v.shape != (b,):
        raise ValueError(f"a per-lane start value must be ({b},), got "
                         f"{tuple(v.shape)}")
    return v.contiguous()


class RunInputs(NamedTuple):
    """The run kernel's inputs for one batch, as ``make_tran_run`` gives
    them to it."""

    plan: object
    dev: torch.Tensor  # (B, rows) f64 device constants
    src: torch.Tensor  # (B, rows) f64 source parameters
    st: torch.Tensor  # (B, ks) f64 committed state at the start
    sc: RunScalars
    jv: object  # (B, kj) f64 junction voltages, or None (linear)
    state0: dict  # the committed state the run starts from
    op: object  # the OP's result, or None (UIC, linear compat, resume)


def make_run_inputs(cc, cfg, opts=DEFAULTS, semantics: str = "compat",
                    resume: bool = False, plain: bool = False, op_fn=None):
    """fn(params, state0, jv0=None, b=None) -> RunInputs, the inputs of
    ``make_tran_run``'s kernel launch.  Unless ``cfg.uic`` or ``resume``, a
    nonlinear deck first takes its operating point through the OP kernel
    (``ops/op.make_op_fused``, rescue ladders included), and a linear
    physics deck through the linear OP (``engine/op.make_op``): its
    junction voltages warm-start the transient; ``op_fn`` replaces that
    OP (``engine/overrides.tran_op``), and ``plain`` runs the OP kernel's
    plain version on any device.  Compat keeps the given
    committed state (tran.go:57-75); physics seeds it from the bias point
    (``engine/state.make_op_seed``).  ``jv0`` is a resumed run's
    checkpointed junction voltages; ``b`` the batch, when the start values
    set it.  The function's ``.plan``, ``.sc`` and ``.op`` (the OP
    function, or None) are fixed when it is made."""
    physics = semantics == "physics"
    plan = make_plan(cc, physics=physics)
    sc = RunScalars(float(cfg.tstop), float(cfg.minstep), float(cfg.tmax),
                    float(opts.trtol), int(cfg.max_attempts),
                    float(opts.reltol), float(opts.abstol),
                    int(opts.max_iter),
                    physics and opts.integration == "trap")
    need_op = (plan.nonlinear or physics) and not cfg.uic and not resume
    op_seed = None
    if not need_op:
        op_fn = None
    elif op_fn is None and plan.nonlinear:
        from .op import make_op_fused, op_lanes, op_plain

        op_fn = make_op_fused(cc, opts, semantics=semantics,
                              solve=op_plain if plain else op_lanes)
    elif op_fn is None:
        from ..engine.op import make_op

        op_fn = make_op(cc, opts, semantics)
    if need_op and physics:
        op_seed = make_op_seed(cc, opts.temp)

    def inputs(params, state0, jv0=None, b=None) -> RunInputs:
        device = first_leaf(params).device
        if b is None:
            b = infer_batch(params, state0)
        opr = op_fn(params, state0) if need_op else None
        if op_seed is not None:  # start the physics run at the bias point
            state0 = op_seed(params, state0, opr.x)
        jv = None
        if plan.nonlinear:  # the checkpoint's junctions (resume), the
            # OP's (a warm start), or 0 (UIC)
            jv = jv_stack(plan, jv0 if resume else
                          opr.jv if need_op else init_jv(cc, device), b)
        return RunInputs(plan,
                         const_stack(plan, params, b, device, opts.temp,
                                     state0),
                         source_stack(plan, params, b, device),
                         init_state_stack(plan, state0, b, device),
                         sc, jv, state0, opr)

    inputs.plan, inputs.sc, inputs.op = plan, sc, op_fn
    return inputs


def run_inputs(cc, cfg, params, state0, opts=DEFAULTS,
               semantics: str = "compat") -> RunInputs:
    """One fresh run's kernel inputs (``make_run_inputs``)."""
    return make_run_inputs(cc, cfg, opts, semantics)(params, state0)


def make_tran_run(cc, cfg, opts=DEFAULTS, semantics: str = "compat",
                  store: str = "none", resume: bool = False,
                  stream: bool = False, via_store: bool = False,
                  plain: bool = False, op_fn=None):
    """Batched whole-run transient: fn(params, state0) -> TranOutput.

    ``params``/``state0`` are dicts of f64 tensors on one device (shared
    leaves (nk,), batched leaves (B, nk)); the run happens there, from the
    inputs of ``make_run_inputs`` (the OP first, unless UIC, on a
    nonlinear or a physics deck).  ``semantics="physics"`` runs the
    physics instantiation of the kernel, with ``opts.integration`` "be" or
    "trap" (trap takes the sources at the end of each step).

    ``store='full'`` runs the store instantiation and returns every
    accepted step at t >= tstart in ``out_x`` (B, max_store, np1) and
    ``out_t`` (B, max_store) (``make_tran_fused`` of the JAX package);
    ``stream=True`` pauses a lane whose ``cfg.max_store`` rows are full.
    ``resume=True`` continues a checkpointed run: fn(params, state0, t0,
    jv0, dt0=None, attempts0=None) skips the OP, starts each lane at t0
    (scalar or (B,); t is absolute, so sources keep their phase) with the
    checkpoint's junction voltages jv0, dt0 (default minstep) and
    attempts0 (default 0; ``cfg.max_attempts`` then binds the whole run);
    ``accepted`` and ``nr_iters`` count this call's work.  ``via_store``
    runs a ``store='none'`` run through the store instantiation keeping no
    row (the JAX package's attempt-loop engine under
    ``TOYSPICE_TRAN_RUN=off``).  ``plain`` runs the kernels' plain
    versions on any device and ``op_fn`` replaces the OP
    (``make_run_inputs``); ``engine/batch.select_tran_engine`` sets them
    from the engine overrides."""
    why = run_ineligible_reason(cc, semantics, store, opts)
    if why is not None:
        raise NotImplementedError(
            f"circuit not eligible for the whole-run kernel: {why}")
    if stream and store != "full":
        raise ValueError("stream=True pauses lanes on a full waveform "
                         "buffer and therefore requires store='full'")
    inputs = make_run_inputs(cc, cfg, opts, semantics, resume, plain, op_fn)
    run_fn, store_fn = ((run_plain, store_plain) if plain else
                        (run_lanes, store_lanes))
    plan, sc = inputs.plan, inputs.sc
    keep = (Store(float(cfg.tstart), int(cfg.max_store), stream)
            if store == "full" else None)

    def tran_run(params, state0, t0=None, jv0=None, dt0=None,
                 attempts0=None) -> TranOutput:
        if not resume and not all(v is None for v in (t0, jv0, dt0,
                                                     attempts0)):
            raise ValueError("t0, jv0, dt0 and attempts0 continue a run: "
                             "build it with resume=True")
        if resume and t0 is None:
            raise ValueError("resume=True requires the checkpoint time t0")
        if resume and plan.nonlinear and not jv0:
            raise ValueError("resume=True requires the checkpointed jv0 "
                             "for a nonlinear deck")
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        for v in (t0, dt0, attempts0):
            if v is not None and torch.as_tensor(v).ndim == 1:
                b = max(b, len(v))
        r = inputs(params, state0, jv0, b)
        start = RunStart(lane_vector(t0, b, 0.0, F64, device),
                         lane_vector(dt0, b, sc.minstep, F64, device),
                         lane_vector(attempts0, b, 0, I32, device))
        if keep is not None:
            res, wave = store_fn(plan, r.dev, r.src, r.st, sc, keep,
                                    r.jv, start)
        else:
            if resume or via_store:
                res, _ = store_fn(plan, r.dev, r.src, r.st, sc,
                                     NO_STORE, r.jv, start)
            else:
                res = run_fn(plan, r.dev, r.src, r.st, sc, r.jv)
            wave = Waveforms(
                torch.zeros((b, 1, cc.np1), dtype=F64, device=device),
                torch.zeros((b, 1), dtype=F64, device=device),
                torch.zeros(b, dtype=I32, device=device),
                torch.zeros(b, dtype=torch.bool, device=device))
        state = unpack_state(plan, res.state, r.state0, res.accepted, b)
        return TranOutput(
            out_x=wave.out_x,
            out_t=wave.out_t,
            out_n=wave.out_n,
            fail=res.fail > 0,
            accepted=res.accepted,
            attempts=res.attempts,
            nr_iters=res.nr_iters,
            t_final=res.t,
            state=state,
            jv=jv_tree(plan, res.jv) if plan.nonlinear else {},
            store_overflow=wave.overflow,
            dt_final=res.dt,
        )

    tran_run.op = inputs.op
    return tran_run
