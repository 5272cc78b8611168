"""Monte-Carlo batching of the transient, the operating point, the DC
sweep and AC (engine/batch.py of the JAX package: ``batch_params``,
``make_tran_batch``, ``select_tran_engine``, ``run_transient_batch``,
``make_tran_stream``, ``stream_transient_chunks``,
``run_transient_streamed``, ``select_op_engine``, ``run_op_batch``,
``run_dc_batch``, ``run_ac_batch``).

Parameters are a dict of f64 tensors on one device: leaves a batch
overrides carry a leading batch axis (B, nk), the rest stay shared (nk,).
The port's engines: the whole-run kernel for the transient, its store
instantiation for waveforms (``store='full'``, the streamed store) and
for a resumed run (``ops/run.py``); for the OP, the OP kernel with its
rescue ladders (``ops/op.py``) on a nonlinear deck and the stamped solve
under the same ladders (``engine/op.make_op``) on a linear one; for the DC
sweep, the DC sweep kernel (``ops/dc.py``) or the stamped solve of every
point (``engine/dc.make_dc``); for AC, that OP and the AC kernel
(``engine/ac.py``).  A deck past the kernels' caps (np1 > 32, more than 32
sources, more than 16 diodes, BJTs and MOSFETs) takes the general engine,
engine "general", as the JAX package does: ``engine/tran.make_tran``,
``engine/op.make_op``, ``engine/dc.make_dc`` and ``engine/ac.make_ac``,
whose Newton is a host loop over the stamped solve (any np1: past NBIG =
168 its systems are eliminated in device memory).
A deck, store or semantics none of them covers raises
``NotImplementedError`` with the reason.

The JAX package's engine overrides choose among them with the same values:
``TOYSPICE_TRAN=general|fused|auto`` and ``TOYSPICE_TRAN_RUN=off``
(``select_tran_engine``; the JAX package's "fused" engine is the port's
"store"), ``TOYSPICE_OP=general|fused|auto`` (``select_op_engine``,
``engine/ac.make_ac_batch`` and the run kernel's warm-up),
``TOYSPICE_AC=general|fused|auto`` (``make_ac_batch``), and
``TOYSPICE_SOLVER=xla``, under which a batch takes the general engine
unless an override forces a kernel; ``TOYSPICE_SOLVER`` and
``TOYSPICE_TRAN_IMPL=xla`` choose the kernels or their plain versions for
the engine built (``engine/overrides.py`` reads them all).
"""

import logging
import warnings
from typing import Dict, Tuple

import numpy as np
import torch

from . import overrides
from .options import DEFAULTS, SimOptions
from .state import init_state
from .tran import TranConfig

_log = logging.getLogger("toyspice_tpu_torch.engine")


def batch_params(cc, overrides: Dict[str, Dict[str, object]],
                 device="cuda") -> Tuple[dict, dict]:
    """(params, in_axes) from per-kind overrides with a leading batch axis,
    e.g. {"R": {"value": (B, nR) array}}; the other leaves are shared
    (axis None)."""

    def f64(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=device, dtype=torch.float64)
        return torch.as_tensor(np.asarray(v, dtype=np.float64), device=device)

    params = {kind: {k: f64(v) for k, v in tbl.items()}
              for kind, tbl in cc.params.items()}
    axes = {kind: {k: None for k in tbl} for kind, tbl in cc.params.items()}
    for kind, tbl in overrides.items():
        for key, arr in tbl.items():
            params[kind][key] = f64(arr)
            axes[kind][key] = 0
    return params, axes


def general_ineligible_reason(cc, semantics: str = "compat"):
    """Why the general engine can NOT run this deck; None when it can: the
    port's semantics and device kinds (any np1).  The integration is not
    asked: the OP, DC sweep and AC take compat under trap as BE, and a
    transient's refusal of it comes first (``select_tran_engine``)."""
    from ..ops.run_plan import SLICE_KINDS, semantics_reason

    why = semantics_reason(semantics)
    if why is not None:
        return why
    extra = set(cc.idx.keys()) - set(SLICE_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (the port "
                "runs R, C, L, LM, K, V, I, D, Q and M)")
    return None


def select_tran_engine(cc, cfg: TranConfig, in_axes,
                       semantics: str = "compat", store: str = "none",
                       opts: SimOptions = DEFAULTS, resume: bool = False):
    """(engine_name, reason, fn) for a batched transient: "run", the
    whole-run kernel, for a fresh ``store='none'`` run; "store", its store
    instantiation (the JAX package's "fused" engine), for ``store='full'``,
    for ``resume=True``, whose fn(params, state0, t0, jv0, dt0=None,
    attempts0=None) continues a checkpointed run
    (``ops/run.make_tran_run``), and under ``TOYSPICE_TRAN_RUN=off``;
    "general", ``engine/tran.make_tran``, for a deck past the kernels' caps
    (resumed: fn(params, state0, t0, jv0, dt0=None)), with the kernels'
    reason, under ``TOYSPICE_TRAN=general``, and under
    ``TOYSPICE_SOLVER=xla`` unless ``TOYSPICE_TRAN=fused``, as the JAX
    package decides (engine/batch.py:96-112); the engine takes the solves
    and kernels the overrides choose, and its reason names them
    (``engine/overrides.py``).  Anything none of them
    serves raises NotImplementedError with the reason.  ``in_axes`` keeps
    the JAX package's call shape (bench.py passes ``batch_params``' axes);
    the port reads the batch axis from the tensors themselves."""
    from ..ops.run import make_tran_run, run_ineligible_reason
    from ..ops.run_plan import fused_ineligible_reason
    from .tran import make_tran

    why = overrides.general_reason(
        "TRAN", run_ineligible_reason(cc, semantics, store, opts))
    if why is not None:
        why_not = (fused_ineligible_reason(cc, semantics, store, opts)
                   or general_ineligible_reason(cc, semantics))
        if why_not is not None:
            raise NotImplementedError(
                f"no transient engine for this run in the port: {why_not}")
        return ("general", why + overrides.note(False),
                make_tran(cc, cfg, semantics, store, opts, resume=resume,
                          **overrides.solves()))
    run_off = overrides.tran_run_off()
    op_fn = overrides.tran_op(cc, opts, semantics)
    fn = make_tran_run(cc, cfg, opts, semantics=semantics, store=store,
                       resume=resume, via_store=run_off,
                       plain=overrides.kernels_plain(), op_fn=op_fn)
    note = overrides.note(True) + (
        "; the general OP warms it up" if op_fn is not None else "")
    if store == "full" or resume or run_off:
        how = (", resumed from each lane's t0" if resume else
               "" if store == "full" else ", TOYSPICE_TRAN_RUN=off")
        return "store", ("the whole-run kernel's store instantiation "
                         f"({semantics}/{opts.integration}, store={store!r}"
                         f"{how}){note}"), fn
    return "run", (f"whole-run kernel eligible ({semantics}/"
                   f"{opts.integration}){note}"), fn


def make_tran_batch(cc, cfg: TranConfig, in_axes,
                    semantics: str = "compat", store: str = "none",
                    opts: SimOptions = DEFAULTS, resume: bool = False):
    """The batched transient callable fn(params, state0) -> TranOutput
    (with ``resume=True``: fn(params, state0, t0, jv0, dt0=None,
    attempts0=None)), with ``.engine`` and ``.engine_reason`` set.  It runs
    on the device its parameters lie on; ``in_axes`` is as in
    ``select_tran_engine``.  Build it once and call it many times."""
    engine, reason, fn = select_tran_engine(
        cc, cfg, in_axes, semantics=semantics, store=store, opts=opts,
        resume=resume)
    _log.info("transient engine: %s (%s)", engine, reason)
    fn.engine = engine
    fn.engine_reason = reason
    return fn


def run_transient_batch(cc, cfg: TranConfig, params, in_axes, state0,
                        semantics: str = "compat", store: str = "none",
                        opts: SimOptions = DEFAULTS):
    """One-shot batched transient (builds the callable and calls it).  With
    ``store='full'`` a lane that dropped a kept row past ``cfg.max_store``
    sets ``TranOutput.store_overflow``; this runner checks the flags on the
    host and warns (``build_config`` sizes max_store so that it does not
    happen)."""
    fn = make_tran_batch(cc, cfg, in_axes, semantics=semantics, store=store,
                         opts=opts)
    out = fn(params, state0)
    if store == "full":
        n_over = int(out.store_overflow.sum())
        if n_over:
            warnings.warn(
                f"the waveform store overflowed on {n_over} instance(s): "
                "kept rows past max_store were dropped (check "
                "TranOutput.store_overflow per lane)", RuntimeWarning,
                stacklevel=2)
    return out


def make_tran_stream(cc, cfg: TranConfig, chunk_store: int,
                     semantics: str = "compat", opts: SimOptions = DEFAULTS):
    """The (fresh, cont) pair of the streamed store: store='full' with a
    ``chunk_store``-row buffer whose lanes pause when it is full; ``cont``
    is the resume flavour.  Build once and pass to
    ``stream_transient_chunks`` via ``fns`` when draining repeatedly."""
    from ..ops.run import make_tran_run, run_ineligible_reason

    why = run_ineligible_reason(cc, semantics, "full", opts)
    if why is not None:
        raise ValueError(f"the streamed store needs the store engine: {why}")
    if int(chunk_store) < 1:
        raise ValueError("chunk_store must be at least 1 row")
    cfg_c = cfg._replace(max_store=int(chunk_store))
    plain = overrides.kernels_plain()
    fresh = make_tran_run(cc, cfg_c, opts, semantics=semantics,
                          store="full", stream=True, plain=plain,
                          op_fn=overrides.tran_op(cc, opts, semantics))
    cont = make_tran_run(cc, cfg_c, opts, semantics=semantics,
                         store="full", stream=True, resume=True,
                         plain=plain)
    return fresh, cont


def stream_transient_chunks(cc, cfg: TranConfig, params, state0,
                            chunk_store: int, semantics: str = "compat",
                            opts: SimOptions = DEFAULTS, fns=None):
    """Generator: the full-waveform transient in chunks of at most
    ``chunk_store`` rows per lane, each yielded as a ``TranOutput`` on the
    device.

    Lanes pause (they do not fail, and nothing is truncated) when their
    buffer fills; the next chunk re-enters the same callables at each
    lane's (t_final, dt_final, state, jv, attempts).  Because the adaptive
    dt is carried exactly, the chunks concatenated reproduce the
    monolithic store='full' run step for step.  ``cfg.max_attempts`` binds
    the cumulative per-lane budget (each chunk's ``attempts`` is
    cumulative, ``accepted`` and ``nr_iters`` are the chunk's); a lane
    that is done, failed or out of budget is parked at tstop, where it
    does not move.  Which lanes go on is decided with one reduction on the
    device and one host sync per chunk."""
    fresh, cont = fns if fns is not None else make_tran_stream(
        cc, cfg, chunk_store, semantics, opts)
    out = fresh(params, state0)
    yield out
    parked = out.fail
    while True:
        parked = parked | out.fail | (out.attempts >= cfg.max_attempts)
        go_on = ~parked & (out.t_final < cfg.tstop)
        if not bool(go_on.any()):
            return
        t_next = torch.where(go_on, out.t_final,
                             torch.full_like(out.t_final, cfg.tstop))
        out = cont(params, out.state, t_next, out.jv, out.dt_final,
                   out.attempts)
        yield out


def run_transient_streamed(cc, cfg: TranConfig, params, state0,
                           chunk_store: int, semantics: str = "compat",
                           opts: SimOptions = DEFAULTS):
    """The streamed full-waveform transient stitched on the host into the
    monolithic layout: ``out_x`` (B, N, np1), ``out_t`` (B, N) and
    ``out_n`` (B,) are CPU tensors (N the most rows of any lane); the rest
    stay on the device.  ``accepted`` and ``nr_iters`` add up over the
    chunks, ``attempts`` is the last chunk's (already cumulative), ``fail``
    and ``store_overflow`` latch."""
    xs, ts_, ns = [], [], []
    accepted = nr_iters = fail = overflow = last = None
    for out in stream_transient_chunks(cc, cfg, params, state0, chunk_store,
                                       semantics, opts):
        kmax = int(out.out_n.max())
        xs.append(out.out_x[:, :kmax].cpu())
        ts_.append(out.out_t[:, :kmax].cpu())
        ns.append(out.out_n.cpu().long())
        if last is None:
            accepted, nr_iters = out.accepted, out.nr_iters
            fail, overflow = out.fail, out.store_overflow
        else:
            accepted = accepted + out.accepted
            nr_iters = nr_iters + out.nr_iters
            fail = fail | out.fail
            overflow = overflow | out.store_overflow
        last = out
    total = torch.stack(ns).sum(dim=0)
    b, np1 = last.out_x.shape[0], last.out_x.shape[2]
    n_max = int(total.max())
    out_x = torch.zeros((b, n_max, np1), dtype=torch.float64)
    out_t = torch.zeros((b, n_max), dtype=torch.float64)
    # one masked copy per chunk: row j of a lane's chunk goes to the
    # lane's offset + j
    offs = torch.zeros(b, dtype=torch.long)
    for cx, ct, cn in zip(xs, ts_, ns):
        j = torch.arange(cx.shape[1])[None, :]
        valid = j < cn[:, None]
        lane = torch.arange(b)[:, None].expand_as(valid)[valid]
        dest = (offs[:, None] + j)[valid]
        out_x[lane, dest] = cx[valid]
        out_t[lane, dest] = ct[valid]
        offs += cn
    return last._replace(out_x=out_x, out_t=out_t,
                         out_n=total.to(torch.int32), fail=fail,
                         accepted=accepted, nr_iters=nr_iters,
                         store_overflow=overflow)


def linear_op_ineligible_reason(cc, semantics: str = "compat"):
    """Why this deck can NOT use the linear OP (the stamped solve under
    the rescue ladders); None when it can.  Its OP stamps do not depend
    on the semantics or the integration (assemble.py reads them only in
    transient stamps and for the diode)."""
    from ..ops.assemble import LINEAR_KINDS
    from ..ops.run_plan import nonlinear, semantics_reason

    why = semantics_reason(semantics)
    if why is not None:
        return why
    if nonlinear(cc):
        return "nonlinear circuit (the OP kernel serves it)"
    extra = set(cc.idx.keys()) - set(LINEAR_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (a linear OP "
                "runs R, C, L, LM, K, V and I)")
    return None


def select_op_engine(cc, semantics: str = "compat",
                     opts: SimOptions = DEFAULTS):
    """(engine_name, reason) for a batched OP or DC sweep: "fused", the
    OP kernel (the DC sweep kernel) on a nonlinear deck, "general", the
    general engine's Newton over the stamped solve, on a nonlinear deck
    past the kernels' caps (with their reason), or "linear", the stamped
    solve, on a linear one (the general engine's OP on a linear deck, which
    the JAX package names "general"); anything none serves (a kind not
    ported, a semantics other than compat and physics) raises
    NotImplementedError with the reason.  ``TOYSPICE_OP=general`` takes
    the general engine on any deck, and ``TOYSPICE_SOLVER=xla`` on a
    nonlinear one unless ``TOYSPICE_OP=fused`` (engine/batch.py:302-329 of
    the JAX package); the reason names the solves and kernels the
    overrides choose (``make_op_engine`` builds it with them)."""
    from ..ops.run import kernel_caps_reason
    from ..ops.run_plan import make_plan, nonlinear

    if nonlinear(cc):
        # the OP kernel's gates are the general engine's plus its caps
        why = general_ineligible_reason(cc, semantics)
        caps = None if why else kernel_caps_reason(make_plan(cc, "op"))
        general = overrides.general_reason("OP", caps)
        engine, reason = (("general", general) if general else
                          ("fused", f"OP kernel eligible ({semantics})"))
    else:
        why = linear_op_ineligible_reason(cc, semantics)
        engine, reason = "linear", ("linear circuit: one stamped solve per "
                                    f"rung ({semantics})")
        if overrides.mode("OP") == "general":
            engine, reason = "general", "TOYSPICE_OP=general override"
    if why is not None:
        raise NotImplementedError(
            f"no OP engine for this deck in the port: {why}")
    return engine, reason + overrides.note(engine == "fused")


def make_op_engine(cc, opts: SimOptions = DEFAULTS,
                   semantics: str = "compat"):
    """(engine, reason, fn) of the batched OP as ``select_op_engine``
    picks it, built with the solves and kernels the overrides choose:
    fn(params, state0) is the OP kernel's ``make_op_fused`` or the general
    engine's ``make_op``."""
    from ..ops.op import make_op_fused, op_lanes, op_plain
    from .op import make_op

    engine, reason = select_op_engine(cc, semantics, opts)
    if engine == "fused":
        fn = make_op_fused(cc, opts, semantics=semantics, solve=(
            op_plain if overrides.kernels_plain() else op_lanes))
    else:
        fn = make_op(cc, opts, semantics, **overrides.solves())
    return engine, reason, fn


def run_op_batch(cc, params, in_axes=None, opts: SimOptions = DEFAULTS,
                 semantics: str = "compat"):
    """Batched operating point: each lane runs plain NR and the rescue
    ladders on its own parameters.  Returns the FusedOPResult (x (B, np1),
    jv, converged (B,), stage (B,), iters) of the OP kernel on a nonlinear
    deck, the OPResult (x, jv, converged, stage) of the general OP on a
    nonlinear deck past the kernels' caps and of the linear OP (jv {}) on a
    linear one, on the device the parameters lie on; ``in_axes`` keeps the
    JAX package's call shape (the port reads the batch axis from the
    tensors themselves)."""
    from ..ops.run_plan import first_leaf

    engine, reason, fn = make_op_engine(cc, opts, semantics)
    _log.info("op engine: %s (%s)", engine, reason)
    return fn(params, init_state(cc, device=first_leaf(params).device))


def make_dc_engine(cc, src_slots, opts: SimOptions = DEFAULTS,
                   semantics: str = "compat"):
    """(engine, reason, fn) of the batched DC sweep as ``select_op_engine``
    picks it, built with the solves and kernels the overrides choose:
    fn(params, state0, points) -> (xs, conv) through the DC sweep kernel's
    ``make_dc_fused`` or the general engine's (or the linear) ``make_dc``."""
    from ..ops.dc import dc_lanes, dc_plain, make_dc_fused
    from .dc import make_dc

    engine, reason = select_op_engine(cc, semantics, opts)
    if engine != "fused":
        return engine, reason, make_dc(cc, src_slots, opts, semantics,
                                       solve=overrides.solves().get("solve"))
    fused = make_dc_fused(cc, src_slots, opts, semantics, solve=(
        dc_plain if overrides.kernels_plain() else dc_lanes))

    def fn(params, state0, points):
        r = fused(params, state0, points)
        return r.xs, r.conv

    return engine, reason, fn


def run_dc_batch(cc, src_slots, params, in_axes=None, points=None,
                 opts: SimOptions = DEFAULTS, semantics: str = "compat"):
    """Batched DC sweep.  Returns (xs (B, P, np1), conv (B, P)): a
    nonlinear deck through the DC sweep kernel (every point of every lane
    in one launch, junction voltages carried point to point,
    dc.go:142-187), a nonlinear deck past the kernels' caps through the
    general engine's sweep (one host loop over the points), a linear one
    through one stamped solve of all B·P systems (``make_dc_engine``).
    ``points`` is (P,) or (P, 2) for a nested sweep; ``in_axes`` keeps the
    JAX package's call shape."""
    from ..ops.run_plan import first_leaf

    engine, reason, fn = make_dc_engine(cc, src_slots, opts, semantics)
    _log.info("dc engine: %s (%s)", engine, reason)
    return fn(params, init_state(cc, device=first_leaf(params).device),
              points)


def run_ac_batch(cc, params, in_axes=None, freqs=None,
                 opts: SimOptions = DEFAULTS, semantics: str = "compat"):
    """Batched AC: each lane's bias point, then every frequency.  Returns
    (xr, xi, opr) with xr, xi (B, F, np1) and the bias's OP result;
    ``in_axes`` keeps the JAX package's call shape."""
    from ..ops.run_plan import first_leaf
    from .ac import make_ac_batch

    fn = make_ac_batch(cc, in_axes, opts, semantics=semantics)
    return fn(params, init_state(cc, device=first_leaf(params).device),
              freqs)
