"""Transient analysis (engine/tran.py of the JAX package): the
configuration and result containers, and ``make_tran``, the general
engine's adaptive-timestep loop (tran.go:77-155) over attempts.

The step-control arithmetic of ``build_config`` is the reference's
(tran.go:29-34, 93): tstep is clamped to tstop/300, minstep = tstep/50, and
tmax defaults to tstep.  ``max_attempts`` bounds every lane's attempt loop,
so a lane can never spin forever.

Each attempt: clamp dt to tstop, Newton at the old time (trapezoidal
physics at the new one, PLAN.md 2), the LTE of the committed C/L state,
then accept (commit, store, grow dt) or reject (halve dt), or fail hard
when Newton fails at minstep.  The JAX package's vmapped
``lax.while_loop`` is a host loop over attempts here, with one host sync
per attempt: a lane that is done (at tstop, failed, or out of attempts)
keeps its carry, the junction voltages of an attempt persist across a
reject (tran.go:193), and the state moves on accepted steps only.
"""

import math
from typing import NamedTuple

import torch

from .options import DEFAULTS, SimOptions


class TranConfig(NamedTuple):
    tstart: float
    tstop: float
    tstep: float  # already clamped to tstop/300
    tmax: float
    minstep: float
    uic: bool
    max_store: int
    max_attempts: int


def build_config(tstart, tstop, tstep, tmax, uic,
                 opts: SimOptions = DEFAULTS) -> TranConfig:
    if tstep > tstop / opts.tstep_divisor:
        tstep = tstop / opts.tstep_divisor
    minstep = tstep / opts.minstep_divisor
    if tmax == 0:
        tmax = tstep
    # Accepted steps can be as small as minstep/2: halving applies only while
    # dt > minstep, so the post-halving dt is > minstep/2 (plus O(1) clamped
    # steps near tstop).
    max_store = int(math.ceil(tstop / (minstep / 2.0) - 1e-9)) + 16
    max_attempts = 6 * max_store + 256
    return TranConfig(
        tstart=tstart, tstop=tstop, tstep=tstep, tmax=tmax, minstep=minstep,
        uic=bool(uic), max_store=max_store, max_attempts=max_attempts,
    )


F64 = torch.float64
I32 = torch.int32


class TranOutput(NamedTuple):
    """Per-lane transient result; every tensor has the batch axis first."""

    out_x: torch.Tensor  # store='full': (B, max_store, np1), every kept
    #                      accepted step's solution, 0 past out_n;
    #                      store='none': (B, 1, np1) zeros
    out_t: torch.Tensor  # (B, max_store) times of those rows ((B, 1))
    out_n: torch.Tensor  # (B,) int32 rows kept (0 with store='none')
    fail: torch.Tensor  # (B,) bool: a failed solve at minstep (hard fail)
    accepted: torch.Tensor  # (B,) int32 accepted steps (of this call)
    attempts: torch.Tensor  # (B,) int32, cumulative over a resumed run
    nr_iters: torch.Tensor  # (B,) int32 Newton iterations (1 per attempt
    #                         on a linear deck)
    t_final: torch.Tensor  # (B,) committed simulation time on exit
    state: dict  # committed C/L state and the D/Q/M passthrough, (B, nk)
    jv: dict  # junction voltages on exit, (B, nk); empty for linear decks
    store_overflow: torch.Tensor = None  # (B,) bool: a kept row was
    #                                      dropped past max_store
    dt_final: torch.Tensor = None  # (B,) adaptive step size on exit (the
    #                                dt0 that continues the run exactly)


def make_tran(cc, cfg: TranConfig, semantics: str = "compat",
              store: str = "full", opts: SimOptions = DEFAULTS,
              resume: bool = False, solve=None, dense_solve=None,
              stream: bool = False):
    """The general engine's batched transient, per lane the JAX package's
    tran_execute under vmap: fn(params, state0, t0=0.0, jv0=None,
    dt0=None, attempts0=None) -> TranOutput with the batch axis first.
    ``resume=False`` runs the reference flow (the OP warm-up unless UIC,
    under physics the state seeded from the bias point, the clock from 0);
    ``resume=True`` continues a checkpoint from each lane's ``t0`` (a float
    or (B,)) with its junction voltages ``jv0`` and, if given, its step
    ``dt0`` and its attempt count ``attempts0`` (``cfg.max_attempts`` then
    binds the whole run; ``accepted`` and ``nr_iters`` count this call's
    work).  ``stream=True`` (with ``store='full'``) pauses a lane whose
    ``cfg.max_store`` rows are full: it neither attempts nor fails, and the
    caller drains its rows and re-enters (the streamed store,
    ``engine/batch.make_tran_stream``; the JAX kernel's rule,
    ops/pallas_tran.py:2342-2355).  ``solve``/``dense_solve`` override the
    stamped and the dense solve (the plain versions on the card)."""
    from ..ops.run_plan import first_leaf, infer_batch
    from .newton import make_nr, tree_where
    from .nlstate import init_jv
    from .op import lanes_of, make_op
    from .state import make_commit, make_lte, make_op_seed

    if stream and store != "full":
        raise ValueError("stream=True pauses lanes on a full waveform "
                         "buffer and therefore requires store='full'")
    if opts.integration == "trap" and semantics == "compat":
        raise ValueError("trapezoidal integration requires semantics="
                         "'physics' (compat reproduces the reference's "
                         "backward Euler)")
    np1 = cc.np1
    trtol = opts.trtol
    trap = opts.integration == "trap" and semantics == "physics"
    physics = semantics == "physics"
    kw = {} if solve is None else {"solve": solve}
    nr = make_nr(cc, "tran", warm_start=True, conv="op",
                 semantics=semantics, opts=opts, **kw)
    op_execute = make_op(cc, opts, semantics, solve=solve,
                         dense_solve=dense_solve)
    commit = make_commit(cc, semantics, opts.integration, opts.temp)
    op_seed = make_op_seed(cc, opts.temp)
    lte_fn = make_lte(cc)
    k_store = cfg.max_store if store == "full" else 1

    def tran_execute(params, state0, t0=0.0, jv0=None, dt0=None,
                     attempts0=None):
        device = first_leaf(params).device
        b = infer_batch(params, state0)
        for v in (t0, dt0, attempts0):
            if isinstance(v, torch.Tensor) and v.ndim == 1:
                b = max(b, v.shape[0])

        def lane_vec(v, default):
            v = torch.as_tensor(default if v is None else v, dtype=F64,
                                device=device)
            return v.expand(b).clone()

        if resume:
            if jv0 is None:
                raise ValueError("resume=True requires the checkpointed jv")
        elif not cfg.uic:
            opr = op_execute(params, state0)
            jv0 = opr.jv
            if physics:  # start at the bias point; compat keeps zeros
                state0 = op_seed(params, state0, opr.x)
        else:
            jv0 = init_jv(cc, device=device)
        state = lanes_of(state0, b)
        jv = lanes_of(jv0, b)
        t = lane_vec(t0, 0.0)
        dt = lane_vec(dt0, cfg.minstep)
        done = t >= cfg.tstop
        fail = torch.zeros(b, dtype=torch.bool, device=device)
        overflow = torch.zeros_like(fail)
        out_x = torch.zeros((b, k_store, np1), dtype=F64, device=device)
        out_t = torch.zeros((b, k_store), dtype=F64, device=device)
        out_n = torch.zeros(b, dtype=I32, device=device)
        accepted = torch.zeros(b, dtype=I32, device=device)
        attempts = torch.as_tensor(0 if attempts0 is None else attempts0,
                                   dtype=I32, device=device).expand(b).clone()
        nr_iters = torch.zeros(b, dtype=I32, device=device)
        zeros = torch.zeros((b, np1), dtype=F64, device=device)
        lane = torch.arange(b, device=device)
        two = torch.full((b,), 2.0, dtype=F64, device=device)
        one_one = torch.full((b,), 1.1, dtype=F64, device=device)
        while True:
            active = ~done & (attempts < cfg.max_attempts)
            if stream:  # a full buffer pauses the lane
                active = active & (out_n < k_store)
            if not bool(active.any()):
                break
            next_t = torch.clamp_max(t + dt, cfg.tstop)
            # dt is recomputed only when clamped at tstop (tran.go:97-101):
            # (t + dt) - t != dt in floating point
            dt_eff = torch.where(t + dt > cfg.tstop, cfg.tstop - t, dt)
            res = nr(params, state, jv, zeros, next_t if trap else t,
                     dt_eff, 0.0, 1.0, active)
            lte = lte_fn(params, state, dt_eff)
            can_halve = dt_eff > cfg.minstep
            nr_fail = ~res.converged
            hard_fail = nr_fail & ~can_halve & active
            reject = (nr_fail & can_halve) | (res.converged & (lte > trtol)
                                              & can_halve)
            accept = res.converged & ~reject & active
            state = tree_where(accept, commit(params, state, res.x, dt_eff),
                               state)
            t_new = torch.where(accept, next_t, t)
            grow = torch.where(lte < trtol / 100.0, two, one_one)
            dt_grown = torch.where(
                (next_t < cfg.tstop) & (dt_eff < cfg.tmax),
                torch.clamp_max(dt_eff * grow, cfg.tmax), dt_eff)
            dt = torch.where(active, torch.where(accept, dt_grown,
                                                 dt_eff / 2.0), dt)
            if store == "full":
                keep = accept & (t_new >= cfg.tstart)
                store_now = keep & (out_n < k_store)
                overflow = overflow | (keep & ~store_now)
                slot = torch.clamp_max(out_n, k_store - 1).long()
                out_x[lane, slot] = torch.where(store_now[:, None], res.x,
                                                out_x[lane, slot])
                out_t[lane, slot] = torch.where(store_now, t_new,
                                                out_t[lane, slot])
                out_n = out_n + store_now.to(I32)
            t = t_new
            done = done | (accept & (t_new >= cfg.tstop)) | hard_fail
            fail = fail | hard_fail
            jv = tree_where(active, res.jv, jv)
            accepted = accepted + accept.to(I32)
            attempts = attempts + active.to(I32)
            nr_iters = nr_iters + torch.where(active, res.iters, 0)
        return TranOutput(out_x=out_x, out_t=out_t, out_n=out_n, fail=fail,
                          accepted=accepted, attempts=attempts,
                          nr_iters=nr_iters, t_final=t, state=state, jv=jv,
                          store_overflow=overflow, dt_final=dt)

    return tran_execute
