"""Transient configuration and result containers (engine/tran.py of the JAX
package, lines 34-80, with torch tensors in the result).

The step-control arithmetic of ``build_config`` is the reference's
(tran.go:29-34, 93): tstep is clamped to tstop/300, minstep = tstep/50, and
tmax defaults to tstep.  ``max_attempts`` bounds every lane's attempt loop,
so a lane can never spin forever.
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
