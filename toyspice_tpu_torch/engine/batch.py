"""Monte-Carlo batching of the transient, the operating point, the DC
sweep and AC (engine/batch.py of the JAX package: ``batch_params``,
``make_tran_batch``, ``select_tran_engine``, ``select_op_engine``,
``run_op_batch``, ``run_dc_batch``, ``run_ac_batch``).

Parameters are a dict of f64 tensors on one device: leaves a batch
overrides carry a leading batch axis (B, nk), the rest stay shared (nk,).
The port's engines: the whole-run kernel for the transient
(``ops/run.py``); for the OP, the OP kernel with its rescue ladders
(``ops/op.py``) on a nonlinear deck and the stamped solve under the same
ladders (``engine/op.make_op``) on a linear one; for the DC sweep, the DC
sweep kernel (``ops/dc.py``) or the stamped solve of every point
(``engine/dc.make_dc``); for AC, that OP and the AC kernel
(``engine/ac.py``).  A deck, store or semantics they do not cover raises
``NotImplementedError`` with the reason.
"""

import logging
from typing import Dict, Tuple

import numpy as np
import torch

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


def select_tran_engine(cc, cfg: TranConfig, in_axes,
                       semantics: str = "compat", store: str = "none",
                       opts: SimOptions = DEFAULTS):
    """(engine_name, reason, fn) for a batched transient.  The only engine
    is "run", the whole-run kernel; anything it does not serve raises
    NotImplementedError with the reason.  ``in_axes`` keeps the JAX
    package's call shape (bench.py passes ``batch_params``' axes); the port
    reads the batch axis from the tensors themselves."""
    from ..ops.run import make_tran_run, run_ineligible_reason

    why = run_ineligible_reason(cc, semantics, store, opts)
    if why is not None:
        raise NotImplementedError(
            f"no transient engine for this run in the port: {why}")
    reason = f"whole-run kernel eligible ({semantics}/{opts.integration})"
    return "run", reason, make_tran_run(cc, cfg, opts, semantics=semantics)


def make_tran_batch(cc, cfg: TranConfig, in_axes,
                    semantics: str = "compat", store: str = "none",
                    opts: SimOptions = DEFAULTS):
    """The batched transient callable fn(params, state0) -> TranOutput,
    with ``.engine`` and ``.engine_reason`` set.  It runs on the device its
    parameters lie on; ``in_axes`` is as in ``select_tran_engine``."""
    engine, reason, fn = select_tran_engine(
        cc, cfg, in_axes, semantics=semantics, store=store, opts=opts)
    _log.info("transient engine: %s (%s)", engine, reason)
    fn.engine = engine
    fn.engine_reason = reason
    return fn


def linear_op_ineligible_reason(cc, semantics: str = "compat"):
    """Why this deck can NOT use the linear OP (the stamped solve under
    the rescue ladders); None when it can."""
    from ..ops.assemble import LINEAR_KINDS
    from ..ops.run import NP1_CAP
    from ..ops.run_plan import nonlinear

    if semantics != "compat":
        return (f"semantics={semantics!r} (the port runs compat semantics "
                "only)")
    if nonlinear(cc):
        return "nonlinear circuit (the OP kernel serves it)"
    extra = set(cc.idx.keys()) - set(LINEAR_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (a linear OP "
                "runs R, C, L, V and I)")
    if cc.np1 > NP1_CAP:
        return (f"np1={cc.np1} exceeds the stamped-solve kernel's matrix "
                f"cap of {NP1_CAP}")
    return None


def select_op_engine(cc, semantics: str = "compat",
                     opts: SimOptions = DEFAULTS):
    """(engine_name, reason) for a batched OP or DC sweep: "fused", the
    OP kernel (the DC sweep kernel) on a nonlinear deck, or "linear", the
    stamped solve, on a linear one; anything neither serves (physics
    semantics, a kind not ported, a deck over the kernels' caps) raises
    NotImplementedError with the reason."""
    from ..ops.op import op_fused_ineligible_reason
    from ..ops.run_plan import nonlinear

    if nonlinear(cc) or semantics != "compat":
        why = op_fused_ineligible_reason(cc, semantics, opts)
        engine, reason = "fused", f"OP kernel eligible ({semantics})"
    else:
        why = linear_op_ineligible_reason(cc, semantics)
        engine, reason = "linear", ("linear circuit: one stamped solve per "
                                    f"rung ({semantics})")
    if why is not None:
        raise NotImplementedError(
            f"no OP engine for this deck in the port: {why}")
    return engine, reason


def run_op_batch(cc, params, in_axes=None, opts: SimOptions = DEFAULTS,
                 semantics: str = "compat"):
    """Batched operating point: each lane runs plain NR and the rescue
    ladders on its own parameters.  Returns the FusedOPResult (x (B, np1),
    jv, converged (B,), stage (B,), iters) of the OP kernel on a nonlinear
    deck, the OPResult (x, jv {}, converged, stage) of the linear OP on a
    linear one, on the device the parameters lie on; ``in_axes`` keeps the
    JAX package's call shape (the port reads the batch axis from the
    tensors themselves)."""
    from ..ops.op import make_op_fused
    from ..ops.run_plan import first_leaf
    from .op import make_op

    engine, reason = select_op_engine(cc, semantics, opts)
    _log.info("op engine: %s (%s)", engine, reason)
    fn = (make_op_fused(cc, opts, semantics=semantics) if engine == "fused"
          else make_op(cc, opts, semantics))
    return fn(params, init_state(cc, device=first_leaf(params).device))


def run_dc_batch(cc, src_slots, params, in_axes=None, points=None,
                 opts: SimOptions = DEFAULTS, semantics: str = "compat"):
    """Batched DC sweep.  Returns (xs (B, P, np1), conv (B, P)): a
    nonlinear deck through the DC sweep kernel (every point of every lane
    in one launch, junction voltages carried point to point,
    dc.go:142-187), a linear one through one stamped solve of all B·P
    systems.  ``points`` is (P,) or (P, 2) for a nested sweep; ``in_axes``
    keeps the JAX package's call shape."""
    from ..ops.dc import make_dc_fused
    from ..ops.run_plan import first_leaf
    from .dc import make_dc

    engine, reason = select_op_engine(cc, semantics, opts)
    _log.info("dc engine: %s (%s)", engine, reason)
    state0 = init_state(cc, device=first_leaf(params).device)
    if engine == "fused":
        r = make_dc_fused(cc, src_slots, opts, semantics)(params, state0,
                                                           points)
        return r.xs, r.conv
    return make_dc(cc, src_slots, opts, semantics)(params, state0, points)


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
