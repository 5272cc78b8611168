"""Monte-Carlo batching of the transient and the operating point
(engine/batch.py of the JAX package: ``batch_params``, ``make_tran_batch``,
``select_tran_engine``, ``select_op_engine``, ``run_op_batch``).

Parameters are a dict of f64 tensors on one device: leaves a batch
overrides carry a leading batch axis (B, nk), the rest stay shared (nk,).
The port has one transient engine, the whole-run kernel (``ops/run.py``),
and one OP engine, the OP kernel with its rescue ladders (``ops/op.py``);
a deck, store or semantics they do not cover raises
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


def select_op_engine(cc, semantics: str = "compat",
                     opts: SimOptions = DEFAULTS):
    """(engine_name, reason) for a batched OP.  The only engine is "fused",
    the OP kernel; anything it does not serve (a linear deck, physics
    semantics, a kind not ported) raises NotImplementedError with the
    reason."""
    from ..ops.op import op_fused_ineligible_reason

    why = op_fused_ineligible_reason(cc, semantics, opts)
    if why is not None:
        raise NotImplementedError(
            f"no OP engine for this deck in the port: {why}")
    return "fused", f"OP kernel eligible ({semantics})"


def run_op_batch(cc, params, in_axes=None, opts: SimOptions = DEFAULTS,
                 semantics: str = "compat"):
    """Batched operating point: each lane runs plain NR and the rescue
    ladders on its own parameters.  Returns the FusedOPResult (x (B, np1),
    jv, converged (B,), stage (B,), iters) on the device the parameters lie
    on; ``in_axes`` keeps the JAX package's call shape (the port reads the
    batch axis from the tensors themselves)."""
    from ..ops.op import make_op_fused
    from ..ops.run_plan import first_leaf

    engine, reason = select_op_engine(cc, semantics, opts)
    _log.info("op engine: %s (%s)", engine, reason)
    fn = make_op_fused(cc, opts, semantics=semantics)
    return fn(params, init_state(cc, device=first_leaf(params).device))
