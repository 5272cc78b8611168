"""Monte-Carlo batching of the transient (engine/batch.py of the JAX
package: ``batch_params``, ``make_tran_batch``, ``select_tran_engine``).

Parameters are a dict of f64 tensors on one device: leaves a batch
overrides carry a leading batch axis (B, nk), the rest stay shared (nk,).
The port has one transient engine so far, the whole-run kernel
(``ops/run.py``); a deck, store or semantics it does not cover raises
``NotImplementedError`` with the reason.
"""

import logging
from typing import Dict, Tuple

import numpy as np
import torch

from .options import DEFAULTS, SimOptions
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
