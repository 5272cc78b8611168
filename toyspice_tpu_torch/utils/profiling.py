"""Tracing / profiling hooks (SURVEY.md §5: absent in the reference, which
has only leftover fmt.Println debug spam in hot paths — bjt.go:119, op.go:98).

The port's counterpart of the JAX package's utils/profiling.py:

* ``trace(label)`` — context manager stacking a wall-clock timer with a
  ``torch.profiler.record_function`` range, so the region is visible both
  in the in-process report and in a profiler trace.  A region that ran on
  the card is timed to its end: the clock stops after a
  ``torch.cuda.synchronize()`` when CUDA is initialised.
* ``start_trace(logdir)`` / ``stop_trace()`` — a ``torch.profiler.profile``
  of the CPU and, where there is one, the card, written as a Chrome trace
  into ``logdir``.
* ``tran_stats(out, wall_s)`` — throughput counters from a TranOutput
  (aggregate accepted steps/sec is the headline BASELINE metric).
"""

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import numpy as np
import torch

_registry: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"calls": 0, "total_s": 0.0}
)
_profile = {"prof": None, "logdir": None}


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(label: str):
    _sync()
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(label):
            yield
    finally:
        # count failed regions too — those are the runs worth profiling
        _sync()
        dt = time.perf_counter() - t0
        entry = _registry[label]
        entry["calls"] += 1
        entry["total_s"] += dt


def report(reset: bool = False) -> Dict[str, Dict[str, float]]:
    """Snapshot of {label: {calls, total_s}} accumulated by trace()."""
    out = {k: dict(v) for k, v in _registry.items()}
    if reset:
        _registry.clear()
    return out


def start_trace(logdir: str) -> None:
    """Start a profiler over the CPU and, when CUDA is available, the card;
    ``stop_trace`` writes its Chrome trace into ``logdir``."""
    if _profile["prof"] is not None:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _profile.update(prof=prof, logdir=logdir)


def stop_trace() -> str:
    """Stop the running trace; returns the path of its Chrome trace."""
    prof, logdir = _profile["prof"], _profile["logdir"]
    if prof is None:
        raise RuntimeError("no trace is running")
    _profile.update(prof=None, logdir=None)
    _sync()
    prof.__exit__(None, None, None)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


def _total(v):
    if isinstance(v, torch.Tensor):
        return int(v.sum())
    return int(np.sum(np.asarray(v)))


def tran_stats(out, wall_s: float) -> Dict[str, float]:
    """Throughput summary of a TranOutput (single instance or batch)."""
    accepted = _total(out.accepted)
    attempts = _total(out.attempts)
    nr_iters = _total(out.nr_iters)
    fails = _total(out.fail)
    return {
        "accepted_steps": accepted,
        "attempts": attempts,
        "nr_iters": nr_iters,
        "failed_instances": fails,
        "wall_s": wall_s,
        "steps_per_sec": accepted / wall_s if wall_s > 0 else float("inf"),
        "accept_ratio": accepted / attempts if attempts else 0.0,
        "nr_per_attempt": nr_iters / attempts if attempts else 0.0,
    }
