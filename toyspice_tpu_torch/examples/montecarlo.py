"""Monte-Carlo tolerance analysis on the batch API — the capability the
single-instance reference has no analog for.

A 5% -tolerance RLC filter is solved for 4096 component corners in one
batched run (on the card, one launch of the whole-run kernel);
per-instance adaptive timestepping, Newton iteration and convergence
handling are batched automatically.  Reports the spread of the final
output voltage across the tolerance cloud and the aggregate throughput.

Runs on the card unless TOYSPICE_PLATFORM=cpu; set BATCH / SPREAD via env
to scale.
"""

import os
import time

import numpy as np
import torch

from ..compiler import compile_circuit
from ..engine.batch import batch_params, make_tran_batch
from ..engine.state import init_state
from ..engine.tran import build_config
from ..netlist.parser import parse
from ..utils.profiling import tran_stats
from ._platform import device

BATCH = int(os.environ.get("BATCH", 4096))
SPREAD = float(os.environ.get("SPREAD", 0.05))  # 5% lognormal tolerance

DECK = """Monte-Carlo RLC band-pass
.tran 0.01m 1m
Vin 1 0 SIN(0 5 2k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def _sync(dev):
    if dev == "cuda":
        torch.cuda.synchronize()


def main():
    dev = device()
    cc = compile_circuit(parse(DECK))
    tp = cc.netlist.tran
    cfg = build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)

    rng = np.random.default_rng(42)

    def corners(base):
        return base[None, :] * np.exp(
            rng.normal(0.0, SPREAD, size=(BATCH, base.shape[0]))
        )

    overrides = {
        kind: {"value": corners(np.asarray(cc.params[kind]["value"]))}
        for kind in ("R", "L", "C")
    }
    params, axes = batch_params(cc, overrides, device=dev)
    state0 = init_state(cc, device=dev)

    where = torch.cuda.get_device_name(0) if dev == "cuda" else dev
    print(f"Solving {BATCH} corners of {cc.netlist.title!r} on {where}...")
    tran = make_tran_batch(cc, cfg, axes, store="none")
    t0 = time.perf_counter()
    out = tran(params, state0)
    _ = int(out.accepted.sum())  # force materialization
    print(f"build + first run: {time.perf_counter() - t0:.1f}s "
          "(the kernel's build once per checkout; engine "
          f"{tran.engine})")

    t0 = time.perf_counter()
    out = tran(params, state0)
    _sync(dev)
    wall = time.perf_counter() - t0
    vfinal = out.state["C"]["v0"][:, 0].cpu().numpy()
    stats = tran_stats(out, wall)

    print(f"aggregate: {stats['accepted_steps']} accepted steps in "
          f"{stats['wall_s']:.2f}s -> {stats['steps_per_sec'] / 1e6:.2f}M steps/s, "
          f"accept ratio {stats['accept_ratio']:.2f}, "
          f"{stats['failed_instances']} failures")
    print(f"V(3) at t=tstop across {BATCH} corners: "
          f"mean {vfinal.mean():.4f} V, std {vfinal.std():.4f} V, "
          f"[min {vfinal.min():.4f}, max {vfinal.max():.4f}] V")
    print("Done!")


if __name__ == "__main__":
    main()
