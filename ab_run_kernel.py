#!/usr/bin/env python3
"""Time the whole-run kernel of ``toyspice_tpu_torch`` on bench.py's
8192-lane RLC deck for several checkouts of the port, in turns, on one
CUDA card.

    python3 ab_run_kernel.py _parent . . _parent

Each argument is a directory holding a ``toyspice_tpu_torch`` package (for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists); each runs in a process of its own, in the order
given, builds its kernel, launches it once to warm up and three times
under CUDA events, and prints its attempt count and the three times, after
the registers, stack frames and spills ``nvcc -Xptxas -v`` reports for its
run kernel's source.  The card's name and power limit come first.  It
needs a card and ``nvcc``.
"""

import os
import subprocess
import sys
import tempfile

LANES = 8192
RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def time_checkout(root):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.ops import _build, run, run_plan

    if not os.path.abspath(ts.__file__).startswith(root):
        raise SystemExit(f"imported {ts.__file__}, not the one in {root}")
    _build.build()
    src = os.path.join(root, "toyspice_tpu_torch", "csrc", "run_kernel.cu")
    with tempfile.TemporaryDirectory() as tmp:
        out = subprocess.run(
            [_build.nvcc_path(), *_build.FLAGS, "-Xptxas", "-v", "-o",
             os.path.join(tmp, "k.so"), src], capture_output=True,
            text=True, check=True)
    for line in (out.stdout + out.stderr).splitlines():
        if "registers" in line or "stack frame" in line:
            print(f"{root}: ptxas: {line.strip()}", flush=True)
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(0)  # bench.py: R then L then C, spread 0.1
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (LANES, len(cc.params[k]["value"]))))}
        for k in ("R", "L", "C")}
    params, _ = ts.batch_params(cc, ov)
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, LANES, "cuda")
    src = run_plan.source_stack(plan, params, LANES, "cuda")
    st = run_plan.init_state_stack(plan, ts.init_state(cc), LANES, "cuda")
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    run.launch_run_kernel(plan, dev, src, st, sc)
    torch.cuda.synchronize()
    ms = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        k = run.launch_run_kernel(plan, dev, src, st, sc)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    print(f"{root}: attempts {int(k.attempts.sum())}, kernel ms {ms}",
          flush=True)


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        time_checkout(os.path.abspath(sys.argv[2]))
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for root in sys.argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        root], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
