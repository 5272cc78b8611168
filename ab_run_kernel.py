#!/usr/bin/env python3
"""Time the whole-run kernel of ``toyspice_tpu_torch`` on bench.py's
8192-lane RLC deck (its linear instantiation), with ``--rectifier`` on
the 8192-lane half-wave rectifier (its Newton instantiation, warm-started
from the OP kernel), or with ``--physics`` on that rectifier under physics
semantics and the trapezoidal rule (the PHYS Newton instantiation, from
the physics OP's bias point: chip_smoke.py's physics main path), for
several checkouts of the port, in turns, on one CUDA card.

    python3 ab_run_kernel.py _parent . . _parent
    python3 ab_run_kernel.py --rectifier --reps 10 _parent . . _parent
    python3 ab_run_kernel.py --physics --reps 10 . .

Each argument is a directory holding a ``toyspice_tpu_torch`` package (for
example the parent commit unpacked with ``git archive`` into a directory
that ``.gitignore`` lists); each runs in a process of its own, in the order
given, builds its kernel, launches it once to warm up and ``--reps`` times
(default 3) under CUDA events, and prints its attempt count and the times.
The first process of each directory first prints the registers, stack
frames and spills ``nvcc -Xptxas -v`` reports for each of its kernel
sources.  The card's name and power limit come
first.  It needs a card and ``nvcc``.
"""

import argparse
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


def rectifier_deck(root):
    with open(os.path.join(root, "circuits", "half_wave_rectifier.cir")) as f:
        return f.read()


def print_ptxas(root, _build):
    """``nvcc -Xptxas -v`` of every kernel source of the checkout, the
    compiles started together; each kernel's lines, tagged with the
    source's name."""
    with tempfile.TemporaryDirectory() as tmp:
        defines = getattr(_build, "DEFINES", {})
        procs = {name: subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, *defines.get(name, ()),
             "-Xptxas", "-v", "-o", os.path.join(tmp, f"{name}.so"),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in _build.SOURCES.items()}
        for name, proc in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{root}: nvcc failed on {name}:\n{text}")
            for line in text.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "stack frame" in line):
                    print(f"{root}: ptxas {name}: {line.strip()}",
                          flush=True)


def time_checkout(root, deck, reps, ptxas=True, physics=False):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.ops import _build, run, run_plan

    if not os.path.abspath(ts.__file__).startswith(root):
        raise SystemExit(f"imported {ts.__file__}, not the one in {root}")
    _build.build()
    if ptxas:
        print_ptxas(root, _build)
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(0)  # bench.py: R then L then C, spread 0.1
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (LANES, len(cc.params[k]["value"]))))}
        for k in ("R", "L", "C") if k in cc.params}
    params, _ = ts.batch_params(cc, ov)
    state0 = ts.init_state(cc)
    if physics:  # the physics OP's bias point, as make_tran_run builds it
        plan, dev, src, st, sc, jv0, *_ = run.run_inputs(
            cc, cfg, params, state0, ts.SimOptions(integration="trap"),
            "physics")
    else:  # built here, so that an older checkout without run_inputs
        # times too
        plan = run_plan.make_plan(cc)
        dev = run_plan.const_stack(plan, params, LANES, "cuda", 300.15,
                                   state0)
        src = run_plan.source_stack(plan, params, LANES, "cuda")
        st = run_plan.init_state_stack(plan, state0, LANES, "cuda")
        sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                            cfg.max_attempts)
        jv0 = None
        if plan.nonlinear:  # the OP's junction voltages
            from toyspice_tpu_torch.engine.options import DEFAULTS
            from toyspice_tpu_torch.ops import op

            jv0 = run_plan.jv_stack(
                plan, op.make_op_fused(cc, DEFAULTS)(params, state0).jv,
                LANES)
    run.launch_run_kernel(plan, dev, src, st, sc, jv0)
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    print(f"{root}: attempts {int(k.attempts.sum())}, Newton iterations "
          f"{int(k.nr_iters.sum())}, kernel ms {ms}", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rectifier", action="store_true",
                    help="time the rectifier (Newton) instead of bench.py's "
                    "deck")
    ap.add_argument("--physics", action="store_true",
                    help="time the rectifier under physics semantics and "
                    "the trapezoidal rule (a checkout with the physics "
                    "instantiation)")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed launches per checkout")
    ap.add_argument("--no-ptxas", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    a = ap.parse_args()
    if a.one:
        here = os.path.dirname(os.path.abspath(__file__))
        deck = (rectifier_deck(here) if a.rectifier or a.physics else RLC)
        time_checkout(os.path.abspath(a.roots[0]), deck, a.reps,
                      not a.no_ptxas, a.physics)
        return 0
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    extra = (["--reps", str(a.reps)]
             + (["--rectifier"] if a.rectifier else [])
             + (["--physics"] if a.physics else []))
    seen = set()
    for root in a.roots:
        quiet = a.no_ptxas or os.path.abspath(root) in seen
        seen.add(os.path.abspath(root))
        subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                        *extra, *(["--no-ptxas"] if quiet else []), root],
                       check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
