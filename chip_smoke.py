#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``toyspice_tpu_torch``.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It needs PyTorch built for CUDA and ``nvcc`` (the CUDA toolkit), and imports
neither JAX nor the JAX package.  Phases, each on its own line with its
seconds:

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: the whole-run kernel, one ``nvcc`` call (ops/_build.py).
3. kernel against its plain torch version, on the card: 256 lanes each of
   an RC driven by SIN, an RL driven by PULSE and a PWL current source into
   an RC ladder, and the 8192 lanes of bench.py's RLC deck (perturbed as
   bench.py does).  accepted/attempts/fail must be equal per lane, state and
   t_final equal within rtol 1e-9.
4. main path: parse -> compile_circuit -> batch_params -> init_state ->
   build_config -> make_tran_batch(store="none") on those 8192 lanes, one
   warm-up run and one timed run; the launch count is reset just before
   the timed run.  Every lane must finish without failing, through the
   kernel, with the same result as phase 3's kernel run.
5. the ``kernels`` JSON line; the last line is the contract line
   ``{"ok": true, "device": {...}}``.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import toyspice_tpu_torch as ts  # noqa: E402
from toyspice_tpu_torch.compiler import SRC_PULSE, SRC_PWL, SRC_SIN  # noqa: E402
from toyspice_tpu_torch.ops import _build, run, run_plan  # noqa: E402

BENCH_LANES = 8192
SMALL_LANES = 256
RTOL = 1e-9  # both sides f64; they may differ only in rounding order
# H100 SXM f64 rate outside the tensor cores (NVIDIA data sheet) and HBM3
# bandwidth, for the bound of the kernel
PEAK_F64 = 34e12
PEAK_BYTES = 3.35e12

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""

RC_SIN = """* rc sin
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
C1 2 0 1u
"""

RL_PULSE = """* rl pulse
.tran 0.02m 1m
Vin 1 0 PULSE(0 5 0.1m 0.01m 0.01m 0.3m 0.8m)
R1 1 2 50
L1 2 0 10m
"""

IPWL = """* isrc pwl into rc ladder
.tran 0.02m 1m
I1 0 1 PWL(0 0 0.2m 3m 0.5m 1m)
R1 1 0 1k
C1 1 0 0.2u
C2 1 2 0.1u
R2 2 0 2k
"""


def phase(name, t0, text):
    print(f"[{name}] {text} ({time.perf_counter() - t0:.3f} s)", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def perturbed(cc, rng, b, keys, spread=0.1):
    """bench.py's log-normal perturbation of each kind's "value" leaf."""
    return {k: {"value": np.asarray(cc.params[k]["value"])[None, :] * np.exp(
        rng.normal(0.0, spread, size=(b, len(cc.params[k]["value"]))))}
        for k in keys}


def setup(deck, overrides_fn, b):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, overrides_fn(cc, b))
    return cc, cfg, params, axes, ts.init_state(cc)


def lane_inputs(cc, cfg, params, state0):
    """The kernel's (plan, dev, src, state, scalars) for one deck."""
    plan = run_plan.make_plan(cc)
    b = run_plan.infer_batch(params, state0)
    device = torch.device("cuda")
    dev = run_plan.const_stack(plan, params, b, device)
    src = run_plan.source_stack(plan, params, b, device)
    st = run_plan.init_state_stack(plan, state0, b, device)
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    return plan, dev, src, st, sc


def attempt_flops(plan):
    """f64 operations one attempt needs, counted from the deck's plan (a
    transcendental counts as one): sources, build (one add per stamp, plus
    its division or product), elimination, LTE, step control and the
    commit of an accepted step.  Gauss-Jordan stage k needs only the n - k
    columns right of its pivot: one division each in the pivot row, a
    multiply and a subtract each in the n - 1 other rows."""
    n = plan.np1
    nc, nl = plan.counts[1:3]
    per_tag = {run_plan.TAG_G: 0, run_plan.TAG_GEQ: 1, run_plan.TAG_LTERM: 1,
               run_plan.TAG_ONE: 0, run_plan.TAG_CEQ: 1, run_plan.TAG_LRHS: 2,
               run_plan.TAG_VSRC: 0, run_plan.TAG_ISRC: 0}
    build = sum(1 + per_tag[int(tag)] for tag in plan.entries[:, 2])
    gj = sum((n - k) * (1 + 2 * (n - 1)) for k in range(n))
    src = 0
    for kind in plan.stype:
        for s in plan.stype[kind]:
            src += {SRC_SIN: 8, SRC_PULSE: 16,
                    SRC_PWL: 3 * plan.knots[kind] + 6}.get(int(s), 0)
    lte = 6 * nc + 10 * nl
    commit = 3 * nc + 8 * nl
    return build + gj + src + lte + commit + 10


def compare(name, k, p):
    """Exact counters, state and t_final within RTOL; returns max abs err."""
    for key in ("accepted", "attempts", "fail"):
        a, b = getattr(k, key), getattr(p, key)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{name}: {key} differs on {bad} lanes")
    err = 0.0
    for what, a, b in (("t_final", k.t, p.t), ("state", k.state, p.state)):
        d = (a - b).abs()
        scale = b.abs().amax(dim=0, keepdim=True) if b.ndim == 2 \
            else b.abs().amax()
        if bool((d > RTOL * scale).any()) or not bool(torch.isfinite(a).all()):
            fail(f"{name}: {what} differs beyond rtol {RTOL} "
                 f"(max abs {float(d.max()):.3e})")
        err = max(err, float(d.max()))
    return err


def main():
    start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false: no card, "
              "no run", file=sys.stderr)
        return 2

    # ---------------------------------------------------------- 1 device
    t0 = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    print(smi, flush=True)
    phase("1 device", t0, f"{kind}, {count} device(s), torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")

    # ----------------------------------------------------------- 2 build
    t0 = time.perf_counter()
    fresh = not _build.library_path().exists()
    lib_path = _build.build()
    _build.load()
    phase("2 build", t0, f"{'built' if fresh else 'found'} {lib_path.name} "
          f"with one nvcc call")

    # --------------------------------------- 3 kernel vs plain version
    def small(keys, pwl=False):
        def overrides(cc, b):
            rng = np.random.default_rng(1)
            ov = perturbed(cc, rng, b, keys)
            if pwl:
                pv = np.asarray(cc.params["I"]["pwl_v"])
                ov["I"] = {"pwl_v": pv[None] * np.exp(
                    rng.normal(0.0, 0.1, size=(b,) + pv.shape))}
            return ov
        return overrides

    def bench_overrides(cc, b):
        # bench.py: numpy default_rng(0), R then L then C, spread 0.1
        return perturbed(cc, np.random.default_rng(0), b, ("R", "L", "C"))

    decks = [("rc_sin", RC_SIN, small(("R", "C")), SMALL_LANES),
             ("rl_pulse", RL_PULSE, small(("R", "L")), SMALL_LANES),
             ("ipwl_ladder", IPWL, small(("R", "C"), pwl=True), SMALL_LANES),
             ("bench_rlc", RLC, bench_overrides, BENCH_LANES)]
    max_err = 0.0
    bench = None
    for name, deck, ov, b in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(deck, ov, b)
        plan, dev, src, st, sc = lane_inputs(cc, cfg, params, state0)
        run.launch_run_kernel(plan, dev, src, st, sc)  # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        k = run.launch_run_kernel(plan, dev, src, st, sc)
        e1.record()
        torch.cuda.synchronize()
        k_ms = e0.elapsed_time(e1)
        p0 = time.perf_counter()
        p = run.run_plain(plan, dev, src, st, sc)
        torch.cuda.synchronize()
        p_ms = (time.perf_counter() - p0) * 1e3
        err = compare(name, k, p)
        max_err = max(max_err, err)
        attempts = int(k.attempts.sum())
        phase("3 kernel vs plain", t0,
              f"{name}: {b} lanes, np1={plan.np1}, accepted "
              f"{int(k.accepted.sum())}, attempts {attempts}, failed "
              f"{int(k.fail.sum())}; counters equal, max abs err {err:.3e}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "bench_rlc":
            bench = dict(k=k, k_ms=k_ms, p_ms=p_ms, plan=plan, dev=dev,
                         src=src, st=st, attempts=attempts)

    # ------------------------------------------------------ 4 main path
    t0 = time.perf_counter()
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, BENCH_LANES))
    state0 = ts.init_state(cc)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    run.launch_run_kernel.launches = 0
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    launches = run.launch_run_kernel.launches
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    failed = int(out.fail.sum())
    if fn.engine != "run":
        fail(f"main path engine {fn.engine!r}, expected 'run'")
    if launches != 1:
        fail(f"main path launched the kernel {launches} times, expected 1")
    if failed:
        fail(f"{failed} of {BENCH_LANES} lanes failed")
    if out.accepted.shape != (BENCH_LANES,) or out.t_final.shape != (
            BENCH_LANES,):
        fail("main path outputs have the wrong shape")
    if not bool((out.t_final == cfg.tstop).all()):
        fail("a lane stopped before tstop")
    for kind_ in out.state.values():
        for leaf in kind_.values():
            if leaf.shape[0] != BENCH_LANES or not bool(
                    torch.isfinite(leaf).all()):
                fail("main path state is not finite or has the wrong shape")
    k = bench["k"]
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.t_final, k.t)):
        fail("main path differs from phase 3's kernel run on the same lanes")
    rate = accepted / wall
    phase("4 main path", t0,
          f"engine={fn.engine}, launches={launches}, lanes={BENCH_LANES}, "
          f"accepted={accepted}, attempts={attempts}, failed={failed}, "
          f"wall={wall:.6f} s, {rate:.6e} accepted steps/s on {smi}")

    # ------------------------------------------------- 5 the kernels line
    plan = bench["plan"]
    flops = attempt_flops(plan) * bench["attempts"]
    nbytes = sum(x.numel() * x.element_size() for x in
                 (bench["dev"], bench["src"], bench["st"]))
    nbytes += plan.topo.nbytes + bench["st"].numel() * 8 \
        + BENCH_LANES * (8 + 8 + 4 + 4 + 4)
    op_ms = flops / PEAK_F64 * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    print(f"[5 bound] {attempt_flops(plan)} f64 operations per attempt x "
          f"{bench['attempts']} attempts = {flops:.4e} / {PEAK_F64:.3g} "
          f"op/s = {op_ms:.6f} ms; {nbytes} bytes / {PEAK_BYTES:.3g} B/s "
          f"= {byte_ms:.6f} ms", flush=True)
    line = {"kernels": [{
        "name": "run_kernel",
        "route": "cuda",
        "source": "toyspice_tpu_torch/csrc/run_kernel.cu",
        "replaces": "toyspice_tpu/ops/pallas_run.py:652",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": bench["k_ms"],
        "plain_ms": bench["p_ms"],
        "bound_ms": max(op_ms, byte_ms),
        "bound_by": "operations" if op_ms >= byte_ms else "bytes",
        "library_ms": None,
    }]}
    phase("done", start, "all phases passed")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
