#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, ``toyspice_tpu_torch``.

    python3 chip_smoke.py        # from the repository root, one CUDA card

It needs PyTorch built for CUDA and ``nvcc`` (the CUDA toolkit), and imports
neither JAX nor the JAX package.  Phases, each on its own line with its
seconds:

1. device: the card's name and power limit (nvidia-smi); no card, no run.
2. build: the whole-run kernel, the OP kernel, the stamped solve, the DC
   sweep kernel and the AC kernel, one ``nvcc`` call each, all started
   together (ops/_build.py).
3. run kernel against its plain torch version on linear decks, on the
   card: 256 lanes each of an RC driven by SIN, an RL driven by PULSE and a
   PWL current source into an RC ladder, the RL deck again with minstep =
   NaN on 64 lanes, and the 8192 lanes of bench.py's RLC deck (perturbed as
   bench.py does).  accepted/attempts/fail/nr_iters must be equal per lane,
   state and t_final equal within rtol 1e-9.
4. linear main path: parse -> compile_circuit -> batch_params -> init_state
   -> build_config -> make_tran_batch(store="none") on those 8192 lanes,
   one warm-up run and one timed run; the launch counts are reset just
   before the timed run.  Every lane must finish without failing, through
   the kernel, with the same result as phase 3's kernel run.
5. OP kernel against its plain version through ``make_op_fused`` (rescue
   ladders included): ce_amplifier_op.cir, the diode divider, the MOSFET
   bias deck and the half-wave rectifier's bias, 8192 lanes with R spread
   log-normally by 0.1; the diode stack HARD_V with V1 drawn per lane in
   [2, 100] V (stages 0 and 2 both occur) and the current-driven HARD_I
   (no lane converges), 256 lanes.  converged, stage and the iteration
   counts must be equal per lane, x and jv equal within rtol 1e-9.
6. run kernel against its plain version on nonlinear decks:
   half_wave_rectifier.cir, nmos_inverter_tran.cir and a CE-amplifier BJT
   transient, 8192 lanes, R and C spread log-normally by 0.1, warm-started
   from their OP; the same bar as phase 3, jv included.
7. nonlinear main path: make_tran_batch on the half-wave rectifier, 8192
   lanes, the full 2 ms: engine "run", the OP kernel and the run kernel
   each launched, no lane failed, the lanes equal to phase 6's kernel run.
8. linear OP and linear DC sweep: run_op_batch on divider_op.cir and
   run_dc_batch on the linear divider sweep, 8192 lanes, R spread 0.1, each
   one launch of the stamped-solve kernel; then the stamped-solve kernel
   against its plain version under the same entries (converged and stage
   equal, x within rtol 1e-9), and torch.linalg.solve on the same systems.
9. DC sweep: run_dc_batch on diode_iv_sweep.cir, 8192 lanes, Rsen and the
   diode's Is spread 0.1, all 35 points in one launch of the DC sweep
   kernel; then the kernel against its plain version (conv and iterations
   equal per point, xs within rtol 1e-9).
10. AC: run_ac_batch on ce_amplifier_ac.cir, 8192 lanes, R and C spread
   0.1, 12 frequencies: the OP kernel's bias, then one launch of the AC
   kernel for the 98,304 (instance, frequency) systems; then the AC kernel
   against its plain version on the same G, B^ and RHS, and
   torch.linalg.solve on the same systems.
11. the bounds and the ``kernels`` JSON line; the last line is the contract
   line ``{"ok": true, "device": {...}}``.

Each main path (phases 4, 7, 8, 9, 10) runs with every kernel's launch
count set to 0 just before and read just after.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import toyspice_tpu_torch as ts  # noqa: E402
from toyspice_tpu_torch.compiler import SRC_PULSE, SRC_PWL, SRC_SIN  # noqa: E402
from toyspice_tpu_torch.engine.ac import make_ac_batch  # noqa: E402
from toyspice_tpu_torch.engine.dc import make_dc  # noqa: E402
from toyspice_tpu_torch.engine.op import make_op  # noqa: E402
from toyspice_tpu_torch.engine.options import DEFAULTS  # noqa: E402
from toyspice_tpu_torch.ops import (_build, ac, dc, op, run,  # noqa: E402
                                    run_plan, solve_stamped)

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_LANES = 8192
SMALL_LANES = 256
NAN_LANES = 64
RESCUE_LANES = 256
RTOL = 1e-9  # both sides f64; they may differ only in rounding order
# H100 SXM f64 rate outside the tensor cores (NVIDIA data sheet) and HBM3
# bandwidth, for the bounds of the kernels
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

# ce_amplifier_ac.cir's circuit with a SIN drive
BJT_TRAN = """* CE amplifier transient (ce_amplifier_ac.cir's circuit, SIN drive)
.tran 5u 2m
Vcc vcc 0 DC 12
Vsig sig 0 SIN(0 20m 1k)
Rsrc sig in 600
Cin in base 10u
Rb1 vcc base 68k
Rb2 base 0 12k
Rc vcc col 3.3k
Re emit 0 680
Cb emit 0 47u
Q1 col base emit QNPN
.model QNPN NPN (Bf=180 Vaf=90)
"""

# tests/test_fused_op.py's bias decks
D_DIV = """* diode divider
.op
Vin 1 0 DC 2
R1 1 2 1k
D1 2 0 DM
.model DM D (Is=1e-14 N=1.2)
"""

M_BIAS = """* MOSFET bias
.op
VDD 1 0 DC 5
VG 2 0 DC 2
RD 1 3 10k
M1 3 2 0 0 NM L=2u W=20u
.model NM NMOS(Level=1 VTO=0.7 KP=20u LAMBDA=0.01)
"""

# tests/test_rescue.py's diode stacks: only source stepping rescues HARD_V;
# nothing rescues HARD_I (source stepping scales V sources only)
HARD_V = """diode stack
.op
V1 1 0 DC 100
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-15 N=1.0)
"""

HARD_I = """i-driven stack
.op
I1 0 1 DC 1
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-18 N=0.7)
"""


# tests/test_analytic_ac_dc.py's linear sweep
DIVIDER_DC = """divider sweep
.dc Vin 0 10 0.5
Vin in 0 DC 0
R1 in mid 3k
R2 mid 0 1k
"""

# every kernel wrapper's launch count
COUNTERS = {"run_kernel": run.launch_run_kernel,
            "op_kernel": op.launch_op_kernel,
            "stamped_solve": solve_stamped.launch_stamped,
            "dc_sweep_kernel": dc.launch_dc_kernel,
            "ac_kernel": ac.launch_ac_kernel}


def reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def counts():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def check_counts(what, got, want):
    """Each kernel's launches within its (lo, hi) of ``want``; every kernel
    not named there must have none."""
    for name, n in got.items():
        lo, hi = want.get(name, (0, 0))
        if not lo <= n <= hi:
            fail(f"{what}: {name} launched {n} times, expected "
                 f"{lo}..{hi}")


def deck_file(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


def phase(name, t0, text):
    print(f"[{name}] {text} ({time.perf_counter() - t0:.3f} s)", flush=True)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def perturbed(cc, rng, b, keys, spread=0.1):
    """bench.py's log-normal perturbation of each kind's "value" leaf."""
    return {k: {"value": np.asarray(cc.params[k]["value"])[None, :] * np.exp(
        rng.normal(0.0, spread, size=(b, len(cc.params[k]["value"]))))}
        for k in keys if k in cc.params}


def rc_spread(cc, b):
    """R then C, spread 0.1, numpy default_rng(0)."""
    return perturbed(cc, np.random.default_rng(0), b, ("R", "C"))


def setup(deck, overrides_fn, b):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = (ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
           if tp is not None and tp.tstop > 0 else None)  # None: an .op
    params, axes = ts.batch_params(cc, overrides_fn(cc, b))
    return cc, cfg, params, axes, ts.init_state(cc)


def lane_inputs(cc, cfg, params, state0):
    """The run kernel's (plan, dev, src, state, scalars) for one deck."""
    plan = run_plan.make_plan(cc)
    b = run_plan.infer_batch(params, state0)
    device = torch.device("cuda")
    dev = run_plan.const_stack(plan, params, b, device, DEFAULTS.temp, state0)
    src = run_plan.source_stack(plan, params, b, device)
    st = run_plan.init_state_stack(plan, state0, b, device)
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    return plan, dev, src, st, sc


def ptxas_summary(log):
    """Registers, stack frame and spills of each kernel instantiation, from
    ``nvcc -Xptxas -v`` output."""
    out, entry, label, frame, mine = [], None, None, None, False
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry, frame = m.group(1), None
            k = re.search(r"(run_kernel|op_kernel|stamped_kernel|"
                          r"dc_sweep_kernel|ac_kernel)ILi(\d+)E(?:Lb([01])E)?",
                          entry)
            label = entry if k is None else (
                f"{k.group(1)}<{k.group(2)}" + {None: "", "0": ", linear",
                                               "1": ", newton"}[k.group(3)]
                + ">")
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            mine = m.group(1) == entry
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and mine:
            frame, mine = m.groups(), False
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            f = frame or ("?", "?", "?")
            out.append(f"{label} {m.group(1)} registers, {f[0]} B stack "
                       f"frame, {f[1]}/{f[2]} B spill stores/loads")
            entry = None
    return out


# ------------------------------------------------------------- the bounds
# The fewest f64 operations the work needs, a transcendental as one: the
# device evaluations and stamps as the kernels do them, each linear system
# as a dense LU solve (fewer operations than the kernels' Gauss-Jordan).


def lu_flops(n):
    """Gaussian elimination of an n x n real system with one right-hand
    side: per pivot k one division and n - k multiply-subtracts in each of
    the n - 1 - k rows below it, then back substitution (a multiply-subtract
    per known unknown and one division per row)."""
    fwd = sum((n - 1 - k) * (1 + 2 * (n - k)) for k in range(n))
    return fwd + sum(2 * (n - 1 - i) + 1 for i in range(n))


def complex_lu_flops(n):
    """The same for an n x n complex system, in real operations: a complex
    multiply-subtract is 8, a complex multiply 6 and each pivot's
    reciprocal 5."""
    fwd = sum((n - 1 - k) * (6 + 8 * (n - k)) for k in range(n))
    return fwd + sum(8 * (n - 1 - i) + 6 for i in range(n)) + 5 * n


def build_flops(plan, entries):
    """One add per stamp, plus its division or product by dt."""
    per_tag = {run_plan.TAG_G: 0, run_plan.TAG_GEQ: 1, run_plan.TAG_LTERM: 1,
               run_plan.TAG_ONE: 0, run_plan.TAG_CEQ: 1,
               run_plan.TAG_LRHS: 2, run_plan.TAG_VSRC: 0,
               run_plan.TAG_ISRC: 0, run_plan.TAG_NL: 0}
    return sum(1 + per_tag[int(tag)] for tag in entries[:, 2])


def step_flops(plan):
    """An attempt's work around its solve: sources, LTE, step control and
    the commit of an accepted step."""
    nc, nl = plan.counts[1:3]
    src = 0
    for kind in plan.stype:
        for s in plan.stype[kind]:
            src += {SRC_SIN: 8, SRC_PULSE: 16,
                    SRC_PWL: 3 * plan.knots[kind] + 6}.get(int(s), 0)
    return src + 6 * nc + 10 * nl + 3 * nc + 8 * nl + 10


def attempt_flops(plan):
    """A linear deck's attempt: step work plus one build and solve."""
    return step_flops(plan) + build_flops(plan, plan.entries) + lu_flops(
        plan.np1)


def newton_flops(plan):
    """One Newton iteration (csrc/newton.cuh): junction limiting, device
    evaluations (diode 12, +7 for the transient companion; BJT 134; MOSFET
    66, +75 for the three differenced currents of levels 2/3, +50 for the
    Meyer charges of a transient), the build, the solve and the
    convergence test (6 per row); an OP adds the gmin diagonal."""
    n_d, n_q, n_m = plan.counts[5:]
    tran = plan.mode == "tran"
    levels = np.asarray(plan.idx["M"]["level"]) if n_m else np.zeros(0)
    dev = (n_d * (8 + 12 + (7 if tran else 0)) + n_q * (18 + 134)
           + sum(6 + 66 + (75 if lv in (2, 3) else 0) + (50 if tran else 0)
                 for lv in levels))
    return (dev + build_flops(plan, plan.entries) + lu_flops(plan.np1)
            + 6 * plan.np1 + (0 if tran else plan.np1 - 1))


def stamped_flops(pat):
    """One stamped solve: an add per term and per gmin diagonal, then the
    elimination."""
    return int(pat.table[0]) + pat.n - 1 + lu_flops(pat.n)


def ac_flops(np1):
    """One AC lane: the N^2 products omega·B^, then the N x N complex
    system (G + j·omega·B^) x = r that the kernel's real 2N block system
    [[G, -omega·B^], [omega·B^, G]] embeds."""
    return np1 * np1 + complex_lu_flops(np1)


def timed_call(fn, *args):
    """(result, ms) of one call between CUDA events."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    r = fn(*args)
    e1.record()
    torch.cuda.synchronize()
    return r, e0.elapsed_time(e1)


def bound(flops, nbytes):
    op_ms = flops / PEAK_F64 * 1e3
    byte_ms = nbytes / PEAK_BYTES * 1e3
    return max(op_ms, byte_ms), ("operations" if op_ms >= byte_ms
                                 else "bytes"), op_ms, byte_ms


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


# ---------------------------------------------------------- comparisons


def compare_run(name, k, p, check_jv=False):
    """Exact counters, state/t_final (and jv) within RTOL; max abs err."""
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        a, b = getattr(k, key), getattr(p, key)
        if not torch.equal(a, b):
            bad = int((a != b).sum())
            fail(f"{name}: {key} differs on {bad} lanes")
    pairs = [("t_final", k.t, p.t), ("state", k.state, p.state)]
    if check_jv:
        pairs.append(("jv", k.jv, p.jv))
    return max_err(name, pairs)


def max_err(name, pairs):
    err = 0.0
    for what, a, b in pairs:
        same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
        fin = torch.isfinite(b)
        d = torch.where(fin, (a - b).abs(), 0.0)
        scale = torch.where(fin, b.abs(), 0.0)
        scale = scale.amax(dim=0, keepdim=True) if b.ndim == 2 \
            else scale.amax()
        if not same_nan or bool((d > RTOL * scale).any()) or not bool(
                (torch.isfinite(a) == fin).all()):
            fail(f"{name}: {what} differs beyond rtol {RTOL} "
                 f"(max abs {float(d.max()):.3e})")
        err = max(err, float(d.max()))
    return err


class TimedSolve:
    """A launch function with CUDA events around every launch; ``args``
    keeps each call's arguments."""

    def __init__(self, solve):
        self.solve = solve
        self.events = []
        self.args = []

    def __call__(self, *args):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        r = self.solve(*args)
        e1.record()
        self.events.append((e0, e1))
        self.args.append(args)
        return r

    def ms(self):
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for e0, e1 in self.events)


def stamped_phases(lanes):
    """Phase 8: the linear OP and the linear DC sweep through the stamped-solve
    kernel, then the kernel against its plain version."""
    def r_only(cc, b):
        return perturbed(cc, np.random.default_rng(0), b, ("R",))

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("divider_op.cir"), r_only,
                                        lanes)
    ts.run_op_batch(cc, params, axes)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    opr = ts.run_op_batch(cc, params, axes)
    torch.cuda.synchronize()
    op_wall = time.perf_counter() - w0
    got = counts()
    check_counts("linear OP main path", got, {"stamped_solve": (1, 1)})
    st_launches = got["stamped_solve"]
    ra, rb = (params["R"]["value"][:, k] for k in (0, 1))
    want = 12.0 * rb / (ra + rb)
    if not (bool(opr.converged.all()) and bool((opr.stage == 0).all())
            and bool(((opr.x[:, 2] - want).abs()
                      <= 1e-12 * want.abs()).all())):
        fail("linear OP: a lane did not converge at stage 0 or V(mid) is "
             "not 12·Rb/(Ra + Rb)")
    tk = TimedSolve(solve_stamped.solve_lanes)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    k = make_op(cc, DEFAULTS, solve=tk)(params, state0)
    p = make_op(cc, DEFAULTS, solve=tp_)(params, state0)
    for key in ("converged", "stage"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"linear OP: {key} differs from the plain version")
    st_err = max_err("linear OP", [("x", k.x, p.x), ("x", opr.x, p.x)])
    st_ms, st_pms = tk.ms(), tp_.ms()
    systems = [tk.args[0]]
    phase("8 linear OP", t0,
          f"divider_op: {lanes} lanes, np1={cc.np1}, stamped-solve "
          f"launches={st_launches}, converged {int(opr.converged.sum())} at "
          f"stage 0, wall={op_wall:.6f} s; kernel vs plain equal, max abs "
          f"err {st_err:.3e}; kernel {st_ms:.3f} ms, plain {st_pms:.1f} ms")

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(DIVIDER_DC, r_only, lanes)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    ts.run_dc_batch(cc, (0,), params, axes, pts)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xs, conv = ts.run_dc_batch(cc, (0,), params, axes, pts)
    torch.cuda.synchronize()
    ldc_wall = time.perf_counter() - w0
    got = counts()
    check_counts("linear DC main path", got, {"stamped_solve": (1, 1)})
    st_launches += got["stamped_solve"]
    ra, rb = (params["R"]["value"][:, k] for k in (0, 1))
    want = torch.as_tensor(pts, device=ra.device)[None] * (
        rb / (ra + rb))[:, None]
    if xs.shape != (lanes, len(pts), cc.np1) or not bool(
            conv.all()) or not bool(((xs[..., 2] - want).abs()
                                     <= 1e-12 * want.abs().amax()).all()):
        fail("linear DC: wrong shape, a point not converged, or V(mid) is "
             "not Vin·R2/(R1 + R2)")
    tk = TimedSolve(solve_stamped.solve_lanes)
    tp_ = TimedSolve(solve_stamped.solve_plain)
    xk, ck = make_dc(cc, (0,), DEFAULTS, solve=tk)(params, state0, pts)
    xp, cp = make_dc(cc, (0,), DEFAULTS, solve=tp_)(params, state0, pts)
    if not torch.equal(ck, cp):
        fail("linear DC: conv differs from the plain version")
    ldc_err = max_err("linear DC", [("xs", xk.reshape(-1, cc.np1),
                                     xp.reshape(-1, cc.np1)),
                                    ("xs", xs.reshape(-1, cc.np1),
                                     xp.reshape(-1, cc.np1))])
    st_err = max(st_err, ldc_err)
    dk_ms, dp_ms = tk.ms(), tp_.ms()
    st_ms, st_pms = st_ms + dk_ms, st_pms + dp_ms
    systems.append(tk.args[0])
    lib_ms = 0.0
    st_flops = st_bytes = 0
    for pat, vals, rvals, gmin in systems:
        m = solve_stamped.build_plain(pat, vals, rvals, gmin)
        a_, b_ = m[:, :, :pat.n].contiguous(), m[:, :, pat.n:].contiguous()
        torch.linalg.solve(a_, b_)  # warm-up
        _, ms = timed_call(torch.linalg.solve, a_, b_)
        lib_ms += ms
        st_flops += vals.shape[0] * stamped_flops(pat)
        st_bytes += nbytes(vals, rvals, gmin) + pat.table.nbytes \
            + vals.shape[0] * pat.n * 8
    stamped = dict(launches=st_launches, err=st_err, k_ms=st_ms,
                   p_ms=st_pms, lib_ms=lib_ms, flops=st_flops,
                   nbytes=st_bytes, systems=[v.shape[0] for _, v, _, _ in
                                             systems])
    phase("8 linear DC", t0,
          f"divider sweep: {lanes} lanes x {len(pts)} points = "
          f"{lanes * len(pts)} systems in one stamped-solve launch, "
          f"all converged, wall={ldc_wall:.6f} s; kernel vs plain equal, "
          f"max abs err {ldc_err:.3e}; kernel {dk_ms:.3f} ms, plain "
          f"{dp_ms:.1f} ms; torch.linalg.solve on the OP's and the sweep's "
          f"systems {lib_ms:.3f} ms")
    return stamped


def dc_phase(lanes):
    """Phase 9: the DC sweep main path and the DC sweep kernel against its
    plain version."""
    def rsen_is(cc, b):
        rng = np.random.default_rng(0)
        ov = perturbed(cc, rng, b, ("R",))
        is_ = np.asarray(cc.params["D"]["is_"])
        ov["D"] = {"is_": is_[None] * np.exp(rng.normal(0.0, 0.1,
                                                        (b, len(is_))))}
        return ov

    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("diode_iv_sweep.cir"),
                                        rsen_is, lanes)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    if len(pts) != 35:
        fail(f"diode_iv_sweep: {len(pts)} sweep points, expected 35")
    slot = (cc.names["V"].index(d.source1),)
    ts.run_dc_batch(cc, slot, params, axes, pts)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xs, conv = ts.run_dc_batch(cc, slot, params, axes, pts)
    torch.cuda.synchronize()
    dc_wall = time.perf_counter() - w0
    got = counts()
    check_counts("DC sweep main path", got, {"dc_sweep_kernel": (1, 1)})
    dc_launches = got["dc_sweep_kernel"]
    # the diode current I(Vb) = -x[branch] rises with the sweep
    i_b = -xs[..., cc.np1 - 1]
    if xs.shape != (lanes, 35, cc.np1) or not bool(conv.all()) or \
            not bool(torch.isfinite(xs).all()) or not bool(
                (i_b[:, 1:] > i_b[:, :-1]).all()):
        fail("DC sweep: wrong shape, a point not converged or not finite, "
             "or the diode current not rising")
    tk = TimedSolve(dc.dc_lanes)
    tp_ = TimedSolve(dc.dc_plain)
    k = dc.make_dc_fused(cc, slot, DEFAULTS, solve=tk)(params, state0, pts)
    p = dc.make_dc_fused(cc, slot, DEFAULTS, solve=tp_)(params, state0, pts)
    for key in ("conv", "iters"):
        if not torch.equal(getattr(k, key), getattr(p, key)):
            fail(f"DC sweep: {key} differs from the plain version")
    dc_err = max_err("DC sweep", [
        ("xs", k.xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1)),
        ("xs", xs.reshape(-1, cc.np1), p.xs.reshape(-1, cc.np1))])
    dk_ms, dp_ms = tk.ms(), tp_.ms()
    plan_dc, dev_, dyn_, vs_, _ = tk.args[0]
    dc_iters = int(k.iters.sum())
    dc_main = dict(launches=dc_launches, err=dc_err, k_ms=dk_ms, p_ms=dp_ms,
                   plan=plan_dc, iters=dc_iters,
                   nbytes=nbytes(dev_, dyn_, vs_, k.xs) + plan_dc.topo.nbytes
                   + lanes * len(pts) * 8)
    phase("9 DC sweep", t0,
          f"diode_iv_sweep: {lanes} lanes x {len(pts)} points in one "
          f"launch, np1={cc.np1}, all converged, Newton iterations "
          f"{dc_iters} ({dc_iters / (lanes * len(pts)):.6f} per "
          f"point), wall={dc_wall:.6f} s; kernel vs plain equal, max abs "
          f"err {dc_err:.3e}; kernel {dk_ms:.3f} ms, plain {dp_ms:.1f} ms")
    return dc_main


def ac_phase(lanes):
    """Phase 10: the AC main path and the AC kernel against its plain
    version."""
    t0 = time.perf_counter()
    cc, _, params, axes, state0 = setup(deck_file("ce_amplifier_ac.cir"),
                                        rc_spread, lanes)
    a = cc.netlist.ac
    freqs = ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
    ts.run_ac_batch(cc, params, axes, freqs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    xr, xi, opr = ts.run_ac_batch(cc, params, axes, freqs)
    torch.cuda.synchronize()
    ac_wall = time.perf_counter() - w0
    got = counts()
    check_counts("AC main path", got, {"op_kernel": (1, 1 << 30),
                                       "ac_kernel": (1, 1)})
    ac_launches = got["ac_kernel"]
    nf = len(freqs)
    if xr.shape != (lanes, nf, cc.np1) or not bool(
            opr.converged.all()) or not bool(
                torch.isfinite(xr).all() & torch.isfinite(xi).all()):
        fail("AC: wrong shape, a bias not converged, or a value not finite")
    # the AC source's node is the source's phasor, 1 + 0j, at every lane
    # and frequency
    sig = cc.netlist.nodes["sig"]
    if not (bool(((xr[..., sig] - 1.0).abs() <= 1e-12).all())
            and bool((xi[..., sig].abs() <= 1e-12).all())):
        fail("AC: V(sig) is not the source's 1 + 0j")
    tk = TimedSolve(ac.launch_ac_kernel)
    tp_ = TimedSolve(ac.ac_plain)
    kr, ki, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tk)(
        params, state0, freqs)
    pr, pi_, _ = make_ac_batch(cc, axes, DEFAULTS, ac_solve=tp_)(
        params, state0, freqs)
    n2 = 2 * cc.np1
    ac_err = max_err("AC", [
        ("xr", kr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1)),
        ("xi", ki.reshape(-1, cc.np1), pi_.reshape(-1, cc.np1)),
        ("xr", xr.reshape(-1, cc.np1), pr.reshape(-1, cc.np1))])
    ak_ms, ap_ms = tk.ms(), tp_.ms()
    g_, bh_, r_, om_ = tk.args[0]
    m = ac.build_systems(g_, bh_, r_, om_)
    a_, b_ = m[:, :, :n2].contiguous(), m[:, :, n2:].contiguous()
    torch.linalg.solve(a_, b_)  # warm-up
    _, ac_lib_ms = timed_call(torch.linalg.solve, a_, b_)
    ac_main = dict(launches=ac_launches, err=ac_err, k_ms=ak_ms, p_ms=ap_ms,
                   lib_ms=ac_lib_ms,
                   flops=lanes * nf * ac_flops(cc.np1),
                   nbytes=nbytes(g_, bh_, r_, om_)
                   + lanes * nf * n2 * 8)
    phase("10 AC", t0,
          f"ce_amplifier_ac: {lanes} lanes x {nf} frequencies = "
          f"{lanes * nf} systems of {n2}, OP kernel launches "
          f"{got['op_kernel']} (stages "
          f"{torch.bincount(opr.stage.long(), minlength=3).tolist()}), AC "
          f"kernel launches {ac_launches}, wall={ac_wall:.6f} s; kernel vs "
          f"plain max abs err {ac_err:.3e}; kernel {ak_ms:.3f} ms, plain "
          f"{ap_ms:.1f} ms, torch.linalg.solve {ac_lib_ms:.3f} ms")
    return ac_main


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
    fresh = [name for name in _build.SOURCES
             if not _build.library_path(name).exists()]
    libs = _build.build(extra_flags=("-Xptxas", "-v"))
    logs = dict(_build.build.log)
    for name in _build.SOURCES:
        _build.load(name)
    phase("2 build", t0, f"built {fresh or 'nothing'} with one nvcc call "
          "per source, started together: "
          + ", ".join(p.name for p in libs.values()))
    for name, text in logs.items():
        print(f"[2 ptxas] {name}: {'; '.join(ptxas_summary(text))}",
              flush=True)

    # -------------------------------- 3 run kernel vs plain, linear decks
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

    def nan_minstep(sc):
        return sc._replace(minstep=float("nan"))

    decks = [("rc_sin", RC_SIN, small(("R", "C")), SMALL_LANES, None),
             ("rl_pulse", RL_PULSE, small(("R", "L")), SMALL_LANES, None),
             ("ipwl_ladder", IPWL, small(("R", "C"), pwl=True), SMALL_LANES,
              None),
             ("rl_nan_minstep", RL_PULSE, small(("R", "L")), NAN_LANES,
              nan_minstep),
             ("bench_rlc", RLC, bench_overrides, BENCH_LANES, None)]
    lin_err = 0.0
    bench = None

    def kernel_vs_plain(plan, dev, src, st, sc, jv0=None):
        run.launch_run_kernel(plan, dev, src, st, sc, jv0)  # warm-up
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
        e1.record()
        torch.cuda.synchronize()
        k_ms = e0.elapsed_time(e1)
        p0 = time.perf_counter()
        p = run.run_plain(plan, dev, src, st, sc, jv0)
        torch.cuda.synchronize()
        return k, k_ms, p, (time.perf_counter() - p0) * 1e3

    for name, deck, ov, b, edit in decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(deck, ov, b)
        plan, dev, src, st, sc = lane_inputs(cc, cfg, params, state0)
        if edit:
            sc = edit(sc)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc)
        err = compare_run(name, k, p)
        lin_err = max(lin_err, err)
        attempts = int(k.attempts.sum())
        phase("3 kernel vs plain", t0,
              f"{name}: {b} lanes, np1={plan.np1}, accepted "
              f"{int(k.accepted.sum())}, attempts {attempts}, failed "
              f"{int(k.fail.sum())}; counters equal, max abs err {err:.3e}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if edit is nan_minstep and not (
                bool(torch.isnan(k.t).all()) and bool(k.fail.all())
                and k.attempts.tolist() == [2] * b):
            fail(f"{name}: expected every lane to fail after 2 attempts "
                 "with t NaN, as the general engine does")
        if name == "bench_rlc":
            bench = dict(k=k, k_ms=k_ms, p_ms=p_ms, plan=plan, dev=dev,
                         src=src, st=st, attempts=attempts)

    # ----------------------------------------------- 4 linear main path
    t0 = time.perf_counter()
    cc = ts.compile_circuit(ts.parse(RLC))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, bench_overrides(cc, BENCH_LANES))
    state0 = ts.init_state(cc)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    lin_launches = got["run_kernel"]
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    failed = int(out.fail.sum())
    if fn.engine != "run":
        fail(f"main path engine {fn.engine!r}, expected 'run'")
    check_counts("linear main path", got, {"run_kernel": (1, 1)})
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
          f"engine={fn.engine}, launches={lin_launches}, "
          f"lanes={BENCH_LANES}, accepted={accepted}, attempts={attempts}, "
          f"failed={failed}, wall={wall:.6f} s, {rate:.6e} accepted steps/s "
          f"on {smi}")

    # ------------------------------------- 5 OP kernel vs plain version
    def r_spread(cc, b):
        return perturbed(cc, np.random.default_rng(0), b, ("R",))

    def v1_draw(cc, b):
        return {"V": {"dc": np.random.default_rng(0).uniform(2.0, 100.0,
                                                              (b, 1))}}

    op_decks = [
        ("half_wave_rectifier", deck_file("half_wave_rectifier.cir"),
         rc_spread, BENCH_LANES),
        ("ce_amplifier_op", deck_file("ce_amplifier_op.cir"), r_spread,
         BENCH_LANES),
        ("diode_divider", D_DIV, r_spread, BENCH_LANES),
        ("mosfet_bias", M_BIAS, r_spread, BENCH_LANES),
        ("hard_v", HARD_V, v1_draw, RESCUE_LANES),
        ("hard_i", HARD_I, lambda cc, b: {"I": {"dc": np.ones((b, 1))}},
         RESCUE_LANES)]
    op_err = 0.0
    op_main = None
    for name, deck, ov, b in op_decks:
        t0 = time.perf_counter()
        cc, _, params, axes, state0 = setup(deck, ov, b)
        fk = op.make_op_fused(cc, DEFAULTS, solve=op.op_lanes)
        fk(params, state0)  # warm-up
        tk = TimedSolve(op.op_lanes)
        tp_ = TimedSolve(op.op_plain)
        op.launch_op_kernel.launches = 0
        k = op.make_op_fused(cc, DEFAULTS, solve=tk)(params, state0)
        launches = op.launch_op_kernel.launches
        p = op.make_op_fused(cc, DEFAULTS, solve=tp_)(params, state0)
        k_ms, p_ms = tk.ms(), tp_.ms()
        for key in ("converged", "stage", "iters", "iters_all"):
            if not torch.equal(getattr(k, key), getattr(p, key)):
                fail(f"{name}: OP {key} differs from the plain version")
        pairs = [("x", k.x, p.x)] + [
            (f"jv.{kd}.{key}", k.jv[kd][key], p.jv[kd][key])
            for kd in k.jv for key in k.jv[kd]]
        err = max_err(name, pairs)
        op_err = max(op_err, err)
        stages = torch.bincount(k.stage.long(), minlength=3).tolist()
        conv = int(k.converged.sum())
        if name == "hard_v" and not (stages[0] and stages[2]
                                     and conv == b):
            fail("hard_v: expected lanes at stages 0 and 2, all converged")
        if name == "hard_i" and (conv or stages[2] != b):
            fail("hard_i: expected every lane through the whole ladder and "
                 "none converged (source stepping scales V sources only)")
        if name not in ("hard_v", "hard_i") and conv != b:
            fail(f"{name}: {b - conv} lanes did not converge")
        phase("5 OP kernel vs plain", t0,
              f"{name}: {b} lanes, np1={cc.np1}, stages {stages}, "
              f"converged {conv}, NR iterations stage 0 "
              f"{int(k.iters.sum())}, all {int(k.iters_all.sum())}, "
              f"launches {launches}; equal counts, max abs err {err:.3e}; "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "half_wave_rectifier":
            # bytes of each launch: dev and dyn rows, x and jv in and out,
            # the two counters, the plan
            plan_op = fk.plan
            per_lane = 8 * (plan_op.nd + op.dyn_width(plan_op)
                            + 2 * (plan_op.np1 + plan_op.kj)) + 8
            op_main = dict(k_ms=k_ms, p_ms=p_ms, plan=plan_op,
                           iters=int(k.iters_all.sum()),
                           nbytes=launches * (b * per_lane
                                              + plan_op.topo.nbytes))

    # ------------------------- 6 run kernel vs plain, nonlinear decks
    nl_decks = [("half_wave_rectifier", deck_file("half_wave_rectifier.cir")),
                ("nmos_inverter_tran", deck_file("nmos_inverter_tran.cir")),
                ("bjt_ce_tran", BJT_TRAN)]
    nl_err = 0.0
    hwr = None
    for name, deck in nl_decks:
        t0 = time.perf_counter()
        cc, cfg, params, axes, state0 = setup(deck, rc_spread, BENCH_LANES)
        plan, dev, src, st, sc = lane_inputs(cc, cfg, params, state0)
        opr = op.make_op_fused(cc, DEFAULTS)(params, state0)
        jv0 = run_plan.jv_stack(plan, opr.jv, BENCH_LANES)
        k, k_ms, p, p_ms = kernel_vs_plain(plan, dev, src, st, sc, jv0)
        err = compare_run(name, k, p, check_jv=True)
        nl_err = max(nl_err, err)
        acc_ = int(k.accepted.sum())
        att_ = int(k.attempts.sum())
        nri = int(k.nr_iters.sum())
        phase("6 nonlinear kernel vs plain", t0,
              f"{name}: {BENCH_LANES} lanes, np1={plan.np1}, accepted "
              f"{acc_}, attempts {att_}, NR iterations {nri}, failed "
              f"{int(k.fail.sum())}; counters equal, max abs err "
              f"{err:.3e}; kernel {k_ms:.3f} ms, plain {p_ms:.1f} ms")
        if name == "half_wave_rectifier":
            hwr = dict(k=k, k_ms=k_ms, p_ms=p_ms, plan=plan, attempts=att_,
                       nri=nri, nbytes=nbytes(dev, src, st, jv0)
                       + nbytes(st, jv0) + plan.topo.nbytes
                       + BENCH_LANES * (8 + 8 + 4 + 4 + 4 + 4))

    # --------------------------------------- 7 nonlinear main path
    t0 = time.perf_counter()
    cc, cfg, params, axes, state0 = setup(
        deck_file("half_wave_rectifier.cir"), rc_spread, BENCH_LANES)
    fn = ts.make_tran_batch(cc, cfg, axes, store="none")
    out = fn(params, state0)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    w0 = time.perf_counter()
    out = fn(params, state0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - w0
    got = counts()
    nl_launches = got["run_kernel"]
    op_launches = got["op_kernel"]
    accepted = int(out.accepted.sum())
    attempts = int(out.attempts.sum())
    nri = int(out.nr_iters.sum())
    failed = int(out.fail.sum())
    if fn.engine != "run":
        fail(f"nonlinear main path engine {fn.engine!r}, expected 'run'")
    check_counts("nonlinear main path", got,
                 {"run_kernel": (1, 1), "op_kernel": (1, 1 << 30)})
    if failed or not bool((out.t_final == cfg.tstop).all()):
        fail(f"{failed} of {BENCH_LANES} lanes failed or stopped early")
    k = hwr["k"]
    if not (torch.equal(out.accepted, k.accepted)
            and torch.equal(out.attempts, k.attempts)
            and torch.equal(out.nr_iters, k.nr_iters)
            and torch.equal(out.t_final, k.t)
            and torch.equal(out.jv["D"]["vd"], k.jv)):
        fail("nonlinear main path differs from phase 6's kernel run")
    phase("7 nonlinear main path", t0,
          f"half_wave_rectifier: engine={fn.engine}, run kernel launches="
          f"{nl_launches}, OP kernel launches={op_launches}, "
          f"lanes={BENCH_LANES}, accepted={accepted}, attempts={attempts}, "
          f"failed={failed}, NR iterations per attempt "
          f"{nri / attempts:.6f}, wall={wall:.6f} s, "
          f"{accepted / wall:.6e} accepted steps/s on {smi}")

    stamped = stamped_phases(BENCH_LANES)
    dc_main = dc_phase(BENCH_LANES)
    ac_main = ac_phase(BENCH_LANES)

    # ------------------------------------------------ 11 the kernels line
    plan = bench["plan"]
    lin_bytes = nbytes(bench["dev"], bench["src"], bench["st"]) \
        + plan.topo.nbytes + nbytes(bench["st"]) \
        + BENCH_LANES * (8 + 8 + 4 + 4 + 4 + 4)
    lin_bound = bound(attempt_flops(plan) * bench["attempts"], lin_bytes)
    print(f"[11 bound] run_kernel linear (bench_rlc): {attempt_flops(plan)} "
          f"f64 operations per attempt x {bench['attempts']} attempts / "
          f"{PEAK_F64:.3g} op/s = {lin_bound[2]:.6f} ms; {lin_bytes} bytes / "
          f"{PEAK_BYTES:.3g} B/s = {lin_bound[3]:.6f} ms", flush=True)
    hp = hwr["plan"]
    nl_flops = hwr["attempts"] * step_flops(hp) + hwr["nri"] * newton_flops(
        hp)
    nl_bound = bound(nl_flops, hwr["nbytes"])
    print(f"[11 bound] run_kernel nonlinear (half_wave_rectifier): "
          f"{hwr['attempts']} attempts x {step_flops(hp)} + {hwr['nri']} "
          f"Newton iterations x {newton_flops(hp)} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {nl_bound[2]:.6f} ms; {hwr['nbytes']} "
          f"bytes / {PEAK_BYTES:.3g} B/s = {nl_bound[3]:.6f} ms", flush=True)
    opp = op_main["plan"]
    seed = BENCH_LANES * (build_flops(opp, opp.entries[:opp.n_lin])
                          + lu_flops(opp.np1))
    op_flops = op_main["iters"] * newton_flops(opp) + seed
    op_bound = bound(op_flops, op_main["nbytes"])
    print(f"[11 bound] op_kernel (half_wave_rectifier bias): "
          f"{op_main['iters']} Newton iterations x {newton_flops(opp)} + "
          f"{BENCH_LANES} linear estimates, {op_flops} f64 operations / "
          f"{PEAK_F64:.3g} op/s = {op_bound[2]:.6f} ms; "
          f"{op_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{op_bound[3]:.6f} ms", flush=True)

    st_bound = bound(stamped["flops"], stamped["nbytes"])
    print(f"[11 bound] stamped_solve (divider_op + divider sweep): "
          f"{stamped['systems']} systems, {stamped['flops']} f64 operations "
          f"/ {PEAK_F64:.3g} op/s = {st_bound[2]:.6f} ms; "
          f"{stamped['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{st_bound[3]:.6f} ms", flush=True)
    dp = dc_main["plan"]
    dc_per_iter = newton_flops(dp) - (dp.np1 - 1)  # no gmin diagonal
    dc_bound = bound(dc_main["iters"] * dc_per_iter, dc_main["nbytes"])
    print(f"[11 bound] dc_sweep_kernel (diode_iv_sweep): "
          f"{dc_main['iters']} Newton iterations x {dc_per_iter} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {dc_bound[2]:.6f} ms; "
          f"{dc_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{dc_bound[3]:.6f} ms", flush=True)
    ac_bound = bound(ac_main["flops"], ac_main["nbytes"])
    print(f"[11 bound] ac_kernel (ce_amplifier_ac): {ac_main['flops']} f64 "
          f"operations / {PEAK_F64:.3g} op/s = {ac_bound[2]:.6f} ms; "
          f"{ac_main['nbytes']} bytes / {PEAK_BYTES:.3g} B/s = "
          f"{ac_bound[3]:.6f} ms", flush=True)

    def entry(name, source, replaces, launches, err, k_ms, p_ms, bd,
              lib_ms=None):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bd[0], "bound_by": bd[1], "library_ms": lib_ms}

    run_src = "toyspice_tpu_torch/csrc/run_kernel.cu"
    line = {"kernels": [
        entry("run_kernel", run_src, "toyspice_tpu/ops/pallas_run.py:652",
              lin_launches, lin_err, bench["k_ms"], bench["p_ms"],
              lin_bound),
        entry("run_kernel_nonlinear", run_src,
              "toyspice_tpu/ops/pallas_run.py:652", nl_launches, nl_err,
              hwr["k_ms"], hwr["p_ms"], nl_bound),
        entry("op_kernel", "toyspice_tpu_torch/csrc/op_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:230", op_launches, op_err,
              op_main["k_ms"], op_main["p_ms"], op_bound),
        entry("stamped_solve", "toyspice_tpu_torch/csrc/stamped_solve.cu",
              "toyspice_tpu/ops/pallas_solve.py:337", stamped["launches"],
              stamped["err"], stamped["k_ms"], stamped["p_ms"], st_bound,
              stamped["lib_ms"]),
        entry("dc_sweep_kernel", "toyspice_tpu_torch/csrc/dc_sweep_kernel.cu",
              "toyspice_tpu/ops/pallas_op.py:431", dc_main["launches"],
              dc_main["err"], dc_main["k_ms"], dc_main["p_ms"], dc_bound),
        entry("ac_kernel", "toyspice_tpu_torch/csrc/ac_kernel.cu",
              "toyspice_tpu/ops/pallas_ac.py:102", ac_main["launches"],
              ac_main["err"], ac_main["k_ms"], ac_main["p_ms"], ac_bound,
              ac_main["lib_ms"]),
    ]}
    phase("done", start, "all phases passed")
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
