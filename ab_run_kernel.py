#!/usr/bin/env python3
"""Time the whole-run kernel of ``toyspice_tpu_torch`` on bench.py's
8192-lane RLC deck (its linear instantiation), with ``--store`` on the
same deck through its store instantiation (one monolithic launch into
zeroed buffers, as the streamed path's chunks are held to), with
``--magphys`` on the 8192-lane saturating transformer under physics
semantics and the trapezoidal rule (the linear PHYS MAG instantiation,
from the linear OP's bias point: chip_smoke.py's physics magnetic main
path), with ``--rectifier`` on
the 8192-lane half-wave rectifier (its Newton instantiation, warm-started
from the OP kernel), or with ``--physics`` on that rectifier under physics
semantics and the trapezoidal rule (the PHYS Newton instantiation, from
the physics OP's bias point: chip_smoke.py's physics main path), with
``--nlstore`` on that rectifier through the store instantiation,
``store='full'``, compat and physics/trap (one launch each into zeroed
buffers: chip_smoke.py's store and physics store main paths), or with
``--lmdiode`` on LM_DIODE (chip_smoke.py's two-winding J-A transformer
with a rectifier on its secondary), 256 lanes, compat and physics/trap
(the magnetic Newton instantiations: chip_smoke.py phase 23), or with
``--rc`` on an 8192-lane RC low-pass (a linear deck of np1 = 4, the
smallest size bucket), for
several checkouts of the port, in turns, on one CUDA card.  With ``--opdc``
it times the OP kernel's launches of an OP ladder (that rectifier's one
launch, plain Newton from the linear estimate, compat and physics;
ce_amplifier_op.cir's whole ladder; 8192 lanes each) and the DC sweep
kernel on diode_iv_sweep.cir (35 points, 8192 lanes, compat and physics
with the diode's Rs per lane), and both on LM_DIODE at 256 lanes (the OP,
and a 15-point sweep of its source, compat and physics), beside the run
flags given (alone: no run kernel): each rep is the mean of 20
back-to-back calls of the kernel's C entry point on the buffers its
checkout's own wrapper prepared (a ladder's launches in turn), so that the
wrapper's host work does not hide a launch that takes tens of
microseconds, and each checkout calls its entry with its own argument
list.  ``--ac`` adds, beside bench.py's deck, the AC kernel on
ce_amplifier_ac.cir's 8192 x 12 systems of 16, and ``--stamped`` (bench.py's
deck only beside another run flag) the stamped solve on each of its main
paths' launches: divider_op.cir's linear OP (np1 = 4) and its 21-point sweep,
saturating_transformer.cir's linear OP (8192 lanes each); random dense
patterns of n = 8, 16 and 32 (8192 lanes: the segment kernel's other
buckets); one batched Newton iteration of cw16 (a 16-stage
Cockcroft-Walton multiplier, np1 = 35, 8192 lanes: chip_smoke.py's
general-engine main path) and of a 127-stage RC ladder (np1 = 130, past
NBIG, 1024 lanes: chip_smoke.py phase 32; a checkout whose kernel refuses
it says so), each captured from its wrapper's call of the checkout's own
C entry and timed the same way, beside torch.linalg.solve on the built
systems and the bound (chip_smoke.py's).  ``--gj`` times the GJ
kernel (``csrc/gj_kernel.cu``, the general engine's dense solve) on
lc16_ac_8192's 172,032 systems of 72 (a 16-section LC ladder's AC, built
by the general AC as chip_smoke.py phase 30 builds them), on cw16's OP
seed (8192 systems of 35), on 8192 random systems of 96, 128 and 132 and
on lc31_ac_1024's 21,504 systems of 132 (chip_smoke.py phase 32), each
through its C entry and through ``launch_gj``, beside torch.linalg.solve
and the bound (chip_smoke.py's); it builds and prints ``-Xptxas -v`` of
the ``gj`` and ``stamped`` libraries only, and runs bench.py's deck only
beside another run flag.  ``--floor`` first writes ``_var_floor/``
(gitignored): this checkout's ``toyspice_tpu_torch`` with the wide
register body switched off (csrc/gj_block.cuh GJ_NWIDE = GJ_NREG), so
that 97 <= n <= 168 runs the shared-memory body at 512 threads, the floor
the register body has to beat; name ``_var_floor`` among the checkouts.

    python3 ab_run_kernel.py _parent . . _parent
    python3 ab_run_kernel.py --gj _parent . . _parent
    python3 ab_run_kernel.py --store --magphys --rectifier _parent . . _parent
    python3 ab_run_kernel.py --ac --stamped _parent . . _parent
    python3 ab_run_kernel.py --gj --stamped --floor _parent . _var_floor \
        . _var_floor _parent
    python3 ab_run_kernel.py --rectifier --reps 10 _parent . . _parent
    python3 ab_run_kernel.py --physics --reps 10 . .
    python3 ab_run_kernel.py --rectifier --physics --nlstore --lmdiode \
        _parent . . _parent
    python3 ab_run_kernel.py --opdc --reps 10 _parent . . _parent
    python3 ab_run_kernel.py --opdc --rectifier --physics _parent . . _parent

The run flags may be given together: each checkout then times each of
the named runs in turn (bench.py's deck through the run kernel first
when ``--store``, ``--magphys`` or ``--rc`` is given, or no run flag at
all).

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
import re
import shutil
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
RC = """* RC low-pass
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 1k
C1 2 0 1u
"""


def deck_text(root, name):
    with open(os.path.join(root, "circuits", name)) as f:
        return f.read()


def rectifier_deck(root):
    return deck_text(root, "half_wave_rectifier.cir")


def spread_params(ts, cc, keys=("R", "L", "C"), lanes=LANES):
    """bench.py's perturbation: each of ``keys`` in turn, log-normal by
    0.1 from one seed."""
    import numpy as np

    rng = np.random.default_rng(0)
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params[k]["value"]))))}
        for k in keys if k in cc.params}
    return ts.batch_params(cc, ov)


def event_ms(fn, reps):
    """One warm-up call of ``fn``, then ``reps`` calls under CUDA events;
    returns (the last call's result, the times in ms)."""
    import torch

    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = fn()
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    return out, ms


def entry_calls(_build, launch, args):
    """Call a checkout's own kernel wrapper ``launch`` once on ``args``,
    recording each call of its library's C entry (whatever argument list
    that checkout's entry takes) and keeping every tensor the wrapper
    makes alive, so that the calls can be replayed on the same buffers:
    (the wrapper's result, [(entry, arguments)], the tensors kept)."""
    import torch

    seen, keep = [], []
    load = _build.load

    class Recorder:
        def __init__(self, lib):
            self.lib = lib

        def __getattr__(self, name):
            fn = getattr(self.lib, name)
            if name == "tsr_error_string":
                return fn

            def call(*a):
                seen.append((fn, a))
                return fn(*a)
            return call

    def keeping(make):
        def made(*a, **k):
            out = make(*a, **k)
            keep.append(out)
            return out
        return made

    makers = {name: getattr(torch, name) for name in
              ("as_tensor", "empty", "empty_like", "zeros", "zeros_like",
               "full")}
    _build.load = lambda name="run": Recorder(load(name))
    for name, make in makers.items():
        setattr(torch, name, keeping(make))
    try:
        out = launch(*args)
    finally:
        _build.load = load
        for name, make in makers.items():
            setattr(torch, name, make)
    return out, seen, keep


def time_op_dc(root, reps, calls=20):
    """The OP kernel's launches of an OP ladder (the rectifier's, compat
    and physics, 8192 lanes: one launch each; ce_amplifier_op's whole
    ladder, 8192 lanes; LM_DIODE's, compat and physics, 256 lanes) and the
    DC sweep kernel's one launch (diode_iv_sweep.cir at 8192 lanes, compat,
    and physics with the diode's Rs drawn per lane; LM_DIODE's 15 points at
    256 lanes, compat and physics), each launch's inputs captured from its
    entry's call and its C entry's arguments from the checkout's own
    wrapper; each rep times ``calls`` calls of every launch's C entry on
    those buffers (a ladder: its launches in turn), in ms a call."""
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from chip_smoke import LM_DIODE
    from toyspice_tpu_torch.engine.options import DEFAULTS
    from toyspice_tpu_torch.ops import _build, dc, op

    here = os.path.dirname(os.path.abspath(__file__))

    def replay(launches):
        """Each rep: every launch's entry calls, ``calls`` times over."""
        def many():
            for _ in range(calls):
                for fn, a in launches:
                    err = fn(*a)
                    if err != 0:
                        return err
            return 0
        err, ms = event_ms(many, reps)
        if err != 0:
            raise SystemExit(f"{root}: launch failed: CUDA error {err}")
        return [m / calls for m in ms]

    def op_case(name, cc, params, semantics):
        args = []

        def solve(*a):
            args.append(a)
            return op.op_plain(*a)

        op.make_op_fused(cc, DEFAULTS, semantics, solve=solve)(
            params, ts.init_state(cc))
        launches, keep, iters, conv = [], [], 0, 0
        for a in args:
            r, seen, kept = entry_calls(_build, op.launch_op_kernel, a)
            launches += seen
            keep += kept
            iters += int(r.iters.sum())
            conv = int(r.conv.sum())
        ms = replay(launches)
        b = args[0][1].shape[0]
        print(f"{root}: OP kernel ({name}, {semantics}, {b} lanes, "
              f"{len(args)} launches): Newton iterations {iters}, converged "
              f"at the last launch {conv}, kernel ms {ms}", flush=True)
        del keep

    def dc_case(name, cc, params, slots, pts, semantics):
        args = []

        def solve(*a):
            args.append(a)
            return dc.dc_plain(*a)

        dc.make_dc_fused(cc, slots, DEFAULTS, semantics, solve=solve)(
            params, ts.init_state(cc), pts)
        r, seen, keep = entry_calls(_build, dc.launch_dc_kernel, args[0])
        ms = replay(seen)
        b, npts = r.xs.shape[:2]
        print(f"{root}: DC sweep kernel ({name}, {semantics}, {b} lanes x "
              f"{npts} points): Newton iterations {int(r.iters.sum())}, "
              f"converged {int(r.conv.sum())}, kernel ms {ms}", flush=True)
        del keep

    cc = ts.compile_circuit(ts.parse(rectifier_deck(here)))
    params, _ = spread_params(ts, cc)
    for semantics in ("compat", "physics"):
        op_case("half_wave_rectifier", cc, params, semantics)
    cc = ts.compile_circuit(ts.parse(deck_text(here, "ce_amplifier_op.cir")))
    params, _ = spread_params(ts, cc, ("R",))
    op_case("ce_amplifier_op", cc, params, "compat")

    cc = ts.compile_circuit(ts.parse(deck_text(here, "diode_iv_sweep.cir")))
    d = cc.netlist.dc
    slot = (cc.names["V"].index(d.source1),)
    pts = ts.sweep_values(d.start1, d.stop1, d.increment1)
    params, _ = spread_params(ts, cc, ("R",))
    dc_case("diode_iv_sweep", cc, params, slot, pts, "compat")
    rs = np.random.default_rng(0).uniform(1.0, 20.0, (LANES, 1))
    params, _ = ts.batch_params(cc, {
        "R": {"value": np.asarray(cc.params["R"]["value"])[None]
              * np.exp(np.random.default_rng(0).normal(0, 0.1, (LANES, 1)))},
        "D": {"rs": rs}})
    dc_case("diode_iv_sweep, Rs per lane", cc, params, slot, pts, "physics")

    cc = ts.compile_circuit(ts.parse(LM_DIODE))
    params, _ = spread_params(ts, cc, ("R", "C"), 256)
    for semantics in ("compat", "physics"):
        op_case("lm_diode", cc, params, semantics)
        dc_case("lm_diode", cc, params, (0,), np.linspace(-2.0, 5.0, 15),
                semantics)
    torch.cuda.synchronize()


def entry_ms(root, fn, args, reps, calls=20):
    """Each rep: the mean of ``calls`` back-to-back calls of a C entry."""
    def many():
        for _ in range(calls):
            err = fn(*args)
        return err
    err, ms = event_ms(many, reps)
    if err != 0:
        raise SystemExit(f"{root}: launch failed: CUDA error {err}")
    return [m / calls for m in ms]


def time_ac_stamped(root, reps, do_ac, do_stamped):
    """The AC kernel on ce_amplifier_ac.cir (8192 lanes, R and C spread),
    on the inputs its wrapper was called with, and the stamped solve
    (``time_stamped``)."""
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.ac import make_ac_batch
    from toyspice_tpu_torch.engine.options import DEFAULTS
    from toyspice_tpu_torch.ops import _build, ac

    here = os.path.dirname(os.path.abspath(__file__))
    stream = torch.cuda.current_stream().cuda_stream
    if do_ac:
        cc = ts.compile_circuit(ts.parse(deck_text(here,
                                                   "ce_amplifier_ac.cir")))
        params, axes = spread_params(ts, cc, ("R", "C"))
        a = cc.netlist.ac
        freqs = ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
        seen = []

        def capture(*args):
            seen.append(args)
            return ac.launch_ac_kernel(*args)

        make_ac_batch(cc, axes, DEFAULTS, ac_solve=capture)(
            params, ts.init_state(cc), freqs)
        g, bh, r, om = seen[0]
        b, n, nf = g.shape[0], g.shape[1], om.shape[0]
        x = torch.empty((b, nf, 2 * n), dtype=torch.float64,
                        device=g.device)
        entry = _build.load("ac").tsr_ac
        # a checkout whose entry takes a workspace (every np1) gets none:
        # ce_amplifier_ac's systems do not read it
        work = (0, 0) if len(entry.argtypes) == 11 else ()
        ms = entry_ms(root, entry, (
            n, b, nf, g.data_ptr(), bh.data_ptr(), r.data_ptr(),
            om.data_ptr(), x.data_ptr(), *work, stream), reps)
        print(f"{root}: AC kernel (ce_amplifier_ac, {b} x {nf} systems of "
              f"{2 * n}): kernel ms {ms}", flush=True)
    if do_stamped:
        time_stamped(root, reps)


def time_stamped(root, reps):
    """The stamped solve's C entry on one launch of each of its paths, the
    arguments recorded from the checkout's own wrapper (``entry_calls``)."""
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.dc import make_dc
    from toyspice_tpu_torch.engine.op import make_op
    from toyspice_tpu_torch.engine.options import SimOptions
    from toyspice_tpu_torch.engine.tran import make_tran
    from toyspice_tpu_torch.ops import _build, solve_stamped
    from chip_smoke import (DIVIDER_DC, bound, cockcroft_walton, nbytes,
                            stamped_flops)

    here = os.path.dirname(os.path.abspath(__file__))

    def captured(run, k=0):
        """(pat, vals, rvals, gmin) of launch k of run(solve)."""
        seen = []

        def capture(pat, vals, rvals, gmin):
            if len(seen) <= k:
                seen.append((pat, vals.clone(), rvals.clone(),
                             gmin.clone()))
            return solve_stamped.solve_lanes(pat, vals, rvals, gmin)
        run(capture)
        return seen[min(k, len(seen) - 1)]

    def deck(text, keys, lanes=LANES):
        cc = ts.compile_circuit(ts.parse(text))
        return cc, spread_params(ts, cc, keys, lanes)[0], ts.init_state(cc)

    def op_of(text, semantics="compat"):
        cc, params, s0 = deck(text, ("R",))
        opts = SimOptions(integration="trap" if semantics == "physics"
                          else "be")
        return lambda solve: make_op(cc, opts, semantics, solve=solve)(
            params, s0)

    def sweep_of(text):
        cc, params, s0 = deck(text, ("R",))
        d = cc.netlist.dc
        pts = ts.sweep_values(d.start1, d.stop1, d.increment1)
        return lambda solve: make_dc(cc, (0,), solve=solve)(params, s0, pts)

    def tran_of(text, lanes, tstop):
        cc, params, s0 = deck(text, ("C",), lanes)
        tp = cc.netlist.tran
        cfg = ts.build_config(tp.tstart, tstop, tp.tstep, tp.tmax, tp.uic)
        return lambda solve: make_tran(cc, cfg, store="none", solve=solve)(
            params, s0)

    def dense(n):
        def run(solve):
            rng = np.random.default_rng(n)
            a = rng.normal(size=(LANES, n, n)) + 4.0 * np.eye(n)
            rows, cols = np.meshgrid(np.arange(1, n), np.arange(n),
                                     indexing="ij")
            pat = solve_stamped.solve_stamped_for(
                n, rows.ravel(), cols.ravel(), np.arange(1, n)).pattern
            solve(pat, torch.as_tensor(a[:, 1:].reshape(LANES, -1).copy(),
                                       device="cuda"),
                  torch.as_tensor(rng.normal(size=(LANES, n - 1)),
                                  device="cuda"),
                  torch.zeros(LANES, dtype=torch.float64, device="cuda"))
        return run

    ladder = ["* 127-stage rc ladder", ".tran 0.01m 0.05m",
              "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, 128):
        ladder += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 1n"]
    cases = (
        ("divider_op linear OP", op_of(deck_text(here, "divider_op.cir")),
         0),
        ("divider sweep", sweep_of(DIVIDER_DC), 0),
        ("saturating_transformer linear OP, physics",
         op_of(deck_text(here, "saturating_transformer.cir"), "physics"), 0),
        ("random n=8", dense(8), 0), ("random n=16", dense(16), 0),
        ("random n=32", dense(32), 0),
        ("cw16, its 40th batched Newton iteration",
         tran_of(cockcroft_walton(16), LANES, 1e-4), 39),
        ("127-stage rc ladder past NBIG, its 5th batched Newton iteration",
         tran_of("\n".join(ladder) + "\n", 1024, 0.05e-3), 4))
    for name, run, k in cases:
        try:
            pat, vals, rvals, gmin = captured(run, k)
            _, calls, keep = entry_calls(_build, solve_stamped.launch_stamped,
                                         (pat, vals, rvals, gmin))
        except (ValueError, RuntimeError) as e:
            print(f"{root}: stamped solve ({name}): not run by this "
                  f"checkout: {e}", flush=True)
            continue
        b = vals.shape[0]
        fn, args = calls[-1]
        ms = entry_ms(root, fn, args, reps)
        m = solve_stamped.build_plain(pat, vals, rvals, gmin)
        am, bm = m[:, :, :-1].contiguous(), m[:, :, -1].contiguous()
        _, lib = event_ms(lambda: torch.linalg.solve(am, bm), reps)
        bd = bound(b * stamped_flops(pat), nbytes(vals, rvals, gmin)
                   + pat.table.nbytes + b * pat.n * 8)
        print(f"{root}: stamped solve ({name}, {b} systems of {pat.n}, "
              f"{int(pat.table[0])} terms): kernel ms {ms}, "
              f"torch.linalg.solve ms {lib}, bound ms {bd[0]:.6f} "
              f"({bd[1]})", flush=True)
        del m, am, bm
        del keep
        torch.cuda.empty_cache()


def time_gj(root, reps):
    """The GJ kernel on lc16_ac_8192's systems (8192 lanes, C spread, 21
    frequencies: 172,032 systems of 72), on cw16's OP seed (8192 systems
    of 35, C spread), on 8192 random systems of 96 (the largest a row a
    thread), of 128 and of 132 (the wide register body; the shared-memory
    body in ``_var_floor``) and on lc31_ac_1024's systems (1024 lanes, C
    spread, 21 frequencies: 21,504 systems of 132), each captured from
    its caller (or made from one seed) and timed through the C entry
    (``calls`` calls a rep), through ``launch_gj`` and as
    torch.linalg.solve, beside chip_smoke.py's bound; the first 16384
    systems of each are held to ``gj_plain`` bit for bit."""
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.ac import make_ac
    from toyspice_tpu_torch.engine.op import make_op
    from toyspice_tpu_torch.ops import _build, solve
    from chip_smoke import (bound, cockcroft_walton, lc_ladder, lu_flops,
                            nbytes, same_bits)


    def capture(run):
        seen = []

        def dense(a, b):
            seen.append((a, b))
            return solve.linear_solve(a, b)
        run(dense)
        return seen[0]

    def lc_ac(sections, lanes, dense):
        cc = ts.compile_circuit(ts.parse(lc_ladder(sections)))
        params, _ = spread_params(ts, cc, ("C",), lanes)
        ap = cc.netlist.ac
        make_ac(cc, dense_solve=dense)(params, ts.init_state(cc),
                                       ts.frequency_points(
                                           ap.sweep, ap.fstart, ap.fstop,
                                           ap.points))

    def cw16(dense):
        cc = ts.compile_circuit(ts.parse(cockcroft_walton(16)))
        params, _ = spread_params(ts, cc, ("C",))
        make_op(cc, dense_solve=dense)(params, ts.init_state(cc))

    def random(n):
        rng = np.random.default_rng(n)
        a = rng.normal(size=(LANES, n, n)) + 4.0 * np.eye(n)
        return (torch.as_tensor(a, device="cuda"),
                torch.as_tensor(rng.normal(size=(LANES, n)), device="cuda"))

    for name, make, calls in (("lc16_ac_8192", lambda: capture(
            lambda d: lc_ac(16, LANES, d)), 5),
                              ("cw16 OP seed", lambda: capture(cw16), 20),
                              ("random n=96", lambda: random(96), 5),
                              ("random n=128", lambda: random(128), 5),
                              ("random n=132", lambda: random(132), 5),
                              ("lc31_ac_1024", lambda: capture(
                                  lambda d: lc_ac(31, 1024, d)), 5)):
        a, b = make()
        nsys, n = a.shape[0], a.shape[1]
        try:
            x, seen, keep = entry_calls(_build, solve.launch_gj, (a, b))
        except (ValueError, RuntimeError) as e:
            print(f"{root}: GJ kernel ({name}, {nsys} systems of {n}): not "
                  f"run by this checkout: {e}", flush=True)
            continue
        fn, args = seen[-1]
        ms = entry_ms(root, fn, args, reps, calls)
        _, wms = event_ms(lambda: solve.launch_gj(a, b), reps)
        _, lib = event_ms(lambda: torch.linalg.solve(a, b), reps)
        bd = bound(nsys * lu_flops(n), nbytes(a, b) + nbytes(b))
        k = min(nsys, 16384)
        bits = same_bits(x[:k], solve.gj_plain(a[:k], b[:k]))
        print(f"{root}: GJ kernel ({name}, {nsys} systems of {n}): kernel "
              f"ms {ms}, with launch_gj {wms}, torch.linalg.solve ms {lib}, "
              f"bound ms {bd[0]:.6f} ({bd[1]}), the first {k} "
              f"bit-identical to gj_plain {bits}", flush=True)
        del a, b, x, keep
        torch.cuda.empty_cache()


def print_ptxas(root, _build, names):
    """``nvcc -Xptxas -v`` of the named kernel sources of the checkout, the
    compiles started together; each kernel's lines, tagged with the
    source's name."""
    with tempfile.TemporaryDirectory() as tmp:
        defines = getattr(_build, "DEFINES", {})
        procs = {name: subprocess.Popen(
            [_build.nvcc_path(), *_build.FLAGS, *defines.get(name, ()),
             "-Xptxas", "-v", "-o", os.path.join(tmp, f"{name}.so"),
             str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, src in _build.SOURCES.items() if name in names}
        for name, proc in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise SystemExit(f"{root}: nvcc failed on {name}:\n{text}")
            for line in text.splitlines():
                if ("Compiling entry" in line or "registers" in line
                        or "stack frame" in line):
                    print(f"{root}: ptxas {name}: {line.strip()}",
                          flush=True)


def nlstore_case(root, ts, run, reps):
    """The rectifier's store='full' launch, compat and physics/trap, each
    from its OP's junction voltages into zeroed buffers."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    cc = ts.compile_circuit(ts.parse(rectifier_deck(here)))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = spread_params(ts, cc)
    for semantics, opts in (("compat", ts.SimOptions()),
                            ("physics", ts.SimOptions(integration="trap"))):
        plan, dev, src, st, sc, jv0, *_ = run.run_inputs(
            cc, cfg, params, ts.init_state(cc), opts, semantics)
        keep = run.Store(cfg.tstart, cfg.max_store)
        m = cfg.max_store
        buf = run.Waveforms(
            torch.zeros((LANES, m, plan.np1), dtype=torch.float64,
                        device="cuda"),
            torch.zeros((LANES, m), dtype=torch.float64, device="cuda"),
            None, None)
        (k, kw), ms = event_ms(lambda: run.launch_store_kernel(
            plan, dev, src, st, sc, keep, jv0, out=buf), reps)
        print(f"{root}: Newton store (half_wave_rectifier, {semantics}, "
              f"{LANES} lanes, {m} rows a lane): attempts "
              f"{int(k.attempts.sum())}, Newton iterations "
              f"{int(k.nr_iters.sum())}, rows {int(kw.out_n.sum())}, kernel "
              f"ms {ms}", flush=True)
        del buf, kw
        torch.cuda.empty_cache()


def lmdiode_case(root, ts, run, reps, lanes=256):
    """LM_DIODE's run-kernel launch, compat and physics/trap, 256 lanes, R
    and C spread, from the OP's bias point (the magnetic Newton
    instantiations)."""
    from chip_smoke import LM_DIODE

    cc = ts.compile_circuit(ts.parse(LM_DIODE))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = spread_params(ts, cc, ("R", "C"), lanes)
    for semantics, opts in (("compat", ts.SimOptions()),
                            ("physics", ts.SimOptions(integration="trap"))):
        plan, dev, src, st, sc, jv0, *_ = run.run_inputs(
            cc, cfg, params, ts.init_state(cc), opts, semantics)
        k, ms = event_ms(lambda: run.launch_run_kernel(
            plan, dev, src, st, sc, jv0), reps)
        print(f"{root}: lm_diode ({semantics}, {lanes} lanes): attempts "
              f"{int(k.attempts.sum())}, Newton iterations "
              f"{int(k.nr_iters.sum())}, kernel ms {ms}", flush=True)


def run_case(root, ts, run, run_plan, mode, reps):
    """Time one run of the kernel: ``mode`` "rlc" (bench.py's deck),
    "store" (the same deck through the store instantiation, one launch
    into zeroed buffers), "rectifier" (the Newton instantiation from the
    OP's junction voltages), "physics" (that rectifier under physics/trap),
    "magphys" (the saturating transformer under physics/trap), "rc" (RC,
    linear, np1 = 4), "nlstore" (nlstore_case) or "lmdiode"
    (lmdiode_case)."""
    import torch

    if mode == "nlstore":
        return nlstore_case(root, ts, run, reps)
    if mode == "lmdiode":
        return lmdiode_case(root, ts, run, reps)
    here = os.path.dirname(os.path.abspath(__file__))
    if mode in ("rectifier", "physics"):
        deck, keys = rectifier_deck(here), ("R", "L", "C")
    elif mode == "magphys":
        deck, keys = deck_text(here, "saturating_transformer.cir"), ("R",)
    elif mode == "rc":
        deck, keys = RC, ("R", "C")
    else:
        deck, keys = RLC, ("R", "L", "C")
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = spread_params(ts, cc, keys)
    state0 = ts.init_state(cc)
    if mode in ("physics", "magphys"):  # the physics OP's bias point, as
        # make_tran_run builds it
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
    if mode == "store":
        keep = run.Store(cfg.tstart, cfg.max_store)
        m = cfg.max_store
        buf = run.Waveforms(
            torch.zeros((LANES, m, plan.np1), dtype=torch.float64,
                        device="cuda"),
            torch.zeros((LANES, m), dtype=torch.float64, device="cuda"),
            None, None)
        (k, kw), ms = event_ms(lambda: run.launch_store_kernel(
            plan, dev, src, st, sc, keep, out=buf), reps)
        print(f"{root}: store (bench_rlc, {LANES} lanes, {m} rows a lane): "
              f"attempts {int(k.attempts.sum())}, rows "
              f"{int(kw.out_n.sum())}, kernel ms {ms}", flush=True)
        del buf, kw
        torch.cuda.empty_cache()
        return
    k, ms = event_ms(
        lambda: run.launch_run_kernel(plan, dev, src, st, sc, jv0), reps)
    label = {"rlc": "", "rectifier": " (half_wave_rectifier)",
             "physics": " (half_wave_rectifier, physics/trap)",
             "magphys": " (saturating_transformer, physics/trap)",
             "rc": f" (RC low-pass, np1 = {plan.np1})"}[mode]
    print(f"{root}:{label} attempts {int(k.attempts.sum())}, Newton "
          f"iterations {int(k.nr_iters.sum())}, kernel ms {ms}", flush=True)


def time_checkout(root, modes, reps, ptxas=True, opdc=False, do_ac=False,
                  do_stamped=False, do_gj=False):
    sys.path.insert(0, root)
    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.ops import _build, run, run_plan

    if not os.path.abspath(ts.__file__).startswith(root):
        raise SystemExit(f"imported {ts.__file__}, not the one in {root}")
    names = (tuple(_build.SOURCES) if modes or opdc else
             ("gj", "stamped") + (("ac", "op") if do_ac else ()))
    _build.build(names)
    if ptxas:
        print_ptxas(root, _build, names)
    if opdc:
        time_op_dc(root, reps)
    for mode in modes:
        run_case(root, ts, run, run_plan, mode, reps)
    if do_ac or do_stamped:
        time_ac_stamped(root, reps, do_ac, do_stamped)
    if do_gj:
        time_gj(root, reps)


def floor_variant():
    """``_var_floor/toyspice_tpu_torch``: this checkout's package with
    csrc/gj_block.cuh's GJ_NWIDE set to GJ_NREG, so that the GJ kernel and
    the stamped solve run the shared-memory body from n = 97."""
    here = os.path.dirname(os.path.abspath(__file__))
    dst = os.path.join(here, "_var_floor", "toyspice_tpu_torch")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(here, "toyspice_tpu_torch"), dst,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    hdr = os.path.join(dst, "csrc", "gj_block.cuh")
    with open(hdr) as f:
        text = f.read()
    edge = re.search(r"constexpr int GJ_NWIDE = \d+;", text)
    if edge is None:
        raise SystemExit("no GJ_NWIDE in csrc/gj_block.cuh: no floor variant")
    with open(hdr, "w") as f:
        f.write(text.replace(edge.group(0),
                             "constexpr int GJ_NWIDE = GJ_NREG;"))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rectifier", action="store_true",
                    help="time the rectifier (Newton) instead of bench.py's "
                    "deck")
    ap.add_argument("--store", action="store_true",
                    help="also time bench.py's deck through the store "
                    "instantiation, one launch into zeroed buffers")
    ap.add_argument("--magphys", action="store_true",
                    help="also time the saturating transformer under "
                    "physics semantics and the trapezoidal rule")
    ap.add_argument("--rc", action="store_true",
                    help="also time an RC low-pass (linear, np1 = 4)")
    ap.add_argument("--physics", action="store_true",
                    help="time the rectifier under physics semantics and "
                    "the trapezoidal rule (a checkout with the physics "
                    "instantiation)")
    ap.add_argument("--nlstore", action="store_true",
                    help="time the rectifier's store='full' launch, compat "
                    "and physics/trap (the Newton store instantiations)")
    ap.add_argument("--lmdiode", action="store_true",
                    help="time LM_DIODE's run launch at 256 lanes, compat "
                    "and physics/trap (the magnetic Newton "
                    "instantiations)")
    ap.add_argument("--opdc", action="store_true",
                    help="time the OP and DC sweep kernels (beside the run "
                    "flags given)")
    ap.add_argument("--ac", action="store_true",
                    help="also time the AC kernel on ce_amplifier_ac.cir")
    ap.add_argument("--stamped", action="store_true",
                    help="also time the stamped solve on each of its paths "
                    "(n = 4 to 130)")
    ap.add_argument("--gj", action="store_true",
                    help="time the GJ kernel on lc16's, cw16's seed's and "
                    "random n = 128 systems (bench.py's deck only beside "
                    "another run flag)")
    ap.add_argument("--floor", action="store_true",
                    help="write _var_floor/, this checkout with the wide "
                    "register body off, to name among the checkouts")
    ap.add_argument("--reps", type=int, default=3,
                    help="timed launches per checkout")
    ap.add_argument("--no-ptxas", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("roots", nargs="+")
    a = ap.parse_args()
    if a.one:
        newton = [m for m, on in (("rectifier", a.rectifier),
                                  ("physics", a.physics),
                                  ("nlstore", a.nlstore),
                                  ("lmdiode", a.lmdiode)) if on]
        linear = ((["store"] if a.store else [])
                  + (["magphys"] if a.magphys else [])
                  + (["rc"] if a.rc else []))
        if (a.gj or a.opdc or a.stamped) and not (newton or linear):
            modes = []
        elif newton and not linear:
            modes = newton
        else:
            modes = ["rlc"] + linear + newton
        time_checkout(os.path.abspath(a.roots[0]), modes, a.reps,
                      not a.no_ptxas, a.opdc, a.ac, a.stamped, a.gj)
        return 0
    if a.floor:
        floor_variant()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    extra = (["--reps", str(a.reps)]
             + (["--rectifier"] if a.rectifier else [])
             + (["--store"] if a.store else [])
             + (["--magphys"] if a.magphys else [])
             + (["--rc"] if a.rc else [])
             + (["--physics"] if a.physics else [])
             + (["--nlstore"] if a.nlstore else [])
             + (["--lmdiode"] if a.lmdiode else [])
             + (["--opdc"] if a.opdc else [])
             + (["--ac"] if a.ac else [])
             + (["--stamped"] if a.stamped else [])
             + (["--gj"] if a.gj else []))
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
