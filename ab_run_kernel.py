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
it times the OP kernel's first launch on that rectifier (plain Newton from
the linear estimate), compat and physics, and the DC sweep kernel on
diode_iv_sweep.cir (35 points), 8192 lanes each, in place of the run
kernel: each rep is the mean of 20 back-to-back calls of the kernel's C
entry point on prepared buffers, so that the wrapper's host work does not
hide a launch that takes tens of microseconds.  ``--ac`` and ``--stamped``
add, beside bench.py's deck, the AC kernel on ce_amplifier_ac.cir's
8192 x 12 systems of 16 and the stamped solve on one batched Newton
iteration of cw16 (a 16-stage Cockcroft-Walton multiplier, np1 = 35,
8192 lanes: chip_smoke.py's general-engine main path), each captured
from its entry's call and timed the same way.  ``--gj`` times the GJ
kernel (``csrc/gj_kernel.cu``, the general engine's dense solve) on
lc16_ac_8192's 172,032 systems of 72 (a 16-section LC ladder's AC, built
by the general AC as chip_smoke.py phase 30 builds them), on cw16's OP
seed (8192 systems of 35) and on 8192 random systems of 96 and of 128,
each through its C entry and through ``launch_gj``; it builds and prints
``-Xptxas -v`` of the ``gj`` and ``stamped`` libraries only, and runs
bench.py's deck only beside another run flag.

    python3 ab_run_kernel.py _parent . . _parent
    python3 ab_run_kernel.py --gj _parent . . _parent
    python3 ab_run_kernel.py --store --magphys --rectifier _parent . . _parent
    python3 ab_run_kernel.py --ac --stamped _parent . . _parent
    python3 ab_run_kernel.py --rectifier --reps 10 _parent . . _parent
    python3 ab_run_kernel.py --physics --reps 10 . .
    python3 ab_run_kernel.py --rectifier --physics --nlstore --lmdiode \
        _parent . . _parent
    python3 ab_run_kernel.py --opdc --reps 10 _parent . . _parent

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


def time_op_dc(root, reps, calls=20):
    """The OP kernel's first launch of the rectifier's OP ladder, compat and
    physics, and the DC sweep kernel's one launch of diode_iv_sweep.cir,
    each captured from its entry's call; each rep times ``calls`` calls of
    the library's C entry point on the captured inputs."""
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.options import DEFAULTS
    from toyspice_tpu_torch.ops import _build, dc, op

    here = os.path.dirname(os.path.abspath(__file__))
    seen = {}

    def capture(kind, launch):
        def solve(*args):
            seen.setdefault(kind, args)
            return launch(*args)
        return solve

    def raw(fn, args):
        def many():
            for _ in range(calls):
                err = fn(*args)
            return err
        err, ms = event_ms(many, reps)
        if err != 0:
            raise SystemExit(f"{root}: launch failed: CUDA error {err}")
        return [m / calls for m in ms]

    stream = torch.cuda.current_stream().cuda_stream
    cc = ts.compile_circuit(ts.parse(rectifier_deck(here)))
    params, _ = spread_params(ts, cc)
    for semantics in ("compat", "physics"):
        seen.pop("op", None)
        op.make_op_fused(cc, DEFAULTS, semantics, solve=capture(
            "op", op.launch_op_kernel))(params, ts.init_state(cc))
        plan, dev, dyn, x0, jv0, sc = seen["op"]
        b = dev.shape[0]
        topo = torch.as_tensor(plan.topo, device=dev.device)
        x, jv = torch.empty_like(x0), torch.empty_like(jv0)
        iters = torch.empty(b, dtype=torch.int32, device=dev.device)
        conv = torch.empty(b, dtype=torch.int32, device=dev.device)
        ms = raw(_build.load("op").tsr_op, (
            plan.np1, topo.data_ptr(), int(plan.topo.size), dev.data_ptr(),
            dyn.data_ptr(), x0.data_ptr(), jv0.data_ptr(), x.data_ptr(),
            jv.data_ptr(), iters.data_ptr(), conv.data_ptr(), b,
            float(sc.reltol), float(sc.abstol), int(sc.max_iter),
            float(sc.gmin_floor), int(sc.physics), stream))
        print(f"{root}: OP kernel (half_wave_rectifier, {semantics}, {b} "
              f"lanes): Newton iterations {int(iters.sum())}, converged "
              f"{int(conv.sum())}, kernel ms {ms}", flush=True)

    cc = ts.compile_circuit(ts.parse(deck_text(here, "diode_iv_sweep.cir")))
    params, _ = spread_params(ts, cc, ("R",))
    d = cc.netlist.dc
    slot = (cc.names["V"].index(d.source1),)
    pts = ts.sweep_values(d.start1, d.stop1, d.increment1)
    dc.make_dc_fused(cc, slot, DEFAULTS, solve=capture(
        "dc", dc.launch_dc_kernel))(params, ts.init_state(cc), pts)
    plan, dev, dyn, vs, sc = seen["dc"]
    b, npts = dev.shape[0], vs.shape[-2]
    topo = torch.as_tensor(plan.topo, device=dev.device)
    xs = torch.empty((b, npts, plan.np1), dtype=torch.float64,
                     device=dev.device)
    iters = torch.empty((b, npts), dtype=torch.int32, device=dev.device)
    conv = torch.empty((b, npts), dtype=torch.int32, device=dev.device)
    ms = raw(_build.load("dc").tsr_dc_sweep, (
        plan.np1, topo.data_ptr(), int(plan.topo.size), dev.data_ptr(),
        dyn.data_ptr(), vs.data_ptr(),
        npts * plan.counts[3] if vs.ndim == 3 else 0, npts, xs.data_ptr(),
        iters.data_ptr(), conv.data_ptr(), b, float(sc.reltol),
        float(sc.abstol), int(sc.max_iter), float(sc.gmin_floor),
        int(sc.physics), stream))
    print(f"{root}: DC sweep kernel (diode_iv_sweep, {b} lanes x {npts} "
          f"points): Newton iterations {int(iters.sum())}, converged "
          f"{int(conv.sum())}, kernel ms {ms}", flush=True)


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
    """The AC kernel on ce_amplifier_ac.cir (8192 lanes, R and C spread)
    and the stamped solve on cw16's 40th batched Newton iteration (8192
    lanes, C spread: the transient's first attempts), each on the inputs
    its wrapper was called with."""
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.ac import make_ac_batch
    from toyspice_tpu_torch.engine.options import DEFAULTS
    from toyspice_tpu_torch.engine.tran import make_tran
    from toyspice_tpu_torch.ops import _build, ac, solve_stamped

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
        ms = entry_ms(root, _build.load("ac").tsr_ac, (
            n, b, nf, g.data_ptr(), bh.data_ptr(), r.data_ptr(),
            om.data_ptr(), x.data_ptr(), stream), reps)
        print(f"{root}: AC kernel (ce_amplifier_ac, {b} x {nf} systems of "
              f"{2 * n}): kernel ms {ms}", flush=True)
    if do_stamped:
        from chip_smoke import cockcroft_walton

        cc = ts.compile_circuit(ts.parse(cockcroft_walton(16)))
        tp = cc.netlist.tran
        cfg = ts.build_config(tp.tstart, 1e-4, tp.tstep, tp.tmax, tp.uic)
        params, _ = spread_params(ts, cc, ("C",))
        seen = []

        def capture(pat, vals, rvals, gmin):
            if len(seen) < 40:
                seen.append((pat, vals.clone(), rvals.clone(),
                             gmin.clone()))
            return solve_stamped.solve_lanes(pat, vals, rvals, gmin)

        make_tran(cc, cfg, store="none", solve=capture)(params,
                                                        ts.init_state(cc))
        pat, vals, rvals, gmin = seen[-1]
        b = vals.shape[0]
        tab = torch.as_tensor(pat.table, device=vals.device)
        x = torch.empty((b, pat.n), dtype=torch.float64, device=vals.device)
        ms = entry_ms(root, _build.load("stamped").tsr_stamped, (
            pat.n, tab.data_ptr(), int(pat.table.size), pat.nnz, pat.nrhs,
            vals.data_ptr(), rvals.data_ptr(), gmin.data_ptr(), x.data_ptr(),
            b, stream), reps)
        print(f"{root}: stamped solve (cw16, {b} systems of {pat.n}, "
              f"{int(pat.table[0])} terms): kernel ms {ms}", flush=True)


def time_gj(root, reps):
    """The GJ kernel on lc16_ac_8192's systems (8192 lanes, C spread, 21
    frequencies: 172,032 systems of 72), on cw16's OP seed (8192 systems
    of 35, C spread) and on 8192 random systems of 96 (the largest in
    registers) and of 128 (in shared memory), each captured from
    its caller (or made from one seed) and timed through the C entry
    (``calls`` calls a rep) and through ``launch_gj``; the first 16384
    systems of each are held to ``gj_plain`` bit for bit."""
    import numpy as np
    import torch

    import toyspice_tpu_torch as ts
    from toyspice_tpu_torch.engine.ac import make_ac
    from toyspice_tpu_torch.engine.op import make_op
    from toyspice_tpu_torch.ops import _build, solve
    from chip_smoke import cockcroft_walton, lc_ladder, same_bits

    stream = torch.cuda.current_stream().cuda_stream
    lib = _build.load("gj")

    def capture(run):
        seen = []

        def dense(a, b):
            seen.append((a, b))
            return solve.linear_solve(a, b)
        run(dense)
        return seen[0]

    def lc16(dense):
        cc = ts.compile_circuit(ts.parse(lc_ladder(16)))
        params, _ = spread_params(ts, cc, ("C",))
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

    for name, make, calls in (("lc16_ac_8192", lambda: capture(lc16), 5),
                              ("cw16 OP seed", lambda: capture(cw16), 20),
                              ("random n=96", lambda: random(96), 5),
                              ("random n=128", lambda: random(128), 5)):
        a, b = make()
        nsys, n = a.shape[0], a.shape[1]
        x = torch.empty((nsys, n), dtype=torch.float64, device=a.device)
        ms = entry_ms(root, lib.tsr_gj, (n, a.data_ptr(), b.data_ptr(),
                                         x.data_ptr(), nsys, stream), reps,
                      calls)
        _, wms = event_ms(lambda: solve.launch_gj(a, b), reps)
        k = min(nsys, 16384)
        bits = same_bits(x[:k], solve.gj_plain(a[:k], b[:k]))
        print(f"{root}: GJ kernel ({name}, {nsys} systems of {n}): kernel "
              f"ms {ms}, with launch_gj {wms}, the first {k} bit-identical "
              f"to gj_plain {bits}", flush=True)
        del a, b, x
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
        return time_op_dc(root, reps)
    for mode in modes:
        run_case(root, ts, run, run_plan, mode, reps)
    if do_ac or do_stamped:
        time_ac_stamped(root, reps, do_ac, do_stamped)
    if do_gj:
        time_gj(root, reps)


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
                    help="time the OP and DC sweep kernels instead of the "
                    "run kernel")
    ap.add_argument("--ac", action="store_true",
                    help="also time the AC kernel on ce_amplifier_ac.cir")
    ap.add_argument("--stamped", action="store_true",
                    help="also time the stamped solve on cw16's n = 35 "
                    "systems")
    ap.add_argument("--gj", action="store_true",
                    help="time the GJ kernel on lc16's, cw16's seed's and "
                    "random n = 128 systems (bench.py's deck only beside "
                    "another run flag)")
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
        if a.gj and not (newton or linear):
            modes = []
        elif newton and not linear:
            modes = newton
        else:
            modes = ["rlc"] + linear + newton
        time_checkout(os.path.abspath(a.roots[0]), modes, a.reps,
                      not a.no_ptxas, a.opdc, a.ac, a.stamped, a.gj)
        return 0
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
