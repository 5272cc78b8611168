"""The 64-row bucket of the run, store, OP and DC sweep kernels (np1 33 to
64: a lane's system on a whole warp, two rows a thread,
``csrc/newton.cuh`` ``Seg``): decks the JAX package's kernels take and
the port's kernels now run, where they took the general engine before.

On the CPU (the kernels' plain versions, 4 lanes, numpy seeds), each held
to the JAX package's general engine called directly:

* cw16, the 16-stage Cockcroft-Walton multiplier (np1 = 35, 32 diodes),
  cut to 0.1 ms, through ``make_tran_batch``: engine "run", compat and
  physics/trap;
* cw16's OP through ``run_op_batch`` (engine "fused", the OP kernel's
  plain version);
* the DC sweep of a string of 32 diodes (np1 = 35) through
  ``run_dc_batch`` (engine "fused");
* a 61-stage RC ladder, np1 = 64, the kernels' largest matrix, through
  ``make_tran_batch`` (engine "run").

Tolerance: the standing bar.  ``accepted``, ``attempts``, ``fail`` and
``nr_iters`` equal per lane (an OP's converged and stage, a sweep's conv
per point), and state, jv, x and t_final within rtol 1e-9 of each leaf's
largest value: both sides compute in f64 and differ only in the order of
their sums.

On the card (``needs_cuda``, skipped here) every instantiation of the
64-row bucket against its plain version at 259 lanes, bit for bit:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_wide_bucket.py -m needs_cuda

The JAX package is imported inside the CPU tests only, so that the file
imports on the card, which has no JAX.
"""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.convert import params_from_numpy
from toyspice_tpu_torch.engine.batch import select_op_engine
from toyspice_tpu_torch.engine.options import DEFAULTS
from toyspice_tpu_torch.ops import dc, op, run

from test_torch_cuda import (_assert_dc_bits, _assert_op_bits, _op_pair,
                             _rc_spread, _run_and_store_bits,
                             cuda)  # noqa: F401

RTOL = 1e-9
LANES = 4


def cockcroft_walton(stages, tstop="2m"):
    """A half-wave Cockcroft-Walton multiplier of ``stages`` stages: 2 ×
    stages diodes and capacitors, np1 = 2·stages + 3, a 100 V 1 kHz sine
    into a 10 MΩ load (tests/test_torch_general.py)."""
    lines = [f"* {stages}-stage half-wave Cockcroft-Walton multiplier",
             f".tran 5u {tstop}", "Vin a 0 SIN(0 100 1k)",
             "C1 a p1 100n", "D1 0 p1 DMOD", "D2 p1 s1 DMOD",
             "C2 0 s1 100n"]
    for k in range(2, stages + 1):
        lines += [f"C{2 * k - 1} p{k - 1} p{k} 100n",
                  f"D{2 * k - 1} s{k - 1} p{k} DMOD",
                  f"D{2 * k} p{k} s{k} DMOD",
                  f"C{2 * k} s{k - 1} s{k} 100n"]
    lines += [f"Rload s{stages} 0 10meg",
              ".model DMOD D (Is=1e-14 N=1.0 Cj0=2p Tt=5n)", ""]
    return "\n".join(lines)


def rc_ladder(stages, tstop="0.05m"):
    """An RC ladder of ``stages`` stages from a 1 kHz sine: np1 = stages +
    3."""
    lines = [f"* {stages}-stage rc ladder", f".tran 0.01m {tstop}",
             "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 1n"]
    return "\n".join(lines) + "\n"


def diode_string(count):
    """``count`` diodes in series from a swept source through 1 kΩ: np1 =
    count + 3."""
    lines = ["* diode string", ".dc V1 0 40 10", "V1 1 0 DC 20",
             "R1 1 2 1k"]
    lines += [f"D{k} {k + 2} {k + 3} DM" for k in range(count - 1)]
    lines += [f"D{count - 1} {count + 1} 0 DM", ".model DM D (Is=1e-14)",
              ""]
    return "\n".join(lines)


def magnetic_ladder(diode=False, sections=28, tstop="1m"):
    """A small J-A transformer whose secondary feeds an RC ladder of
    ``sections`` sections (np1 = sections + 7), with ``diode`` a diode and
    an RC load at its end (np1 = sections + 8), to ``tstop``: 28 sections
    (np1 = 35, 36) take the 64-row bucket's magnetic instantiations."""
    lines = ["* J-A transformer into an rc ladder", f".tran 20u {tstop}",
             "Vin 1 0 sin(0 10 1k)", "Rp 1 2 0.5",
             "Lp 2 0 core=C1 turns=300", "Ls 3 0 core=C1 turns=150",
             "K1 Lp Ls 0.95", "Rl1 3 m1 20", "Cl1 m1 0 10n"]
    for k in range(2, sections + 1):
        lines += [f"Rl{k} m{k - 1} m{k} 20", f"Cl{k} m{k} 0 10n"]
    end = f"m{sections}"
    lines += ([f"D1 {end} d DMOD", "Rload d 0 1k", "Cload d 0 10u",
               ".model DMOD D(IS=1e-14)"] if diode
              else [f"Rload {end} 0 1000"])
    lines += [".model C1 core(ms=1.6e6 alpha=1e-3 a=1000 c=0.1 k=2000 "
              "area=1e-4 len=0.1)", ""]
    return "\n".join(lines)


def parallel_mosfets(count):
    """``count`` diode-connected NMOS in parallel behind 1 kΩ (np1 = 4):
    their value slots overflow the 4-row bucket's block of 32 lanes, so
    the run kernel takes the 64-row bucket."""
    lines = ["* diode-connected nmos", ".tran 1u 20u",
             "V1 1 0 SIN(3 2 100k)", "R1 1 2 1k", "C1 2 0 1n"]
    lines += [f"M{k} 2 2 0 0 NM L=2u W={10 + k}u" for k in range(count)]
    lines += [".model NM NMOS(Vto=1 Kp=2e-5)", ""]
    return "\n".join(lines)


CW16 = cockcroft_walton(16, "0.1m")


def _port_tran(deck, cfg, params_np, **kw):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None, **kw)
    assert fn.engine == "run", fn.engine_reason
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


# ------------------------------------------------ on the CPU, against JAX


def test_cw16_runs_on_the_run_kernel_and_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches
    from test_torch_run_nonlinear import assert_jv_matches

    cc = ts.compile_circuit(ts.parse(CW16))
    assert cc.np1 == 35 and cc.kind_count("D") == 32
    assert run.run_placement(run.make_plan(cc)) == (64, True, True)
    cfg, params_np, ref = jax_reference(CW16, spread(CW16, ("C",)))
    out = _port_tran(CW16, cfg, params_np)
    assert_matches(out, ref)
    assert_jv_matches(out, ref)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())


def test_cw16_physics_trap_runs_on_the_run_kernel_and_matches_jax():
    from test_torch_physics_run import (assert_physics_matches, reference,
                                        spread)

    cfg, params_np, ref = reference(CW16, spread(CW16, ("C",), LANES),
                                    "trap")
    out = _port_tran(CW16, cfg, params_np, semantics="physics",
                     opts=ts.SimOptions(integration="trap"))
    assert_physics_matches(out, ref, cfg)
    assert not bool(out.fail.any())


def test_cw16_op_runs_on_the_op_kernel_and_matches_jax():
    from test_torch_op import assert_matches, reference

    cc = ts.compile_circuit(ts.parse(CW16))
    assert select_op_engine(cc)[0] == "fused"
    c = np.asarray(cc.params["C"]["value"])
    draw = {"C": {"value": c[None] * np.exp(np.random.default_rng(3).normal(
        0, 0.1, (LANES, len(c))))}}
    params_np, ref = reference(CW16, draw)
    out = ts.run_op_batch(cc, params_from_numpy(params_np, device="cpu"))
    assert_matches(out, ref)
    assert bool(out.converged.all())


def test_diode_string_sweep_runs_on_the_dc_kernel_and_matches_jax():
    import jax
    import jax.numpy as jnp

    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine.batch import batch_params as jax_batch_params
    from toyspice_tpu.engine.dc import make_dc as jax_make_dc
    from toyspice_tpu.engine.state import init_state as jax_init_state
    from toyspice_tpu.netlist.parser import parse as jax_parse

    deck = diode_string(32)
    jcc = jax_compile(jax_parse(deck))
    r = np.asarray(jcc.params["R"]["value"])
    params, axes = jax_batch_params(jcc, {"R": {"value": r[None] * np.exp(
        np.random.default_rng(5).normal(0, 0.1, (LANES, len(r))))}})
    pts = np.linspace(0.0, 40.0, 5)
    s0 = jax_init_state(jcc)
    xs_ref, conv_ref = jax.jit(jax.vmap(
        lambda p: jax_make_dc(jcc, (0,))(p, s0, jnp.asarray(pts)),
        in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 35 and cc.kind_count("D") == 32
    assert select_op_engine(cc)[0] == "fused"
    xs, conv = ts.run_dc_batch(cc, (0,), params_from_numpy(
        params_np, device="cpu"), None, pts)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    want = np.asarray(xs_ref)
    np.testing.assert_allclose(xs.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_rc_ladder_at_the_largest_matrix_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches

    deck = rc_ladder(61)
    assert ts.compile_circuit(ts.parse(deck)).np1 == run.WARP_NP1 == 64
    cfg, params_np, ref = jax_reference(deck, spread(deck, ("R", "C")))
    out = _port_tran(deck, cfg, params_np)
    assert_matches(out, ref)
    assert not bool(out.fail.any())


# the run kernel's bucket of each deck: np1's, or the 64-row one when the
# value slots of np1's block of lanes overflow its shared memory (the
# MOSFET bank past 25 devices), or past 64 rows the block bucket, which the
# wrapper reads to pick the _wide library (ops/run.py run_bucket,
# csrc/run_kernel.cuh run_bucket)
BUCKETS = [(rc_ladder(29), 32), (rc_ladder(61), 64), (CW16, 64),
           (parallel_mosfets(24), 4), (parallel_mosfets(25), 4),
           (parallel_mosfets(26), 64),
           (rc_ladder(62), run.BLOCK_BUCKET),
           (rc_ladder(127), run.BLOCK_BUCKET),
           (rc_ladder(180), run.BLOCK_BUCKET)]
BUCKET_IDS = ["ladder_np1_32", "ladder_np1_64", "cw16", "mosfets_24",
              "mosfets_25", "mosfets_26", "ladder_np1_65", "ladder_np1_130",
              "ladder_np1_183"]


@pytest.mark.parametrize("deck,bucket", BUCKETS, ids=BUCKET_IDS)
def test_run_bucket(deck, bucket):
    plan = run.make_plan(ts.compile_circuit(ts.parse(deck)))
    assert run.run_bucket(plan) == bucket


# ----------------------------------------- on the card, against the plain


@pytest.mark.needs_cuda
@pytest.mark.parametrize("deck,bucket", BUCKETS, ids=BUCKET_IDS)
def test_run_bucket_is_the_library_s(cuda, deck, bucket):
    """ops/run.py run_bucket against the compat library's own choice."""
    from toyspice_tpu_torch.ops import _build

    plan = run.make_plan(ts.compile_circuit(ts.parse(deck)))
    assert _build.load("run").tsr_run_bucket(
        plan.np1, int(plan.topo.size), run.run_doubles(plan)) == bucket


def _run_case(deck, semantics="compat", trap=False):
    """(cfg, RunInputs) of a deck at 259 lanes on the card, a linear deck
    as a Newton one's (make_tran_run's rows)."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 259), device="cuda")
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device="cuda"),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    return cfg, r


RUN_CASES = {
    "compat_linear_np1_64": (rc_ladder(61, "0.1m"), "compat", False),
    "compat_newton_cw16": (CW16, "compat", False),
    "physics_be_cw16": (CW16, "physics", False),
    "physics_trap_cw16": (CW16, "physics", True),
    "compat_magnetic": (magnetic_ladder(), "compat", False),
    "physics_magnetic_trap": (magnetic_ladder(), "physics", True),
    "compat_magnetic_newton": (magnetic_ladder(True), "compat", False),
    "physics_magnetic_newton": (magnetic_ladder(True), "physics", False),
    "promoted_np1_4": (parallel_mosfets(30), "compat", False),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", list(RUN_CASES))
def test_wide_run_and_store_are_bit_identical(cuda, name):
    """The run kernel's and its store instantiation's 64-row bucket on a
    whole warp a lane, 259 lanes, against run_plain and store_plain bit
    for bit (counters, state, t, dt, jv, the stored rows)."""
    deck, semantics, trap = RUN_CASES[name]
    cfg, r = _run_case(deck, semantics, trap)
    shape = run.segment_shape(r.plan, 259)
    assert shape[0] == 32 and 1 <= shape[1] <= 4, shape
    sc = r.sc._replace(max_attempts=400)
    ks, kw = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                 run.Store(cfg.tstart, cfg.max_store), r.jv)
    assert not ks.fail.any() and torch.equal(kw.out_n, ks.accepted)


@pytest.mark.needs_cuda
def test_wide_stream_stitch_is_bit_identical(cuda):
    """cw16 streamed in chunks through the store instantiation's 64-row
    bucket: each chunk's re-entry bit for bit with the plain store, and
    the chunks' rows stitched equal to one monolithic store launch."""
    cfg, r = _run_case(CW16)
    whole, ww = run.launch_store_kernel(
        r.plan, r.dev, r.src, r.st, r.sc, run.Store(cfg.tstart,
                                                    cfg.max_store), r.jv)
    chunk = int(ww.out_n.max()) // 3 + 1
    keep = run.Store(cfg.tstart, chunk, True)
    start, st, jv, rows = run.fresh_start(259, r.sc, cuda), r.st, r.jv, []
    while True:
        k, w = _run_and_store_bits(r.plan, r.dev, r.src, st, r.sc, keep, jv,
                                   start=start)
        rows.append(w)
        if bool(((k.t >= cfg.tstop) | k.fail.bool()).all()):
            break
        start, st, jv = run.RunStart(k.t, k.dt, k.attempts), k.state, k.jv
    assert len(rows) >= 3
    assert torch.equal(k.attempts, whole.attempts)
    for lane in range(259):
        got = torch.cat([w.out_x[lane, :int(w.out_n[lane])] for w in rows])
        assert torch.equal(got, ww.out_x[lane, :int(ww.out_n[lane])])


OPDC_CASES = {
    "op_cw16": (cockcroft_walton(16), "op", "compat"),
    "op_cw16_physics": (cockcroft_walton(16), "op", "physics"),
    "op_magnetic_diode": (magnetic_ladder(True), "op", "compat"),
    "dc_diode_string_32": (diode_string(32), "dc", "compat"),
    "dc_diode_string_32_physics": (diode_string(32), "dc", "physics"),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", list(OPDC_CASES))
def test_wide_op_and_dc_sweep_are_bit_identical(cuda, name):
    """The OP and DC sweep kernels' 64-row bucket, 259 lanes, against
    op_plain and dc_plain bit for bit (converged, stage, iterations, x and
    jv; conv, iterations and xs at every point)."""
    deck, kind, semantics = OPDC_CASES[name]
    plan = run.make_plan(ts.compile_circuit(ts.parse(deck)), "op")
    lane = (op if kind == "op" else dc).lane_doubles(plan)
    assert op.segment_shape(plan, 259, lane)[0] == 32
    if kind == "op":
        k, p, _ = _op_pair(deck, 259, cuda, semantics)
        _assert_op_bits(k, p)
        assert bool(k.converged.all())
        return
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, _rc_spread(cc, 259), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    pts = np.linspace(0.0, 40.0, 9)
    before = dc.launch_dc_kernel.launches
    k = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics)(params, state0, pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    p = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics, solve=dc.dc_plain)(
        params, state0, pts)
    _assert_dc_bits(k, p)
    assert bool(k.conv.all())
