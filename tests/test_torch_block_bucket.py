"""The block bucket of the run, store, OP and DC sweep kernels (np1 past
64: a lane on a whole block of 256 threads, its system built and
eliminated in the block's slice, shared memory while it fits and a slice
of a workspace in device memory past it; ``csrc/newton.cuh``
``BLOCK_BUCKET``): decks the JAX package's kernels take and the port's
kernels now run, where they took the general engine before.

On the CPU (the kernels' plain versions, 2 lanes, numpy seeds), each held
to the JAX package's general engine called directly:

* a 62-stage RC ladder (np1 = 65) through ``make_tran_batch``: engine
  "run";
* TRANS_SMALL's secondary into a 60-section RC ladder (np1 = 67) under
  physics/trap, the live J-A core past 64 rows, engine "run";
* the DC sweep of a string of 64 diodes (np1 = 67) through
  ``run_dc_batch`` (engine "fused"), compat and physics.

``tests/test_torch_block_bucket_newton.py`` holds the Newton transient (a
ladder ending in a diode clamp), ``tests/test_torch_block_bucket_op.py``
that string's OP, ``tests/test_torch_past_nbig_tran.py`` the 127-stage ladder
(np1 = 130) on the run engine and on the general engine, and
``tests/test_torch_stream_past_caps.py`` the streamed store.

Tolerance: the standing bar.  ``accepted``, ``attempts``, ``fail`` and
``nr_iters`` equal per lane (a sweep's conv per point), and state, jv,
x and t_final within rtol 1e-9 of each leaf's largest value: both sides
compute in f64 and differ only in the order of their sums (~100 s on one
core, nearly all of it the JAX engine's compiles).

On the card (``needs_cuda``, skipped here) every instantiation of the
block bucket against its plain version at 259 lanes, bit for bit, in
shared memory and in the device-memory workspace, and ``run_bucket``
against the library's own choice:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_block_bucket.py -m needs_cuda

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
from test_torch_wide_bucket import (cockcroft_walton, diode_string,
                                   magnetic_ladder, rc_ladder)

LANES = 2


def clamped_ladder(stages, tstop="0.05m"):
    """An RC ladder of ``stages`` stages from a 5 V 1 kHz sine whose last
    node drives a diode into an RC load: np1 = stages + 4."""
    lines = [f"* {stages}-stage rc ladder into a diode clamp",
             f".tran 0.01m {tstop}", "Vin 1 0 SIN(0 5 1k)"]
    for k in range(1, stages + 1):
        lines += [f"R{k} {k} {k + 1} 10", f"C{k} {k + 1} 0 1n"]
    lines += [f"D1 {stages + 1} c DM", "Rc c 0 1k", "Cc c 0 10n",
              ".model DM D (Is=1e-14 Tt=5n)", ""]
    return "\n".join(lines)


def _port_tran(deck, cfg, params_np, **kw):
    cc = ts.compile_circuit(ts.parse(deck))
    fn = ts.make_tran_batch(cc, cfg, None, **kw)
    assert fn.engine == "run", fn.engine_reason
    assert run.run_bucket(run.make_plan(
        cc, physics=kw.get("semantics") == "physics")) == run.BLOCK_BUCKET
    return fn(params_from_numpy(params_np, device="cpu"),
              ts.init_state(cc, device="cpu"))


# ------------------------------------------------ on the CPU, against JAX


def test_rc_ladder_runs_on_the_block_bucket_and_matches_jax():
    from test_torch_general import jax_reference, spread
    from test_torch_run import assert_matches

    deck = rc_ladder(62)
    cc = ts.compile_circuit(ts.parse(deck))
    assert cc.np1 == 65
    assert run.run_placement(run.make_plan(cc)) == (run.BLOCK_BUCKET, True,
                                                    True)
    cfg, params_np, ref = jax_reference(deck, spread(deck, ("R", "C"),
                                                     lanes=LANES))
    out = _port_tran(deck, cfg, params_np)
    assert_matches(out, ref)
    np.testing.assert_allclose(out.dt_final.numpy(),
                               np.asarray(ref.dt_final), rtol=1e-9)
    assert not bool(out.fail.any())
    assert bool((out.t_final == cfg.tstop).all())


def r_draw(deck, seed):
    """The deck's R spread log-normally by 0.1 over LANES lanes."""
    cc = ts.compile_circuit(ts.parse(deck))
    r = np.asarray(cc.params["R"]["value"])
    return {"R": {"value": r[None] * np.exp(np.random.default_rng(
        seed).normal(0, 0.1, (LANES, len(r))))}}


def test_magnetic_ladder_physics_trap_matches_jax():
    from test_torch_physics_run import assert_physics_matches, reference

    deck = magnetic_ladder(False, 60, "0.2m")
    assert ts.compile_circuit(ts.parse(deck)).np1 == 67
    cfg, params_np, ref = reference(deck, r_draw(deck, 13), "trap")
    out = _port_tran(deck, cfg, params_np, semantics="physics",
                     opts=ts.SimOptions(integration="trap"))
    assert_physics_matches(out, ref, cfg)
    assert not bool(out.fail.any())


@pytest.mark.parametrize("semantics", ["compat", "physics"])
def test_diode_string_sweep_runs_on_the_dc_kernel_and_matches_jax(semantics):
    import jax
    import jax.numpy as jnp

    from toyspice_tpu.compiler import compile_circuit as jax_compile
    from toyspice_tpu.engine.batch import batch_params as jax_batch_params
    from toyspice_tpu.engine.dc import make_dc as jax_make_dc
    from toyspice_tpu.engine.state import init_state as jax_init_state
    from toyspice_tpu.netlist.parser import parse as jax_parse

    deck = diode_string(64)
    jcc = jax_compile(jax_parse(deck))
    params, axes = jax_batch_params(jcc, r_draw(deck, 5))
    pts = np.linspace(0.0, 40.0, 5)
    s0 = jax_init_state(jcc)
    xs_ref, conv_ref = jax.jit(jax.vmap(
        lambda p: jax_make_dc(jcc, (0,), semantics=semantics)(
            p, s0, jnp.asarray(pts)), in_axes=(axes,)))(params)
    params_np = {k: {kk: np.asarray(v) for kk, v in t.items()}
                 for k, t in params.items()}
    cc = ts.compile_circuit(ts.parse(deck))
    assert select_op_engine(cc, semantics)[0] == "fused"
    xs, conv = ts.run_dc_batch(cc, (0,), params_from_numpy(
        params_np, device="cpu"), None, pts, semantics=semantics)
    np.testing.assert_array_equal(conv.numpy(), np.asarray(conv_ref))
    assert bool(conv.all())
    want = np.asarray(xs_ref)
    np.testing.assert_allclose(xs.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


# the run kernel's bucket of each deck: the 64-row bucket to np1 = 64, the
# block bucket past it (ops/run.py run_bucket, csrc/run_kernel.cuh
# run_bucket; tests/test_torch_wide_bucket.py holds the Python mirror on
# the CPU), which the wrapper reads to pick the _wide library
BUCKETS = [(rc_ladder(61), 64), (rc_ladder(62), run.BLOCK_BUCKET),
           (rc_ladder(127), run.BLOCK_BUCKET),
           (rc_ladder(180), run.BLOCK_BUCKET)]
BUCKET_IDS = ["np1_64", "np1_65", "np1_130", "np1_183"]


def test_block_slices_leave_shared_memory_past_its_fit():
    """A block's slice of rc ladders of np1 = 130 and 183: the first fits
    the block's shared memory beside its table, the second takes the
    device-memory workspace, the table staying in shared memory (ops/run.py
    run_placement, csrc/newton.cuh block_place)."""
    for stages, shared in ((127, True), (180, False)):
        plan = run.make_plan(ts.compile_circuit(ts.parse(rc_ladder(stages))))
        assert run.run_placement(plan) == (run.BLOCK_BUCKET, True, shared)


# ----------------------------------------- on the card, against the plain


@pytest.mark.needs_cuda
@pytest.mark.parametrize("deck,bucket", BUCKETS, ids=BUCKET_IDS)
def test_run_bucket_is_the_library_s(cuda, deck, bucket):
    """ops/run.py run_bucket against the compat library's own choice, and
    the launch shape it reports: a block of 256 a lane past 64 rows, its
    slice in device memory when it outgrows shared memory."""
    from toyspice_tpu_torch.ops import _build

    plan = run.make_plan(ts.compile_circuit(ts.parse(deck)))
    assert _build.load("run").tsr_run_bucket(
        plan.np1, int(plan.topo.size), run.run_doubles(plan)) == bucket
    shape = run.segment_shape(plan, 259)
    if bucket == run.BLOCK_BUCKET:
        assert shape[:4] == (run.BLOCK_THREADS, 1, 259, run.BLOCK_THREADS)
        slice_ = run.block_slice(plan.np1, run.run_doubles(plan))
        _, table, shared = run.run_placement(plan)
        assert shape[5:] == (0 if shared else slice_, int(table))
        assert shape[4] == 8 * (run.table_doubles(plan) * table
                                + (slice_ if shared else 0))


def _run_case(deck, semantics="compat", trap=False, lanes=259):
    """(cfg, RunInputs) of a deck at ``lanes`` lanes on the card."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, lanes), device="cuda")
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device="cuda"),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    return cfg, r


CW32 = cockcroft_walton(32, "0.1m")
RUN_CASES = {
    "compat_linear_np1_65": (rc_ladder(62, "0.1m"), "compat", False),
    "physics_linear_np1_65": (rc_ladder(62, "0.1m"), "physics", True),
    "compat_linear_device_memory": (rc_ladder(180), "compat", False),
    "compat_newton_cw32": (CW32, "compat", False),
    "physics_be_cw32": (CW32, "physics", False),
    "physics_trap_cw32": (CW32, "physics", True),
    "physics_newton_device_memory": (clamped_ladder(180, "0.02m"),
                                     "physics", True),
    "compat_magnetic": (magnetic_ladder(False, 60, "0.2m"), "compat", False),
    "physics_magnetic_trap": (magnetic_ladder(False, 60, "0.2m"), "physics",
                              True),
    "compat_magnetic_newton": (magnetic_ladder(True, 60, "0.2m"), "compat",
                               False),
    "physics_magnetic_newton": (magnetic_ladder(True, 60, "0.2m"),
                                "physics", True),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", list(RUN_CASES))
def test_block_run_and_store_are_bit_identical(cuda, name):
    """The run kernel's and its store instantiation's block bucket, a block
    a lane, 259 lanes, against run_plain and store_plain bit for bit
    (counters, state, t, dt, jv, the stored rows)."""
    deck, semantics, trap = RUN_CASES[name]
    cfg, r = _run_case(deck, semantics, trap)
    assert run.run_bucket(r.plan) == run.BLOCK_BUCKET
    sc = r.sc._replace(max_attempts=400)
    ks, kw = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                 run.Store(cfg.tstart, cfg.max_store), r.jv)
    assert not ks.fail.any() and torch.equal(kw.out_n, ks.accepted)


@pytest.mark.needs_cuda
@pytest.mark.parametrize("stages", [62, 127])
def test_block_stream_stitch_is_bit_identical(cuda, stages):
    """An RC ladder streamed in chunks through the store instantiation's
    block bucket: each chunk's re-entry bit for bit with the plain store,
    and the chunks' rows stitched equal to one monolithic store launch."""
    cfg, r = _run_case(rc_ladder(stages))
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
    "op_cw32": (cockcroft_walton(32), "op", "compat"),
    "op_cw32_physics": (cockcroft_walton(32), "op", "physics"),
    "op_magnetic_diode": (magnetic_ladder(True, 60), "op", "compat"),
    "op_device_memory": (diode_string(180), "op", "physics"),
    "dc_diode_string_64": (diode_string(64), "dc", "compat"),
    "dc_diode_string_64_physics": (diode_string(64), "dc", "physics"),
    "dc_device_memory": (diode_string(180), "dc", "compat"),
}


@pytest.mark.needs_cuda
@pytest.mark.parametrize("name", list(OPDC_CASES))
def test_block_op_and_dc_sweep_are_bit_identical(cuda, name):
    """The OP and DC sweep kernels' block bucket, 259 lanes, against
    op_plain and dc_plain bit for bit (converged, stage, iterations, x and
    jv; conv, iterations and xs at every point), in shared memory and in
    the device-memory workspace."""
    deck, kind, semantics = OPDC_CASES[name]
    plan = run.make_plan(ts.compile_circuit(ts.parse(deck)), "op")
    lane = (op if kind == "op" else dc).lane_doubles(plan)
    assert run.fit_bucket(plan, lane) == run.BLOCK_BUCKET
    shape = op.segment_shape(plan, 259, lane)
    assert shape[0] == run.BLOCK_THREADS
    assert (shape[5] > 0) == ("device_memory" in name)
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


@pytest.mark.needs_cuda
def test_block_op_engine_is_the_op_kernel(cuda):
    """A 64-diode string takes the OP kernel (engine "fused"), one launch
    on the block bucket."""
    cc = ts.compile_circuit(ts.parse(diode_string(64)))
    assert cc.np1 == 67 and select_op_engine(cc)[0] == "fused"
    params, _ = ts.batch_params(cc, _rc_spread(cc, 259), device=cuda)
    before = op.launch_op_kernel.launches
    out = ts.run_op_batch(cc, params)
    torch.cuda.synchronize()
    assert op.launch_op_kernel.launches == before + 1
    assert bool(out.converged.all())
