"""On the card: the run, store, OP and DC sweep kernels on decks past
their former caps (more than 32 sources; a stamp plan past the 48 KB
table), every new flavour bit for bit with its plain version at 259 lanes:

* more than 32 sources in each bucket: 33 and 200 sources on np1 = 2
  (the 4-row bucket), 40 on np1 = 6, 14, 30 and 50 (the 8-, 16-, 32- and
  64-row buckets), the 48-line bus (np1 = 145, the block bucket); the
  physics instantiation on the 40-source np1 = 14 deck (trap), the
  magnetic ones on a transformer with 33 sources (compat K, physics K);
* the table in device memory: a bank of 1,700 resistors and one of 2,100
  diodes (np1 = 4, both the 64-row bucket: np1's own keeps the table in
  shared memory), the 101-stage CMOS ring (the block bucket, its slice in
  shared memory) and the 151-stage one (the table and the slice in device
  memory); the 101-stage NMOS ring past the former table cap, both in
  shared memory;
* the store with its stream in 3 chunks on the bus and on the NMOS ring;
* the OP and the DC sweep on the 72-cell PV module (73 sources), the
  diode bank, a resistor bank with a diode, the 151-stage CMOS ring's OP;
  the PV module's AC at 9 frequencies through the OP kernel's bias;
* each deck's launch shape from the libraries (``run.segment_shape``,
  ``op.segment_shape``) against the Python mirror of csrc/newton.cuh
  (``run.placement``).

Run on the card with ``python -m pytest --noconftest -p no:cacheprovider
tests/test_torch_cuda_past_caps.py``; every test skips without one."""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.ac import make_ac_batch
from toyspice_tpu_torch.engine.options import DEFAULTS
from toyspice_tpu_torch.ops import ac, dc, op, run

from test_torch_cuda import (_assert_dc_bits, _assert_op_bits,
                             _run_and_store_bits, _same_bits)
from test_torch_eligibility import _diode_bank, _many_sources
from test_torch_past_caps import (bus, cmos_ring, coupled_sources,
                                  many_sources, nmos_ring, pv_module,
                                  resistor_bank)

pytestmark = pytest.mark.needs_cuda
LANES = 259
B = run.BLOCK_BUCKET


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _spread(cc, lanes, seed=4):
    """R, C and the I sources' dc spread log-normally by 0.1."""
    rng = np.random.default_rng(seed)
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params[k]["value"]))))}
        for k in ("R", "C") if k in cc.params}
    if "I" in cc.params:
        dc_ = np.asarray(cc.params["I"]["dc"])
        ov["I"] = {"dc": dc_[None] * np.exp(rng.normal(0, 0.1, (
            lanes, len(dc_))))}
    return ov


def mirror_shape(plan, lane, rows, b):
    """The launch shape csrc/newton.cuh computes for b lanes with ``lane``
    doubles of a lane's own (a segment ``rows`` more): (W, lanes a block,
    blocks, threads, bytes of shared memory, doubles of a slice in device
    memory, table in shared memory)."""
    bucket, table, shared = run.placement(plan, lane, rows)
    tab = run.table_doubles(plan) * table
    if bucket == B:
        sl = run.block_slice(plan.np1, lane)
        return (256, 1, b, 256, 8 * (tab + sl * shared),
                0 if shared else sl, int(table))
    w = min(bucket, 32)
    seg = (bucket + 2) * (bucket + 1) + bucket + run.even(rows + lane)
    per = 128 // w
    if bucket == 64:
        per = 4
        while per > 1 and 8 * (tab + per * seg) > run.SEG_SMEM:
            per -= 1
    return (w, per, -(-b // per), per * w, 8 * (tab + per * seg), 0,
            int(table))


# (deck, semantics, trap, placement, attempts): the run kernel's flavours
RUNS = {
    "sources33_np1_2": (_many_sources(33), "compat", False, (4, True, True),
                        400),
    "sources200_np1_2": (_many_sources(200), "compat", False,
                         (4, True, True), 400),
    "sources40_np1_6": (many_sources(40, 6), "compat", False,
                        (8, True, True), 400),
    "sources40_np1_14": (many_sources(40, 14), "compat", False,
                         (16, True, True), 400),
    "sources40_np1_30": (many_sources(40, 30), "compat", False,
                         (32, True, True), 400),
    "sources40_np1_50": (many_sources(40, 50), "compat", False,
                         (64, True, True), 400),
    "bus48": (bus(48, "1n"), "compat", False, (B, True, True), 400),
    "physics_trap_sources40_np1_14": (many_sources(40, 14), "physics",
                                      True, (16, True, True), 400),
    "magnetic_sources33": (coupled_sources(33), "compat", False,
                           (8, True, True), 400),
    "physics_magnetic_sources33": (coupled_sources(33), "physics", True,
                                   (8, True, True), 400),
    "resistor_bank1700_table_in_memory": (resistor_bank(1700), "compat",
                                          False, (64, False, True), 100),
    "diode_bank2100_table_in_memory": (_diode_bank(2100), "compat", False,
                                       (64, False, True), 40),
    "nmos_ring101": (nmos_ring(101, "5n"), "compat", False, (B, True, True),
                     60),
    "cmos_ring101_slice_shared": (cmos_ring(101, "30p"), "compat", False,
                                  (B, False, True), 12),
    "cmos_ring151_both_in_memory": (cmos_ring(151, "30p"), "compat", False,
                                    (B, False, False), 12),
}


def _run_inputs(deck, semantics, trap, lanes=LANES):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _spread(cc, lanes), device="cuda")
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device="cuda"),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    return cfg, r


@pytest.mark.parametrize("name", list(RUNS))
def test_run_and_store_past_the_caps_are_bit_identical(cuda, name):
    """Each flavour through its launch shape (the library's, equal to the
    Python mirror) and against run_plain and store_plain bit for bit."""
    deck, semantics, trap, place, attempts = RUNS[name]
    cfg, r = _run_inputs(deck, semantics, trap)
    assert run.run_placement(r.plan) == place
    assert run.segment_shape(r.plan, LANES) == mirror_shape(
        r.plan, run.run_doubles(r.plan), run.SEG_ROWS, LANES)
    sc = r.sc._replace(max_attempts=attempts)
    ks, kw = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                 run.Store(cfg.tstart, cfg.max_store), r.jv)
    assert int(ks.accepted.sum()) > 0
    assert torch.equal(kw.out_n, ks.accepted)


@pytest.mark.parametrize("deck", [bus(48, "1n"), nmos_ring(101, "5n")],
                         ids=["bus48", "nmos_ring101"])
def test_stream_past_the_caps_is_bit_identical(cuda, deck):
    """The store streamed in chunks of a third of the rows: each chunk's
    re-entry bit for bit with the plain store, the rows stitched equal to
    one monolithic store launch."""
    cfg, r = _run_inputs(deck, "compat", False)
    whole, ww = run.launch_store_kernel(
        r.plan, r.dev, r.src, r.st, r.sc, run.Store(cfg.tstart,
                                                    cfg.max_store), r.jv)
    chunk = int(ww.out_n.max()) // 3 + 1
    keep = run.Store(cfg.tstart, chunk, True)
    start, st, jv, rows = run.fresh_start(LANES, r.sc, cuda), r.st, r.jv, []
    while True:
        k, w = _run_and_store_bits(r.plan, r.dev, r.src, st, r.sc, keep, jv,
                                   start=start)
        rows.append(w)
        if bool(((k.t >= cfg.tstop) | k.fail.bool()).all()):
            break
        start, st, jv = run.RunStart(k.t, k.dt, k.attempts), k.state, k.jv
    assert len(rows) >= 3
    assert torch.equal(k.attempts, whole.attempts)
    for lane in range(LANES):
        got = torch.cat([w.out_x[lane, :int(w.out_n[lane])] for w in rows])
        assert torch.equal(got, ww.out_x[lane, :int(ww.out_n[lane])])


# (deck, kind, placement of the OP or DC sweep launch)
OPDC = {
    "op_pv72": (pv_module(72), "op", (B, True, True)),
    "dc_pv72": (pv_module(72), "dc", (B, True, True)),
    "op_diode_bank2100": (_diode_bank(2100), "op", (64, False, True)),
    "dc_diode_bank2100": (_diode_bank(2100), "dc", (64, False, True)),
    "op_resistor_bank_diode": (resistor_bank(1700, True), "op",
                               (64, False, True)),
    "dc_resistor_bank_diode": (resistor_bank(1700, True), "dc",
                               (64, False, True)),
    "op_cmos_ring151": (cmos_ring(151), "op", (B, True, False)),
}


@pytest.mark.parametrize("name", list(OPDC))
def test_op_and_dc_past_the_caps_are_bit_identical(cuda, name):
    """The OP under its rescue ladders and the DC sweep (9 points of the
    first V source), one launch per rung or sweep, against op_plain and
    dc_plain bit for bit; the launch shape the library's and the
    mirror's."""
    deck, kind, place = OPDC[name]
    cc = ts.compile_circuit(ts.parse(deck))
    plan = run.make_plan(cc, "op")
    lane = (op if kind == "op" else dc).lane_doubles(plan)
    assert run.placement(plan, lane) == place
    assert op.segment_shape(plan, LANES, lane) == mirror_shape(
        plan, lane, 0, LANES)
    params, _ = ts.batch_params(cc, _spread(cc, LANES), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    if kind == "op":
        before = op.launch_op_kernel.launches
        k = op.make_op_fused(cc, DEFAULTS, solve=op.op_lanes)(params,
                                                             state0)
        torch.cuda.synchronize()
        assert op.launch_op_kernel.launches > before
        p = op.make_op_fused(cc, DEFAULTS, solve=op.op_plain)(params,
                                                             state0)
        _assert_op_bits(k, p)
        return
    pts = np.linspace(0.0, 40.0, 9)
    before = dc.launch_dc_kernel.launches
    k = dc.make_dc_fused(cc, (0,), DEFAULTS)(params, state0, pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    p = dc.make_dc_fused(cc, (0,), DEFAULTS, solve=dc.dc_plain)(
        params, state0, pts)
    _assert_dc_bits(k, p)


def test_pv72_ac_through_the_op_kernel_bias_is_bit_identical(cuda):
    """The PV module with an AC source in its load: make_ac_batch takes the
    OP kernel's bias and the AC kernel (engine "fused"); 9 frequencies,
    bit for bit with the plain OP and AC."""
    deck = pv_module(72, points=".ac DEC 3 1k 1meg").replace(
        "VLOAD out 0 DC 0", "VLOAD out 0 AC 1")
    cc = ts.compile_circuit(ts.parse(deck))
    params, axes = ts.batch_params(cc, _spread(cc, LANES), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    freqs = ts.frequency_points("DEC", 1e3, 1e6, 9)
    fn = make_ac_batch(cc, axes)
    assert fn.engine == "fused" and fn.bias_engine == "fused"
    before = (op.launch_op_kernel.launches, ac.launch_ac_kernel.launches)
    xr, xi, opr = fn(params, state0, freqs)
    torch.cuda.synchronize()
    assert op.launch_op_kernel.launches > before[0]
    assert ac.launch_ac_kernel.launches == before[1] + 1
    pr, pi, popr = make_ac_batch(cc, axes, op_solve=op.op_plain,
                                 ac_solve=ac.ac_plain)(params, state0, freqs)
    _assert_op_bits(opr, popr)
    assert _same_bits(xr, pr) and _same_bits(xi, pi)
    assert bool(opr.converged.all()) and bool(torch.isfinite(xr).all())
