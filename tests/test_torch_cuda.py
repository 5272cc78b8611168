"""The CUDA kernels (the whole-run transient with and without the waveform
store, compat and physics, magnetic decks included, the OP, the stamped
solve, the DC sweep and the AC solve) against their plain torch versions
on the card.

Needs a CUDA card and nvcc; skips elsewhere.  On the card, without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.ac import make_ac_batch
from toyspice_tpu_torch.engine.options import DEFAULTS
from toyspice_tpu_torch.engine.op import make_op
from toyspice_tpu_torch.models import magnetic
from toyspice_tpu_torch.ops import ac, dc, op, run, run_plan, solve_stamped

pytestmark = pytest.mark.needs_cuda

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""

IPWL = """* isrc pwl into rc ladder
.tran 0.02m 1m
I1 0 1 PWL(0 0 0.2m 3m 0.5m 1m)
R1 1 0 1k
C1 1 0 0.2u
C2 1 2 0.1u
R2 2 0 2k
"""

CSERIES = """* capacitor chain
.tran 0.02m 1m
Vin 1 0 SIN(0 5 1k)
R1 1 0 1k
C1 1 2 1u
C2 2 0 1u
"""


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _inputs(deck, lanes, device, edit=None):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(4)
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params[k]["value"]))))}
        for k in ("R", "L", "C") if k in cc.params}
    if edit:
        edit(ov)
    params, _ = ts.batch_params(cc, ov, device=device)
    state0 = ts.init_state(cc, device=device)
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, lanes, device)
    src = run_plan.source_stack(plan, params, lanes, device)
    st = run_plan.init_state_stack(plan, state0, lanes, device)
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    return cc, cfg, params, state0, plan, dev, src, st, sc


def _assert_same(k, p):
    """Integers equal; floats within 1e-9 of the largest finite value,
    non-finite where the plain version is."""
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.float64:
            fin = b.isfinite()
            assert torch.equal(a.isfinite(), fin)
            assert torch.equal(a.isnan(), b.isnan())
            scale = b.abs()[fin].amax().clamp_min(1e-300) if fin.any() \
                else 1.0
            assert bool(((a - b).abs()[fin] <= 1e-9 * scale).all())
        else:
            assert torch.equal(a, b)


@pytest.mark.parametrize("deck,lanes,max_attempts", [
    (IPWL, 64, None), (RLC, 256, 3000)], ids=["ipwl", "rlc_3000"])
def test_kernel_matches_plain(cuda, deck, lanes, max_attempts):
    *_, plan, dev, src, st, sc = _inputs(deck, lanes, cuda)
    if max_attempts:
        sc = sc._replace(max_attempts=max_attempts)
    before = run.launch_run_kernel.launches
    k = run.launch_run_kernel(plan, dev, src, st, sc)
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == before + 1
    _assert_same(k, run.run_plain(plan, dev, src, st, sc))


def test_sin_phase_lanes_match_plain(cuda):
    """Per-lane SIN phases: the phase's division by 180 rounds alike in the
    kernel and its plain version."""
    def phases(ov):
        ov["V"] = {"phase": np.random.default_rng(8).uniform(-90, 90,
                                                             (32, 1))}

    deck = RLC.replace(".tran 0.01m 2ms", ".tran 0.01m 0.2ms")
    *_, plan, dev, src, st, sc = _inputs(deck, 32, cuda, phases)
    k = run.launch_run_kernel(plan, dev, src, st, sc)
    _assert_same(k, run.run_plain(plan, dev, src, st, sc))


def test_zero_pivot_and_nan_lanes_end_failed(cuda):
    def zero_caps(ov):
        ov["C"]["value"][1] = 0.0

    *_, plan, dev, src, st, sc = _inputs(CSERIES, 4, cuda, zero_caps)
    k = run.launch_run_kernel(plan, dev, src, st, sc)
    _assert_same(k, run.run_plain(plan, dev, src, st, sc))
    assert k.fail.tolist() == [0, 1, 0, 0]
    # minstep NaN: the lanes run on as the general engine's loop does; the
    # capacitors' C/dt goes NaN, so the first solve fails at "minstep"
    nan = sc._replace(minstep=float("nan"))
    k = run.launch_run_kernel(plan, dev, src, st, nan)
    _assert_same(k, run.run_plain(plan, dev, src, st, nan))
    assert k.fail.tolist() == [1] * 4 and k.attempts.tolist() == [1] * 4


def test_main_path_launches_the_kernel_once(cuda):
    cc, cfg, params, state0, *_ = _inputs(IPWL, 32, cuda)
    fn = ts.make_tran_batch(cc, cfg, None, store="none")
    before = run.launch_run_kernel.launches
    out = fn(params, state0)
    assert run.launch_run_kernel.launches == before + 1
    assert fn.engine == "run" and out.t_final.is_cuda
    assert not out.fail.any()


HWR = """Half-wave rectifier with smoothing cap
.tran 10u 2m
Vac ac 0 SIN(0 6 1k)
Dr ac dcout DFAST
Rload dcout 0 2.7k
Csmooth dcout 0 4.7u
.model DFAST D (Is=2e-14 N=1.05 Cj0=4p Tt=5n)
"""

NMOS_INV = """NMOS inverter switching a capacitive load
.tran 1u 0.4m
Vdd vdd 0 DC 5
Vg gate 0 PULSE(0 5 20u 1u 1u 80u 200u)
Rpull vdd drain 10k
Mn drain gate 0 0 NSW
Cload drain 0 10p
.model NSW NMOS (VTO=1.1 KP=3m LAMBDA=0.01)
"""

BJT_TRAN = """* CE amplifier transient
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

# PMOS of levels 2 and 3 and a PNP, for the device branches the decks
# above leave out
MIXED_OP = """* mixed polarities and levels
.op
Vdd vdd 0 DC 5
Vin in 0 DC 2.2
Mp out in vdd vdd PM2 L=2u W=20u
Mn out in 0 0 NM3 L=2u W=10u
Mq q in vdd vdd PM3 L=1u W=8u
Rq q 0 20k
Q1 0 out e QP
Re vdd e 10k
.model PM2 PMOS(Level=2 VTO=-0.8 KP=15u UCRIT=1e4 UEXP=0.1)
.model NM3 NMOS(Level=3 VTO=0.7 KP=30u THETA=0.05 KAPPA=0.3)
.model PM3 PMOS(Level=3 VTO=-0.7 KP=20u THETA=0.05 DELTA=0.5)
.model QP PNP(Bf=100)
"""

HARD_V = """diode stack
.op
V1 1 0 DC 100
D1 1 2 DM
D2 2 3 DM
D3 3 0 DM
.model DM D (Is=1e-15 N=1.0)
"""


def _rc_spread(cc, lanes, seed=4):
    rng = np.random.default_rng(seed)
    return {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params[k]["value"]))))}
        for k in ("R", "C") if k in cc.params}


@pytest.mark.parametrize("deck", [HWR, NMOS_INV, BJT_TRAN],
                         ids=["diode", "mosfet", "bjt"])
def test_nonlinear_kernel_matches_plain(cuda, deck):
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 64), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    plan = run_plan.make_plan(cc)
    dev = run_plan.const_stack(plan, params, 64, cuda, DEFAULTS.temp, state0)
    src = run_plan.source_stack(plan, params, 64, cuda)
    st = run_plan.init_state_stack(plan, state0, 64, cuda)
    sc = run.RunScalars(cfg.tstop, cfg.minstep, cfg.tmax, 7.0,
                        cfg.max_attempts)
    opr = op.make_op_fused(cc, DEFAULTS)(params, state0)
    jv0 = run_plan.jv_stack(plan, opr.jv, 64)
    k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
    torch.cuda.synchronize()
    _assert_same(k, run.run_plain(plan, dev, src, st, sc, jv0))
    assert not k.fail.any() and bool((k.nr_iters > k.attempts).all())


@pytest.mark.parametrize("deck,ov", [
    (MIXED_OP, lambda cc, b: {"V": {"dc": np.stack(
        [np.full(b, 5.0), np.linspace(0.5, 4.5, b)], axis=1)}}),
    (HARD_V, lambda cc, b: {"V": {"dc": np.linspace(2.0, 100.0, b)[:, None]}}),
], ids=["levels_polarities", "rescue_ladder"])
def test_op_kernel_matches_plain(cuda, deck, ov):
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, ov(cc, 32), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    before = op.launch_op_kernel.launches
    k = op.make_op_fused(cc, DEFAULTS, solve=op.op_lanes)(params, state0)
    launched = op.launch_op_kernel.launches - before
    p = op.make_op_fused(cc, DEFAULTS, solve=op.op_plain)(params, state0)
    assert op.launch_op_kernel.launches - before == launched >= 1
    _assert_op_bits(k, p)


def test_nonlinear_main_path_launches_both_kernels(cuda):
    cc = ts.compile_circuit(ts.parse(HWR))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 32), device=cuda)
    fn = ts.make_tran_batch(cc, cfg, None, store="none")
    r0, o0 = run.launch_run_kernel.launches, op.launch_op_kernel.launches
    out = fn(params, ts.init_state(cc, device=cuda))
    assert run.launch_run_kernel.launches == r0 + 1
    assert op.launch_op_kernel.launches >= o0 + 1
    assert fn.engine == "run" and out.jv["D"]["vd"].is_cuda
    assert not out.fail.any()


def _assert_close(k, p):
    """Equal non-finite pattern; finite values within 1e-9 of the largest
    finite |value| of the plain version."""
    assert torch.equal(k.isnan(), p.isnan())
    fin = p.isfinite()
    assert torch.equal(k.isfinite(), fin)
    if fin.any():
        assert bool(((k - p).abs()[fin]
                     <= 1e-9 * p.abs()[fin].amax()).all())


DIVIDER = """Resistive divider bias check
.op
Vsrc in 0 DC 12
Ra in mid 4.7k
Rb mid 0 2.2k
"""

OPEN_NODE = """* current source into a resistor that may be open
.op
V1 1 0 DC 5
R1 1 2 1k
R2 2 0 2k
L1 2 4 1m
C1 4 0 1u
I1 0 3 DC 1m
R3 3 0 1k
"""


@pytest.mark.parametrize("n", [3, 12, 30])
def test_stamped_kernel_matches_plain_on_random_patterns(cuda, n):
    """Duplicate cells, RHS entries, entries into the ground row, and a
    zero column on some lanes (a poisoned row); NMAX 8, 16 and 32."""
    rng = np.random.default_rng(n)
    nnz, nrhs, b = 6 * n, 2 * n, 96
    rows = rng.integers(0, n, nnz)
    cols = rng.integers(0, n, nnz)
    rows[:n], cols[:n] = np.arange(n), np.arange(n)  # a diagonal
    rrows = rng.integers(0, n, nrhs)
    vals = torch.as_tensor(rng.normal(size=(b, nnz)), device=cuda)
    vals[:8, :n] = 0.0
    vals[:8, n:][:, (cols[n:] == 1)] = 0.0
    vals[:8, :n][:, 1] = 0.0
    rvals = torch.as_tensor(rng.normal(size=(b, nrhs)), device=cuda)
    gmin = torch.as_tensor(np.where(np.arange(b) % 3 == 0, 0.0, 1e-3),
                           device=cuda)
    pat = solve_stamped.StampPattern(n, rows, cols, rrows)
    before = solve_stamped.launch_stamped.launches
    k = solve_stamped.launch_stamped(pat, vals, rvals, gmin)
    torch.cuda.synchronize()
    assert solve_stamped.launch_stamped.launches == before + 1
    _assert_close(k, solve_stamped.solve_plain(pat, vals, rvals, gmin))


def test_linear_op_through_the_stamped_kernel(cuda):
    cc = ts.compile_circuit(ts.parse(OPEN_NODE))
    r = np.asarray(cc.params["R"]["value"])
    rv = np.repeat(r[None], 16, axis=0) * np.exp(
        np.random.default_rng(3).normal(0, 0.1, (16, len(r))))
    rv[::4, 2] = np.inf
    params, _ = ts.batch_params(cc, {"R": {"value": rv}}, device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    before = solve_stamped.launch_stamped.launches
    k = ts.run_op_batch(cc, params)
    assert solve_stamped.launch_stamped.launches == before + 1
    p = make_op(cc, solve=solve_stamped.solve_plain)(params, state0)
    assert torch.equal(k.converged, p.converged)
    assert torch.equal(k.stage, p.stage)
    assert k.stage.tolist() == [2, 0, 0, 0] * 4
    _assert_close(k.x, p.x)


DIODE_IV = """Diode I-V curve via DC sweep
.dc Vb 0.2 0.9 0.02
Vb anode 0 DC 0.2
Rsen anode d 10
Dut d 0 DIV
.model DIV D (Is=5e-15 N=1.1)
"""

MOS_DC = """* MOSFET gate sweep, levels 2 and 3 and a PMOS load
.dc VG 0 4 0.25
VDD 1 0 DC 5
VG 2 0 DC 0
Mp 3 2 1 1 PM2 L=2u W=20u
Mn 3 2 0 0 NM3 L=2u W=10u
RL 3 0 100k
.model PM2 PMOS(Level=2 VTO=-0.8 KP=15u UCRIT=1e4 UEXP=0.1)
.model NM3 NMOS(Level=3 VTO=0.7 KP=30u THETA=0.05 KAPPA=0.3)
"""


@pytest.mark.parametrize("deck,nested,batched_v", [
    (DIODE_IV, False, False), (DIODE_IV, False, True),
    (MOS_DC, True, False)], ids=["diode", "diode_batched_v", "mos_nested"])
def test_dc_kernel_matches_plain(cuda, deck, nested, batched_v):
    cc = ts.compile_circuit(ts.parse(deck))
    ov = _rc_spread(cc, 64)
    if batched_v:  # a per-lane table of source values
        ov["V"] = {"dc": np.full((64, 1), 0.2)}
    params, _ = ts.batch_params(cc, ov, device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    slots = (cc.names["V"].index(d.source1),)
    if nested:
        pts = np.array([(a, b) for a in (3.0, 5.0) for b in pts])
        slots = (cc.names["V"].index("VDD"),) + slots
    before = dc.launch_dc_kernel.launches
    k = dc.make_dc_fused(cc, slots, DEFAULTS)(params, state0, pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    p = dc.make_dc_fused(cc, slots, DEFAULTS, solve=dc.dc_plain)(
        params, state0, pts)
    _assert_dc_bits(k, p)
    if not nested:
        assert bool(k.conv.all())
    else:  # the general engine converges on the first 20 of the 34 points
        # of this sweep's first 4 lanes and no later one
        # (test_torch_dc.py::test_level23_cmos_sweep[nested])
        assert bool(k.conv[:4, :20].all()) and not bool(k.conv[:4, 20:].any())
        assert abs(k.conv.double().mean().item() - 20 / 34) < 0.02


@pytest.mark.parametrize("np1", [5, 12, 30])
def test_ac_kernel_matches_plain(cuda, np1):
    """N2MAX 16, 32 and 64; a zero B^ on one instance and a singular G on
    another."""
    rng = np.random.default_rng(np1)
    b = 40
    g = rng.normal(size=(b, np1, np1)) + 4 * np.eye(np1)
    g[1] = 0.0
    bh = rng.normal(size=(b, np1, np1)) * 1e-6
    bh[2] = 0.0
    r = rng.normal(size=(b, 2 * np1))
    freqs = np.array([10.0, 1e3, 1e5, 1e7])
    args = [torch.as_tensor(v, device=cuda) for v in (g, bh, r)]
    before = ac.launch_ac_kernel.launches
    k = ac.ac_solve_batch(*args, freqs)
    torch.cuda.synchronize()
    assert ac.launch_ac_kernel.launches == before + 1
    _assert_close(k, ac.ac_solve_batch(*args, freqs, solve=ac.ac_plain))


def _same_bits(a, b):
    """torch.equal, with NaN equal to NaN."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.where(torch.isnan(a), 0.0, a),
                            torch.where(torch.isnan(b), 0.0, b)))


def _assert_op_bits(k, p):
    """An OP through make_op_fused against its plain version: converged,
    stage and the iteration counts equal, x and every jv leaf bit for
    bit."""
    for key in ("converged", "stage", "iters", "iters_all"):
        assert torch.equal(getattr(k, key), getattr(p, key)), key
    assert _same_bits(k.x, p.x)
    for kd in p.jv:
        for key in p.jv[kd]:
            assert _same_bits(k.jv[kd][key], p.jv[kd][key]), (kd, key)


def _assert_dc_bits(k, p):
    """A DC sweep against its plain version: conv and iterations equal
    per point, xs bit for bit."""
    assert torch.equal(k.conv, p.conv) and torch.equal(k.iters, p.iters)
    assert _same_bits(k.xs, p.xs)


@pytest.mark.parametrize("np1", [2, 8, 9, 16, 17, 32])
def test_ac_warp_kernel_is_bit_identical(cuda, np1):
    """The AC kernel (a warp segment per system) at every bucket edge:
    16 lanes and registers to 2np1 = 16, 32 lanes to 32, shared memory to
    64; 43 instances x 3 frequencies (not a multiple of a block's systems),
    with a tie in |pivot|, a zero pivot, a NaN column and an all-zero
    (singular) system: torch.equal with the plain version."""
    rng = np.random.default_rng(np1)
    g = rng.normal(size=(43, np1, np1)) + 3.0 * np.eye(np1)
    bh = rng.normal(size=(43, np1, np1)) * 1e-3
    r = rng.normal(size=(43, 2 * np1))
    g[1, :, 0] = 0.0
    g[1, 0, 0], g[1, 1, 0] = 2.0, -2.0  # a tie in column 0
    bh[1, :, 0] = 0.0
    g[2, 1, :] = 0.0  # a zero row: a zero pivot
    bh[2, 1, :] = 0.0
    g[3, :, 1 % np1] = np.nan  # a NaN column
    g[4], bh[4], r[4] = 0.0, 0.0, 0.0  # singular
    args = [torch.as_tensor(v, device=cuda) for v in (g, bh, r)]
    freqs = np.array([0.0, 10.0, 1e4])
    before = ac.launch_ac_kernel.launches
    k = ac.ac_solve_batch(*args, freqs)
    torch.cuda.synchronize()
    assert ac.launch_ac_kernel.launches == before + 1
    p = ac.ac_solve_batch(*args, freqs, solve=ac.ac_plain)
    assert _same_bits(k, p)
    bad = ~torch.isfinite(p).all(dim=2)
    assert bool(bad[2:5].all()) and not bool(bad[[0, 1, 5, 42]].any())
    assert bool(torch.isnan(k[bad]).all())


@pytest.mark.parametrize("np1", [33, 48, 49, 72, 73, 84, 85, 100])
def test_ac_block_kernel_is_bit_identical(cuda, np1):
    """The AC kernel past 2np1 = 64 (a block per system, csrc/gj_block.cuh's
    bodies) at every bucket edge: a row a thread to 2np1 = 96 (buckets 72
    and 96), the registers of a 512-thread block to 144 (buckets 127 and
    144), shared memory to 168, the device-memory workspace past it; 259
    instances x 3 frequencies, with a tie in |pivot|, a zero pivot, a NaN
    column, an all-zero (singular) system and an integer instance with
    ties in every column: torch.equal with the plain version."""
    rng = np.random.default_rng(np1)
    g = rng.normal(size=(259, np1, np1)) + 3.0 * np.eye(np1)
    bh = rng.normal(size=(259, np1, np1)) * 1e-3
    r = rng.normal(size=(259, 2 * np1))
    g[1, :, 0] = 0.0
    g[1, 0, 0], g[1, 1, 0] = 2.0, -2.0  # a tie in column 0
    bh[1, :, 0] = 0.0
    g[2, 1, :] = 0.0  # a zero row: a zero pivot
    bh[2, 1, :] = 0.0
    g[3, :, 1] = np.nan  # a NaN column
    g[4], bh[4], r[4] = 0.0, 0.0, 0.0  # singular
    g[5], bh[5] = np.round(2.0 * g[5]), np.round(1e3 * bh[5])  # ties
    args = [torch.as_tensor(v, device=cuda) for v in (g, bh, r)]
    freqs = np.array([0.0, 10.0, 1e4])
    before = ac.launch_ac_kernel.launches
    k = ac.ac_solve_batch(*args, freqs)
    torch.cuda.synchronize()
    assert ac.launch_ac_kernel.launches == before + 1
    p = ac.ac_solve_batch(*args, freqs, solve=ac.ac_plain)
    assert _same_bits(k, p)
    bad = ~torch.isfinite(p).all(dim=2)
    assert bool(bad[2:5].all()) and not bool(bad[[0, 1, 5, 258]].any())
    assert bool(torch.isnan(k[bad]).all())


def test_ac_main_path_runs_the_op_and_ac_kernels(cuda):
    deck = """Common-emitter amplifier frequency response
.ac DEC 12 20 2meg
Vcc vcc 0 DC 12
Vsig sig 0 AC 1 0
Rsrc sig base 600
Rb1 vcc base 68k
Rb2 base 0 12k
Rc vcc col 3.3k
Re emit 0 680
Cb emit 0 47u
Q1 col base emit QNPN
.model QNPN NPN (Bf=180 Vaf=90 Cje=6p Cjc=3p Tf=0.4n)
"""
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, _rc_spread(cc, 32), device=cuda)
    a = cc.netlist.ac
    freqs = ts.frequency_points(a.sweep, a.fstart, a.fstop, a.points)
    o0, a0 = op.launch_op_kernel.launches, ac.launch_ac_kernel.launches
    xr, xi, opr = ts.run_ac_batch(cc, params, None, freqs)
    assert op.launch_op_kernel.launches >= o0 + 1
    assert ac.launch_ac_kernel.launches == a0 + 1
    assert xr.shape == (32, 12, cc.np1) and bool(opr.converged.all())
    assert bool(torch.isfinite(xr).all() and torch.isfinite(xi).all())



# ------------------------------------------------ the store instantiation

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

COUPLED = """Linear transformer 2:1 with resistive load
.tran 5u 1.5m
Vpri in 0 SIN(0 10 2k)
Rpri in p1 4.7
Lp p1 0 8m
Ls s1 0 2m
K1 Lp Ls 0.995
Rsec s1 0 150
"""

SATURATING = """Transformer on a Jiles-Atherton core driven into saturation
.tran 10u 2m
Vpri in 0 SIN(0 20 1k)
Rpri in p1 2.2
Lp p1 0 core=XCORE turns=120
Ls s1 0 core=XCORE turns=40
K1 Lp Ls 0.98
Rsec s1 0 220
.model XCORE CORE (ms=1.5meg A=900 K=450 C=0.18 ALPHA=1.2e-3 AREA=1.1e-4 LEN=0.08)
"""


def _store_inputs(deck, lanes, device, magnetised=False):
    """The run kernel's rows for a deck with R spread (the OP's junction
    voltages on a nonlinear deck; with ``magnetised``, each lane's LM
    state from ``_magnetised_lm``)."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    rng = np.random.default_rng(6)
    ov = {"R": {"value": np.asarray(cc.params["R"]["value"])[None] * np.exp(
        rng.normal(0, 0.1, (lanes, len(cc.params["R"]["value"]))))}}
    params, _ = ts.batch_params(cc, ov, device=device)
    state0 = ts.init_state(cc, device=device)
    if magnetised:
        state0["LM"] = _magnetised_lm(params["LM"], rng, lanes, device)
    r = run.run_inputs(cc, cfg, params, state0)
    return cc, cfg, params, state0, r.plan, r.dev, r.src, r.st, r.sc, r.jv


def _magnetised_lm(pm, rng, b, device):
    """Per-lane LM leaves of a magnetised core: the J-A state after
    ramping each winding to a seeded current in ten steps, i0 and i1 near
    that current (tests/test_torch_magnetic.py's ``magnetised_state``)."""
    nlm = pm["turns"].shape[-1]
    i_end = torch.as_tensor(rng.uniform(0.05, 0.4, (b, nlm)) * rng.choice(
        [-1.0, 1.0], (b, nlm)), device=device)
    zero = torch.zeros((b, nlm), dtype=torch.float64, device=device)
    core = magnetic.CoreState(*(zero for _ in range(5)))
    for s in np.linspace(0.1, 1.0, 10):
        _, _, core = magnetic.ja_calculate(
            pm, core, pm["turns"] * (s * i_end) / pm["len"], DEFAULTS.temp)
    lm = dict(zip(("H", "Hold", "M", "Mirr", "dMdH"), core))
    lm.update(i0=i_end * 1.05, i1=i_end * 0.9, v0=zero, v1=zero,
              flux0=zero)
    return lm


def _assert_store_same(kw, pw):
    assert torch.equal(kw.out_n, pw.out_n)
    assert torch.equal(kw.overflow, pw.overflow)
    b, m, n = kw.out_x.shape
    _assert_same((kw.out_x.reshape(b * m, n), kw.out_t),
                 (pw.out_x.reshape(b * m, n), pw.out_t))


@pytest.mark.parametrize("deck", [RC_SIN, RL_PULSE, HWR, COUPLED,
                                  SATURATING],
                         ids=["rc_sin", "rl_pulse", "diode", "coupled",
                              "saturating"])
def test_store_kernel_matches_plain(cuda, deck):
    *_, cfg, _, _, plan, dev, src, st, sc, jv0 = _store_inputs(deck, 64,
                                                               cuda)
    keep = run.Store(cfg.tstart, cfg.max_store)
    before = run.launch_store_kernel.launches
    k, kw = run.launch_store_kernel(plan, dev, src, st, sc, keep, jv0)
    torch.cuda.synchronize()
    assert run.launch_store_kernel.launches == before + 1
    p, pw = run.store_plain(plan, dev, src, st, sc, keep, jv0)
    _assert_same(k, p)
    _assert_store_same(kw, pw)
    assert torch.equal(kw.out_n, k.accepted) and not kw.overflow.any()
    # a launch into given zeroed buffers writes the same rows there
    buf = run.Waveforms(torch.zeros_like(kw.out_x),
                        torch.zeros_like(kw.out_t), None, None)
    _, kw2 = run.launch_store_kernel(plan, dev, src, st, sc, keep, jv0,
                                     out=buf)
    assert kw2.out_x.data_ptr() == buf.out_x.data_ptr()
    for a, b in zip(kw2, kw):
        assert torch.equal(a, b)
    # the store does not move the trajectory
    r = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
    for a, b in zip(k, r):
        assert torch.equal(a, b)
    # a magnetic deck runs the run kernel's magnetic instantiation
    if plan.nlm or plan.nk:
        _assert_same(r, run.run_plain(plan, dev, src, st, sc, jv0))


MIXED = """Linear primary, saturating secondary
.tran 10u 0.1m
Vpri in 0 SIN(0 20 1k)
Rpri in p1 2.2
Lp p1 0 8m
Ls s1 0 core=XCORE turns=40
K1 Lp Ls 0.98
Rsec s1 0 220
.model XCORE CORE (ms=1.5meg A=900 K=450 C=0.18 ALPHA=1.2e-3 AREA=1.1e-4 LEN=0.08)
"""


@pytest.mark.parametrize("deck", [SATURATING, MIXED],
                         ids=["saturating", "linear_primary"])
def test_magnetised_core_kernels_match_plain(cuda, deck):
    """A nonzero frozen core (L_eff, the frozen i1, an LM partner's frozen
    i0) through the magnetic and the store instantiations."""
    _, cfg, params, state0, plan, dev, src, st, sc, _ = _store_inputs(
        deck, 64, cuda, magnetised=True)
    l0, leff = run_plan.magnetic_rows(plan, params, 64, cuda, DEFAULTS.temp,
                                      state0)[:2]
    assert bool((leff > 10.0 * l0).all())
    r = run.launch_run_kernel(plan, dev, src, st, sc)
    _assert_same(r, run.run_plain(plan, dev, src, st, sc))
    keep = run.Store(cfg.tstart, cfg.max_store)
    k, kw = run.launch_store_kernel(plan, dev, src, st, sc, keep)
    p, pw = run.store_plain(plan, dev, src, st, sc, keep)
    _assert_same(k, p)
    _assert_store_same(kw, pw)
    assert not bool(k.fail.any()) and torch.equal(kw.out_n, k.accepted)


def test_two_chunk_stream_matches_plain_and_the_whole_run(cuda):
    cc, cfg, params, state0, plan, dev, src, st, sc, _ = _store_inputs(
        RC_SIN, 64, cuda)
    whole = ts.make_tran_batch(cc, cfg, None, store="full")(params, state0)
    chunk = int(whole.out_n.max()) // 2 + 1
    outs = list(ts.stream_transient_chunks(cc, cfg, params, state0, chunk))
    assert len(outs) == 2
    n0 = outs[0].out_n.long()
    for lane in range(64):
        a, b = int(n0[lane]), int(outs[1].out_n[lane])
        assert torch.equal(outs[0].out_x[lane, :a], whole.out_x[lane, :a])
        assert torch.equal(outs[1].out_t[lane, :b],
                           whole.out_t[lane, a:a + b])
    assert torch.equal(outs[1].attempts, whole.attempts)
    assert torch.equal(outs[0].accepted + outs[1].accepted, whole.accepted)
    # the second chunk's re-entry against the plain version
    keep = run.Store(cfg.tstart, chunk, True)
    start = run.RunStart(outs[0].t_final, outs[0].dt_final,
                         outs[0].attempts)
    st1 = run_plan.init_state_stack(plan, outs[0].state, 64, cuda)
    k, kw = run.launch_store_kernel(plan, dev, src, st1, sc, keep,
                                    start=start)
    p, pw = run.store_plain(plan, dev, src, st1, sc, keep, start=start)
    _assert_same(k, p)
    _assert_store_same(kw, pw)


# ------------------------------------------------------------ physics

D_RS_SIN = """* Rs diode, sine drive
.tran 0.05m 0.5m
Vin 1 0 SIN(0 5 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Rs=100 Tt=10n)
"""

D_BV_SIN = """* Bv diode, sine drive through breakdown
.tran 0.05m 0.5m
Vin 1 0 SIN(-150 60 5k)
R1 1 2 1k
D1 2 0 DM
C1 2 0 10n
.model DM D (Is=1e-14 Bv=100 Tt=10n)
"""


def _physics_inputs(deck, lanes, device, trap):
    """The PHYS run kernel's inputs as make_tran_run builds them: the
    physics OP (or the linear OP) seeds the state unless UIC."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, lanes), device=device)
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device=device),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       "physics")
    return cfg, r.plan, r.dev, r.src, r.st, r.sc, r.jv


@pytest.mark.parametrize("trap", [False, True], ids=["be", "trap"])
@pytest.mark.parametrize("deck", [HWR, D_RS_SIN, D_BV_SIN, NMOS_INV,
                                  BJT_TRAN, RC_SIN],
                         ids=["diode", "diode_rs", "diode_bv", "mosfet",
                              "bjt", "rc_sin"])
def test_physics_kernels_match_plain(cuda, deck, trap):
    """The PHYS run kernel and its store instantiation against their plain
    versions (64 lanes); the store moves no counter or state."""
    cfg, plan, dev, src, st, sc, jv0 = _physics_inputs(deck, 64, cuda, trap)
    before = run.launch_run_kernel.launches
    k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == before + 1
    _assert_same(k, run.run_plain(plan, dev, src, st, sc, jv0))
    assert not k.fail.any()
    keep = run.Store(cfg.tstart, cfg.max_store)
    ks, kw = run.launch_store_kernel(plan, dev, src, st, sc, keep, jv0)
    p, pw = run.store_plain(plan, dev, src, st, sc, keep, jv0)
    _assert_same(ks, p)
    _assert_store_same(kw, pw)
    for a, b in zip(ks, k):
        assert torch.equal(a, b)


@pytest.mark.parametrize("deck", [D_RS_SIN, D_BV_SIN, HWR],
                         ids=["diode_rs", "diode_bv", "rectifier"])
def test_physics_op_kernel_matches_plain(cuda, deck):
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, _rc_spread(cc, 32), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    k = op.make_op_fused(cc, DEFAULTS, "physics", solve=op.op_lanes)(
        params, state0)
    p = op.make_op_fused(cc, DEFAULTS, "physics", solve=op.op_plain)(
        params, state0)
    _assert_op_bits(k, p)
    assert bool(k.converged.all())


def test_physics_dc_kernel_matches_plain(cuda):
    """The DC sweep kernel's physics flavour with the diode's Rs per lane."""
    cc = ts.compile_circuit(ts.parse(DIODE_IV))
    ov = _rc_spread(cc, 64)
    ov["D"] = {"rs": np.linspace(1.0, 20.0, 64)[:, None]}
    params, _ = ts.batch_params(cc, ov, device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    d = cc.netlist.dc
    pts = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
    slots = (cc.names["V"].index(d.source1),)
    before = dc.launch_dc_kernel.launches
    k = dc.make_dc_fused(cc, slots, DEFAULTS, "physics")(params, state0, pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    p = dc.make_dc_fused(cc, slots, DEFAULTS, "physics",
                         solve=dc.dc_plain)(params, state0, pts)
    _assert_dc_bits(k, p)
    assert bool(k.conv.all())


def test_physics_main_path_launches_both_kernels(cuda):
    """make_tran_batch under physics/trap on the rectifier: one launch of
    the OP kernel's physics flavour, one of the PHYS run kernel."""
    cc = ts.compile_circuit(ts.parse(HWR))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 64), device=cuda)
    fn = ts.make_tran_batch(cc, cfg, None, semantics="physics",
                            opts=ts.SimOptions(integration="trap"))
    r0, o0 = run.launch_run_kernel.launches, op.launch_op_kernel.launches
    out = fn(params, ts.init_state(cc, device=cuda))
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == r0 + 1
    assert op.launch_op_kernel.launches == o0 + 1
    assert not out.fail.any() and bool((out.t_final == cfg.tstop).all())


# tests/test_fused_tran.py's small J-A transformer, and with a rectifier
# on its secondary: LM and K with a diode
TRANS_SMALL = """* small 2-winding J-A transformer
Vin 1 0 sin(0 10 1k)
Rp 1 2 0.5
Lp 2 0 core=C1 turns=300
Ls 3 0 core=C1 turns=150
Rload 3 0 1000
.model C1 core(ms=1.6e6 alpha=1e-3 a=1000 c=0.1 k=2000 area=1e-4 len=0.1)
K1 Lp Ls 0.95
.tran 20u 1m
"""
LM_DIODE = TRANS_SMALL.replace(
    "Rload 3 0 1000", "D1 3 4 DMOD\nRload 4 0 1k\nCload 4 0 10u\n"
    ".model DMOD D(IS=1e-14)")


@pytest.mark.parametrize("deck,semantics,trap,max_attempts", [
    (SATURATING, "physics", False, None), (SATURATING, "physics", True, None),
    (COUPLED, "physics", True, 1500), (TRANS_SMALL, "physics", False, None),
    (MIXED, "physics", True, None), (LM_DIODE, "compat", False, None),
    (LM_DIODE, "physics", True, None)],
    ids=["saturating_be", "saturating_trap", "coupled_trap",
         "trans_small_be", "mixed_trap", "lm_diode_compat",
         "lm_diode_trap"])
def test_magnetic_kernels_match_plain(cuda, deck, semantics, trap,
                                      max_attempts):
    """The PHYS MAG instantiations (the live J-A commit, the physics
    mutual) and the compat MAG Newton one, with and without the store,
    against their plain versions (64 lanes, from the OP's bias point)."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 64), device=cuda)
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device=cuda),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    sc = r.sc if max_attempts is None else r.sc._replace(
        max_attempts=max_attempts)
    before = run.launch_run_kernel.launches
    k = run.launch_run_kernel(r.plan, r.dev, r.src, r.st, sc, r.jv)
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == before + 1
    _assert_same(k, run.run_plain(r.plan, r.dev, r.src, r.st, sc, r.jv))
    assert not k.fail.any()
    keep = run.Store(cfg.tstart, cfg.max_store)
    ks, kw = run.launch_store_kernel(r.plan, r.dev, r.src, r.st, sc, keep,
                                     r.jv)
    p, pw = run.store_plain(r.plan, r.dev, r.src, r.st, sc, keep, r.jv)
    _assert_same(ks, p)
    _assert_store_same(kw, pw)
    for a, b in zip(ks, k):
        assert torch.equal(a, b)


@pytest.mark.parametrize("semantics", ["compat", "physics"])
def test_magnetic_op_and_dc_kernels_match_plain(cuda, semantics):
    """The OP and DC sweep kernels on a magnetic deck (each winding's +1e-3
    branch diagonal) against their plain versions on LM_DIODE."""
    cc = ts.compile_circuit(ts.parse(LM_DIODE))
    params, _ = ts.batch_params(cc, _rc_spread(cc, 32), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    before = op.launch_op_kernel.launches
    k = op.make_op_fused(cc, DEFAULTS, semantics, solve=op.op_lanes)(
        params, state0)
    assert op.launch_op_kernel.launches > before
    p = op.make_op_fused(cc, DEFAULTS, semantics, solve=op.op_plain)(
        params, state0)
    _assert_op_bits(k, p)
    assert bool(k.converged.all())
    pts = np.linspace(-2.0, 5.0, 15)
    before = dc.launch_dc_kernel.launches
    kd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics)(params, state0,
                                                         pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    pd = dc.make_dc_fused(cc, (0,), DEFAULTS, semantics,
                          solve=dc.dc_plain)(params, state0, pts)
    _assert_dc_bits(kd, pd)
    assert bool(kd.conv.all())


def test_magnetic_main_path_launches_its_kernels(cuda):
    """make_tran_batch under physics/trap on saturating_transformer.cir:
    one stamped solve (the linear OP with the LM branch diagonal), one
    launch of the PHYS MAG run kernel; and its AC with an AC source: one
    stamped solve, one AC launch."""
    cc = ts.compile_circuit(ts.parse(SATURATING))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 64), device=cuda)
    fn = ts.make_tran_batch(cc, cfg, None, semantics="physics",
                            opts=ts.SimOptions(integration="trap"))
    r0 = run.launch_run_kernel.launches
    s0 = solve_stamped.launch_stamped.launches
    out = fn(params, ts.init_state(cc, device=cuda))
    torch.cuda.synchronize()
    assert run.launch_run_kernel.launches == r0 + 1
    assert solve_stamped.launch_stamped.launches == s0 + 1
    assert not out.fail.any() and bool((out.t_final == cfg.tstop).all())
    acc = ts.compile_circuit(ts.parse(SATURATING.replace("SIN(0 20 1k)",
                                                         "AC 1 0")))
    a0 = ac.launch_ac_kernel.launches
    xr, xi, _ = ts.run_ac_batch(acc, params, None, [10.0, 1e3, 1e5])
    kr, ki, _ = make_ac_batch(acc, None, DEFAULTS, ac_solve=ac.ac_plain)(
        params, ts.init_state(acc, device=cuda), [10.0, 1e3, 1e5])
    assert ac.launch_ac_kernel.launches == a0 + 1
    _assert_close(xr, kr)
    _assert_close(xi, ki)


# ------------------------------------------------------- general engine


def _general_inputs(deck, lanes, device):
    cc, cfg, params, state0 = _inputs(deck, lanes, device)[:4]
    return cc, cfg, params, state0


def _dense_sets(n, lanes, device):
    rng = np.random.default_rng(n)
    a = rng.normal(size=(lanes, n, n)) + 4.0 * np.eye(n)
    b = rng.normal(size=(lanes, n))
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    b[:, 0] = 0.0
    if n > 3:
        a[:, 3, 3] = 0.0
    a[5, min(2, n - 1), :] = 0.0  # singular lane
    a[6, :, min(4, n - 1)] = np.nan  # a NaN lane
    return (torch.as_tensor(a, device=device),
            torch.as_tensor(b, device=device))


@pytest.mark.parametrize("n", [1, 6, 16, 17, 32, 33, 40, 48, 49, 64, 65, 72,
                               73, 96, 97, 127, 128, 144, 145, 168, 169])
def test_gj_and_stamped_kernels_match_plain(cuda, n):
    """csrc/gj_kernel.cu at each of its buckets' edges (a row a thread in
    registers to 96, the registers of a 512-thread block to 144 (buckets
    127 and 144), the matrix in shared memory to 168, device memory above)
    and csrc/stamped_solve.cu (a warp segment a lane to 32, a warp a lane
    to 64, a block a lane above) against gj_plain on the same systems, 259
    lanes (no multiple of 32): the same bits, the singular and the NaN lane
    the only non-finite ones."""
    from toyspice_tpu_torch.ops import solve

    lanes = 259
    a, b = _dense_sets(n, lanes, cuda)
    want = solve.gj_plain(a, b)
    before = solve.launch_gj.launches
    got = solve.linear_solve(a, b)
    assert solve.launch_gj.launches == before + 1
    bad = ~torch.isfinite(want).all(dim=1)
    assert bad.tolist() == [i in (5, 6) for i in range(lanes)]
    outs = [got]
    if n > 1:  # the stamped solve's row 0 is the ground row it builds
        rows, cols = np.meshgrid(np.arange(1, n), np.arange(n),
                                 indexing="ij")
        fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                             np.arange(1, n))
        vals = a[:, 1:, :].reshape(lanes, -1).contiguous()
        g = torch.zeros(lanes, dtype=torch.float64, device=cuda)
        outs.append(fn(vals, b[:, 1:].contiguous(), g))
        outs.append(solve_stamped.solve_plain(fn.pattern, vals,
                                              b[:, 1:].contiguous(), g))
    for x in outs:
        assert torch.equal(~torch.isfinite(x).all(dim=1), bad)
        assert torch.equal(x[~bad], want[~bad])
        assert bool(torch.isnan(x[bad]).all())


@pytest.mark.parametrize("n", [33, 35, 48, 49, 64, 65, 128])
def test_stamped_warp_kernel_is_bit_identical(cuda, n):
    """csrc/stamped_solve.cu past n = 32 at every bucket edge (a warp a
    system with the rows in registers to 48, in shared memory to 64, a
    block a system above) on 259 lanes (not a multiple of a block's
    systems; many blocks, so that a warp writing past its slice of shared
    memory shows), with a tie in |pivot|, a zero pivot (a singular lane), a NaN
    column and integer entries; gmin 0 and per lane: torch.equal with the
    plain version."""
    rng = np.random.default_rng(n)
    lanes = 259
    a = rng.normal(size=(lanes, n, n)) + 4.0 * np.eye(n)
    rhs = rng.normal(size=(lanes, n))
    a[:, 3, 3] = 0.0
    a[5, 2, :] = 0.0  # singular
    a[6, :, 4] = np.nan
    a[7, 1:, 1] = 0.0
    a[7, 1, 1], a[7, 2, 1] = 3.0, -3.0  # a tie in column 1
    a[8, 1:, :] = np.round(a[8, 1:, :])
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                         np.arange(1, n))
    vals = torch.as_tensor(a[:, 1:, :].reshape(lanes, -1).copy(),
                           device=cuda)
    rv = torch.as_tensor(rhs[:, 1:].copy(), device=cuda)
    for gmin in (torch.zeros(lanes, dtype=torch.float64, device=cuda),
                 torch.as_tensor(rng.uniform(0.0, 1e-3, lanes),
                                 device=cuda)):
        before = solve_stamped.launch_stamped.launches
        k = fn(vals, rv, gmin)
        torch.cuda.synchronize()
        assert solve_stamped.launch_stamped.launches == before + 1
        p = solve_stamped.solve_plain(fn.pattern, vals, rv, gmin)
        assert _same_bits(k, p)
        bad = ~torch.isfinite(p).all(dim=1)
        assert bool(bad[6]) and bool(torch.isnan(k[bad]).all())
        assert bool(bad[5]) == (float(gmin[5]) == 0.0)
        assert not bool(bad[[0, 1, 2, 3, 4, 7, 8, 9, 10, lanes - 1]].any())


@pytest.mark.parametrize("n", [40, 56])
def test_stamped_warp_kernel_sums_a_large_table(cuda, n):
    """Every cell of the pattern four entries deep (each summed from 0 in
    entry order): a term table past what the warp path keeps in shared
    memory (it reads it through the cache then), with the rows in
    registers (n = 40) and in shared memory (n = 56); torch.equal with the
    plain version."""
    rng = np.random.default_rng(n)
    lanes, depth = 67, 4
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    rows = np.repeat(rows.ravel(), depth)
    cols = np.repeat(cols.ravel(), depth)
    rrows = np.repeat(np.arange(1, n), depth)
    fn = solve_stamped.solve_stamped_for(n, rows, cols, rrows)
    assert fn.pattern.table.size > 16384
    vals = rng.normal(size=(lanes, rows.size)) / depth
    diag = (rows == cols)
    vals[:, diag] += 4.0 / depth
    vals = torch.as_tensor(vals, device=cuda)
    rv = torch.as_tensor(rng.normal(size=(lanes, rrows.size)), device=cuda)
    gmin = torch.as_tensor(rng.uniform(0.0, 1e-3, lanes), device=cuda)
    k = fn(vals, rv, gmin)
    torch.cuda.synchronize()
    p = solve_stamped.solve_plain(fn.pattern, vals, rv, gmin)
    assert _same_bits(k, p) and bool(torch.isfinite(p).all())


def _dense_pattern_inputs(n, lanes, device, seed):
    """Random (lanes, n, n) systems as a stamped pattern of one entry per
    cell of rows 1..n-1 and one RHS entry per row, with a zero diagonal, a
    singular lane (5), a NaN column (lane 6), a tie in |pivot| (lane 7)
    and integer entries (lane 8)."""
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(lanes, n, n)) + 4.0 * np.eye(n)
    rhs = rng.normal(size=(lanes, n))
    if n > 3:
        a[:, 3, 3] = 0.0
    a[5, min(2, n - 1), :] = 0.0  # singular
    a[6, :, min(4, n - 1)] = np.nan
    if n > 2:
        a[7, 1:, 1] = 0.0
        a[7, 1, 1], a[7, 2, 1] = 3.0, -3.0  # a tie in column 1
    a[8, 1:, :] = np.round(a[8, 1:, :])
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                         np.arange(1, n))
    vals = torch.as_tensor(a[:, 1:, :].reshape(lanes, -1).copy(),
                           device=device)
    rv = torch.as_tensor(rhs[:, 1:].copy(), device=device)
    gmins = (torch.zeros(lanes, dtype=torch.float64, device=device),
             torch.as_tensor(rng.uniform(0.0, 1e-3, lanes), device=device))
    return fn, vals, rv, gmins


@pytest.mark.parametrize("n", [2, 4, 5, 8, 9, 16, 17, 32])
def test_stamped_segment_kernel_is_bit_identical(cuda, n):
    """csrc/stamped_solve.cu to n = 32 (a warp segment of W = 4, 8, 16 or
    32 lanes per system, row i built from the row view and eliminated on
    thread i) at every bucket edge, 259 lanes, with a zero pivot (a
    singular lane), a NaN column, a tie in |pivot| and integer entries;
    gmin 0 and per lane: torch.equal with the plain version."""
    lanes = 259
    fn, vals, rv, gmins = _dense_pattern_inputs(n, lanes, cuda, 200 + n)
    for gmin in gmins:
        before = solve_stamped.launch_stamped.launches
        k = fn(vals, rv, gmin)
        torch.cuda.synchronize()
        assert solve_stamped.launch_stamped.launches == before + 1
        p = solve_stamped.solve_plain(fn.pattern, vals, rv, gmin)
        assert _same_bits(k, p)
        bad = ~torch.isfinite(p).all(dim=1)
        assert bool(bad[6]) and bool(torch.isnan(k[bad]).all())
        assert not bool(bad[[0, 1, 2, 3, 4, 8, 9, 10, lanes - 1]].any())


@pytest.mark.parametrize("n", [9, 32])
def test_stamped_segment_kernel_reads_a_view_past_its_stage(cuda, n):
    """Every cell of the pattern many entries deep: a row view past what
    the segment kernel copies to shared memory (SEG_VSTAGE, 16384 ints;
    read through the cache then) and a term table past 12,288 words, which
    the per-thread kernel refused; torch.equal with the plain version."""
    rng = np.random.default_rng(n)
    lanes, depth = 67, 40000 // (n * n)
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    rows = np.repeat(rows.ravel(), depth)
    cols = np.repeat(cols.ravel(), depth)
    rrows = np.repeat(np.arange(1, n), depth)
    fn = solve_stamped.solve_stamped_for(n, rows, cols, rrows)
    assert fn.pattern.view.size > 16384
    # the per-thread kernel's former table edge (the run kernels' MAX_TOPO)
    assert fn.pattern.table.size > 12288
    vals = rng.normal(size=(lanes, rows.size)) / depth
    vals[:, rows == cols] += 4.0 / depth
    vals = torch.as_tensor(vals, device=cuda)
    rv = torch.as_tensor(rng.normal(size=(lanes, rrows.size)), device=cuda)
    gmin = torch.as_tensor(rng.uniform(0.0, 1e-3, lanes), device=cuda)
    k = fn(vals, rv, gmin)
    torch.cuda.synchronize()
    p = solve_stamped.solve_plain(fn.pattern, vals, rv, gmin)
    assert _same_bits(k, p) and bool(torch.isfinite(p).all())


@pytest.mark.parametrize("n", [129, 130, 144, 145, 168, 169, 200])
def test_gj_and_stamped_kernels_past_nbig(cuda, n):
    """Past n = 128: to 144 the GJ kernel and the stamped solve eliminate
    each system in the registers of a 512-thread block, to NBIG = 168 in
    its shared memory, past NBIG in its block's slice of a workspace in
    device memory, a bounded grid whose blocks loop over the systems: more
    systems than that grid has blocks, with a zero diagonal, a singular
    lane, a NaN lane and a tie; gmin 0 and per lane; torch.equal with
    gj_plain and solve_plain."""
    from toyspice_tpu_torch.ops import solve

    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    lanes = solve.WORK_BLOCKS_PER_SM * sms + 37
    fn, vals, rv, gmins = _dense_pattern_inputs(n, lanes, cuda, n)
    a = torch.zeros((lanes, n, n), dtype=torch.float64, device=cuda)
    a[:, 0, 0] = 1.0
    a[:, 1:, :] = vals.view(lanes, n - 1, n)
    b = torch.cat([torch.zeros_like(rv[:, :1]), rv], dim=1)
    before = solve.launch_gj.launches
    x = solve.linear_solve(a, b)
    torch.cuda.synchronize()
    assert solve.launch_gj.launches == before + 1
    want = solve.gj_plain(a, b)
    assert _same_bits(x, want)
    bad = ~torch.isfinite(want).all(dim=1)
    assert bad.tolist() == [i in (5, 6) for i in range(lanes)]
    for gmin in gmins:
        k = fn(vals, rv, gmin)
        torch.cuda.synchronize()
        p = solve_stamped.solve_plain(fn.pattern, vals, rv, gmin)
        assert _same_bits(k, p)
        if not bool(gmin.any()):
            assert _same_bits(k, want)


@pytest.mark.parametrize("n", [18, 97, 127, 130, 144, 150, 168])
def test_gj_and_stamped_kernels_break_a_cross_warp_tie(cuda, n):
    """Integer systems whose column 1 holds its largest |a| twice, +10 in
    row 2 and -10 in row 17 (warps 2 and 1 of the wide body, whose rows
    interleave over 16 warps): the kernels take row 2, the lower row on the
    higher warp, as gj_plain does, and the ties of later columns likewise
    (a kernel that took the lowest warp differed on 5 of 12 such lanes at
    n = 130, run on the CPU); lane 8 has a NaN in column n - 2 of row 2
    (the whole block leaves the column loop there and every x is NaN).
    259 lanes, the GJ kernel and the stamped solve (gmin 0): torch.equal
    with gj_plain."""
    from toyspice_tpu_torch.ops import solve

    lanes = 259
    rng = np.random.default_rng(300 + n)
    a = rng.normal(size=(lanes, n, n)) + 4.0 * np.eye(n)
    b = rng.normal(size=(lanes, n))
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    b[:, 0] = 0.0
    a[:, 1:, :] = np.round(2.0 * a[:, 1:, :])
    a[:, 1:, 1] = np.clip(a[:, 1:, 1], -3.0, 3.0)
    a[:, 2, 1], a[:, 17, 1] = 10.0, -10.0
    a[8, 2, n - 2] = np.nan
    a = torch.as_tensor(a, device=cuda)
    b = torch.as_tensor(b, device=cuda)
    want = solve.gj_plain(a, b)
    bad = ~torch.isfinite(want).all(dim=1)
    assert bad.tolist() == [i == 8 for i in range(lanes)]
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                         np.arange(1, n))
    g = torch.zeros(lanes, dtype=torch.float64, device=cuda)
    for x in (solve.linear_solve(a, b),
              fn(a[:, 1:, :].reshape(lanes, -1).contiguous(),
                 b[:, 1:].contiguous(), g)):
        torch.cuda.synchronize()
        assert _same_bits(x, want)
        assert bool(torch.isnan(x[8]).all())


def test_general_engine_matches_the_run_kernel(cuda):
    """The half-wave rectifier through engine/tran.make_tran (the general
    OP with its GJ seed, the general Newton over the stamped solve)
    against make_tran_batch (the OP and run kernels), 64 lanes."""
    from toyspice_tpu_torch.engine.tran import make_tran
    from toyspice_tpu_torch.ops import solve

    cc, cfg, params, state0 = _general_inputs(HWR, 64, cuda)
    k = ts.make_tran_batch(cc, cfg, None)(params, state0)
    before = solve.launch_gj.launches
    g = make_tran(cc, cfg, store="none")(params, state0)
    assert solve.launch_gj.launches > before
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        assert torch.equal(getattr(g, key), getattr(k, key)), key
    for kind in k.state:
        for key in k.state[kind]:
            torch.testing.assert_close(g.state[kind][key], k.state[kind][key],
                                       rtol=1e-9, atol=1e-15)


def test_cw16_takes_the_general_engine(cuda, monkeypatch):
    """A 16-stage Cockcroft-Walton multiplier (np1 = 35, 32 diodes) cut to
    0.1 ms under TOYSPICE_TRAN=general (without it the run kernel's 64-row
    bucket takes it, tests/test_torch_wide_bucket.py): engine "general",
    the GJ kernel and the stamped solve's warp instantiation launched, no
    other kernel; the kernels against the plain versions on the same
    lanes."""
    from toyspice_tpu_torch.engine.tran import make_tran
    from toyspice_tpu_torch.ops import solve

    lines = [".tran 5u 0.1m", "Vin a 0 SIN(0 100 1k)", "C1 a p1 100n",
             "D1 0 p1 DMOD", "D2 p1 s1 DMOD", "C2 0 s1 100n"]
    for k in range(2, 17):
        lines += [f"C{2 * k - 1} p{k - 1} p{k} 100n",
                  f"D{2 * k - 1} s{k - 1} p{k} DMOD",
                  f"D{2 * k} p{k} s{k} DMOD", f"C{2 * k} s{k - 1} s{k} 100n"]
    deck = "\n".join(["* cw16"] + lines + [
        "Rload s16 0 10meg", ".model DMOD D (Is=1e-14 N=1.0 Cj0=2p Tt=5n)",
        ""])
    cc, cfg, params, state0 = _general_inputs(deck, 32, cuda)
    monkeypatch.setenv("TOYSPICE_TRAN", "general")
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "general"
    counters = (run.launch_run_kernel, op.launch_op_kernel, solve.launch_gj,
                solve_stamped.launch_stamped)
    before = [c.launches for c in counters]
    out = fn(params, state0)
    moved = [c.launches - b for c, b in zip(counters, before)]
    assert moved[:2] == [0, 0] and moved[2] >= 1 and moved[3] >= 1
    assert not bool(out.fail.any())
    p = make_tran(cc, cfg, store="none", solve=solve_stamped.solve_plain,
                  dense_solve=solve.gj_plain)(params, state0)
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        assert torch.equal(getattr(out, key), getattr(p, key)), key
    for key in out.state["C"]:
        torch.testing.assert_close(out.state["C"][key], p.state["C"][key],
                                   rtol=1e-9, atol=1e-15)


# ------------------------------ the linear run kernel on a warp segment


def _ladder(np1):
    """A deck of np1 unknowns: an RC ladder from a SIN source ending in an
    inductor to ground (ground, the source's branch and the inductor's
    branch besides the nodes); np1 = 2 a current source into R || C."""
    if np1 == 2:
        return ("* np1 = 2\n.tran 0.02m 0.5m\nI1 0 1 SIN(0 1m 2k)\n"
                "R1 1 0 1k\nC1 1 0 0.2u\n")
    nodes = np1 - 3
    lines = ["* ladder", ".tran 0.02m 0.5m", "Vin 1 0 SIN(0 5 1k)",
             "R0 1 0 2k"]
    for i in range(1, nodes):
        lines += [f"R{i} {i} {i + 1} {100 + 10 * i}",
                  f"C{i} {i + 1} 0 {0.1 + 0.01 * i:.2f}u"]
    lines.append(f"L1 {nodes} 0 2m")
    return "\n".join(lines) + "\n"


def _assert_bits(k, p):
    """Every output bit for bit (NaN where the plain version has NaN)."""
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert _same_bits(a, b) if a.is_floating_point() else \
            torch.equal(a, b)


def _run_and_store_bits(plan, dev, src, st, sc, keep, jv0=None, start=None):
    """The run and the store instantiation against their plain versions,
    bit for bit; returns the store's (result, waveforms)."""
    if start is None:
        k = run.launch_run_kernel(plan, dev, src, st, sc, jv0)
        _assert_bits(k, run.run_plain(plan, dev, src, st, sc, jv0))
    ks, kw = run.launch_store_kernel(plan, dev, src, st, sc, keep, jv0,
                                     start=start)
    p, pw = run.store_plain(plan, dev, src, st, sc, keep, jv0, start)
    _assert_bits(ks, p)
    _assert_bits(kw, pw)
    return ks, kw


@pytest.mark.parametrize("np1", [2, 4, 5, 6, 8, 9, 16, 17, 32])
def test_linear_segment_kernel_is_bit_identical(cuda, np1):
    """Segments of 4, 8, 16 and 32 lanes at every bucket edge, 259 lanes (not
    a multiple of a block's lanes): counters, state, t, dt and the store's
    rows equal to run_plain/store_plain bit for bit."""
    cc, cfg, params, state0, plan, dev, src, st, sc = _inputs(
        _ladder(np1), 259, cuda)
    assert plan.np1 == np1 and not plan.nonlinear
    sc = sc._replace(max_attempts=1500)
    ks, kw = _run_and_store_bits(plan, dev, src, st, sc,
                                 run.Store(cfg.tstart, cfg.max_store))
    assert not ks.fail.any() and torch.equal(kw.out_n, ks.accepted)


def test_linear_segment_failing_lanes_beside_finite_ones(cuda):
    """A zero-pivot lane (C = 0 in a capacitor chain) and a lane whose
    stamps are NaN (C = NaN) in the same warp as finite lanes, then every
    lane with minstep NaN: bit for bit with the plain version."""
    def bad_caps(ov):
        ov["C"]["value"][1] = 0.0
        ov["C"]["value"][5, 0] = np.nan

    *_, plan, dev, src, st, sc = _inputs(CSERIES, 12, cuda, bad_caps)
    keep = run.Store(0.0, 64)
    ks, _ = _run_and_store_bits(plan, dev, src, st, sc, keep)
    assert ks.fail[[1, 5]].tolist() == [1, 1]
    assert not ks.fail[[0, 2, 3, 4, 6, 7]].any()
    nan = sc._replace(minstep=float("nan"))
    ks, _ = _run_and_store_bits(plan, dev, src, st, nan, keep)
    assert bool(ks.fail.all())


def test_linear_segment_stream_pauses_lanes_of_one_warp(cuda):
    """A streamed chunk whose rows fill at different attempts on the lanes
    of one warp (each lane's pulse at its own delay, so its rejections
    fall elsewhere), then the re-entry from where each lane paused: both
    bit for bit with the plain store."""
    def delays(ov):
        ov["V"] = {"delay": np.random.default_rng(9).uniform(
            0.02e-3, 0.2e-3, (37, 1))}

    cc, cfg, params, state0, plan, dev, src, st, sc = _inputs(
        RL_PULSE, 37, cuda, delays)
    keep = run.Store(cfg.tstart, 150, True)
    k1, w1 = _run_and_store_bits(plan, dev, src, st, sc, keep,
                                 start=run.fresh_start(37, sc, cuda))
    # the first warp's first four lanes (np1 = 5: segments of 8) pause
    # apart
    assert len(set(k1.attempts[:4].tolist())) > 1
    start = run.RunStart(k1.t, k1.dt, k1.attempts)
    _run_and_store_bits(plan, dev, src, k1.state, sc, keep, start=start)


@pytest.mark.parametrize("deck,semantics,trap", [
    (SATURATING, "compat", False), (COUPLED, "compat", False),
    ("rl_tran.cir", "physics", False), ("rl_tran.cir", "physics", True),
    ("rlc_ringdown.cir", "physics", False),
    ("rlc_ringdown.cir", "physics", True),
    (SATURATING, "physics", True), (MIXED, "physics", False)],
    ids=["compat_mag", "compat_k", "rl_be", "rl_trap", "rlc_be", "rlc_trap",
         "phys_mag_trap", "phys_mag_be"])
def test_linear_segment_instantiations_are_bit_identical(cuda, deck,
                                                          semantics, trap):
    """compat MAG, PHYS (BE and trap) and PHYS MAG linear, run and store,
    64 lanes from the OP's bias point under physics, to 1500 attempts."""
    if deck.endswith(".cir"):
        from pathlib import Path

        deck = (Path(__file__).resolve().parent.parent / "circuits"
                / deck).read_text()
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, _ = ts.batch_params(cc, _rc_spread(cc, 64), device=cuda)
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device=cuda),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    assert not r.plan.nonlinear
    sc = r.sc._replace(max_attempts=1500)
    ks, kw = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                 run.Store(cfg.tstart, cfg.max_store))
    assert not ks.fail.any()


@pytest.mark.parametrize("np1,w", [(4, 4), (5, 8), (6, 8), (16, 16),
                                   (17, 32), (32, 32)])
def test_linear_segment_launch_shape(cuda, np1, w):
    """The shape the compat library reports for a linear deck: segments of
    W threads, 128 / W lanes a block, enough blocks for 259 lanes, the
    table and the slices within an SM's shared memory."""
    *_, plan, dev, src, st, sc = _inputs(_ladder(np1), 259, cuda)
    got = run.segment_shape(plan, 259)
    assert got[:4] == (w, 128 // w, -(-259 // (128 // w)), 128)
    assert plan.topo.size * 4 < got[4] <= 227 * 1024


# ------------------------- the Newton run kernel on a warp segment


def newton_ladder(np1):
    """A Newton deck of np1 unknowns: an RC ladder from a SIN source with a
    clamp diode at each of its first 16 nodes past the first, alternating
    in direction (ground, the source's branch and the nodes); np1 = 2 a
    current source into a diode, R and C."""
    if np1 == 2:
        return ("* np1 = 2\n.tran 0.02m 0.5m\nI1 0 1 SIN(0 2m 2k)\n"
                "R1 1 0 1k\nC1 1 0 0.2u\nD1 1 0 DM\n"
                ".model DM D (Is=1e-14 N=1.1 Tt=5n)\n")
    nodes = np1 - 2
    lines = ["* diode clamp ladder", ".tran 0.02m 0.5m",
             "Vin 1 0 SIN(0 5 1k)"]
    for i in range(1, nodes):
        lines += [f"R{i} {i} {i + 1} {200 + 10 * i}",
                  f"C{i} {i + 1} 0 {0.05 + 0.01 * i:.2f}u"]
    for j, node in enumerate(range(2, min(nodes, 17) + 1)):
        a, b = (node, 0) if j % 2 == 0 else (0, node)
        lines.append(f"D{j + 1} {a} {b} DM")
    lines.append(".model DM D (Is=1e-14 N=1.05 Tt=5n)")
    return "\n".join(lines) + "\n"


# sixteen devices (6 D, 4 Q, 6 M of levels 1-3), np1 = 32: MOSFET
# inverters, common-emitter stages and diode clamps
MIXED16 = """* mixed D/Q/M, sixteen devices
.tran 5u 0.2m
Vdd vdd 0 DC 5
Vin in 0 SIN(2.5 2 5k)
Vsig sig 0 SIN(0 20m 1k)
Rsrc sig s1 600
R1 vdd d1 10k
M1 d1 in 0 0 NL1 L=2u W=20u
C1 d1 0 10p
R2 vdd d2 10k
M2 d2 d1 0 0 NL3 L=2u W=20u
C2 d2 0 10p
M3 d3 d2 vdd vdd PL2 L=2u W=40u
R3 d3 0 20k
C3 d3 0 10p
R4 vdd d4 10k
M4 d4 d3 0 0 NL1 L=2u W=20u
C4 d4 0 10p
R5 vdd d5 10k
M5 d5 in 0 0 NL3 L=2u W=20u
C5 d5 0 10p
M6 d6 d5 vdd vdd PL2 L=2u W=40u
R6 d6 0 20k
C6 d6 0 10p
Cc1 s1 b1 10u
Rb11 vdd b1 68k
Rb12 b1 0 12k
Rc1 vdd c1 3.3k
Re1 e1 0 680
Ce1 e1 0 47u
Q1 c1 b1 e1 QN
Cc2 s1 b2 10u
Rb21 vdd b2 82k
Rb22 b2 0 15k
Rc2 vdd c2 3.9k
Re2 e2 0 820
Q2 c2 b2 e2 QN
Cc3 s1 b3 10u
Rb31 vdd b3 56k
Rb32 b3 0 10k
Rc3 vdd c3 2.7k
Re3 e3 0 560
Q3 c3 b3 e3 QN
Cc4 s1 b4 10u
Rb41 vdd b4 47k
Rb42 b4 0 8.2k
Rc4 vdd c4 4.7k
Re4 e4 0 1k
Q4 c4 b4 e4 QN
D1 d1 n1 DM
Rd1 n1 0 22k
D2 d2 n2 DM
Rd2 n2 0 22k
D3 n3 d3 DM
Rd3 vdd n3 22k
D4 c1 n4 DM
Rd4 n4 0 10k
D5 c2 n5 DM
Rd5 n5 0 10k
D6 c4 n6 DM
Rd6 n6 0 10k
.model NL1 NMOS(Level=1 VTO=1.1 KP=3m LAMBDA=0.01)
.model NL3 NMOS(Level=3 VTO=0.7 KP=300u THETA=0.05 KAPPA=0.3)
.model PL2 PMOS(Level=2 VTO=-0.8 KP=150u UCRIT=1e4 UEXP=0.1)
.model QN NPN(Bf=180 Vaf=90)
.model DM D(Is=1e-14 N=1.05 Tt=5n)
"""

# a rectifier with a clamp, driven by a pulse whose delay and rise each
# lane draws (pulsed_spread): with max_iter = 5 its lanes take different
# Newton counts, reject at different attempts and some hard-fail
PULSED = """* pulse-driven rectifier
.tran 5u 0.6m
Vin in 0 PULSE(-4 6 0.05m 2u 2u 0.1m 0.25m)
D1 in out DM
R1 out 0 2k
C1 out 0 0.5u
D2 0 out DM
.model DM D (Is=1e-14 N=1.05 Tt=5n)
"""


def pulsed_spread(cc, lanes, seed=5):
    """R and C log-normal by 0.3, the pulse's delay and rise uniform."""
    rng = np.random.default_rng(seed)
    ov = {k: {"value": np.asarray(cc.params[k]["value"])[None] * np.exp(
        rng.normal(0, 0.3, (lanes, len(cc.params[k]["value"]))))}
        for k in ("R", "C")}
    ov["V"] = {"delay": rng.uniform(0.01e-3, 0.1e-3, (lanes, 1)),
               "rise": rng.uniform(0.5e-6, 20e-6, (lanes, 1))}
    return ov


def _newton_inputs(deck, lanes, device, semantics="compat", trap=False,
                   overrides=None):
    """A Newton deck's run inputs as make_tran_run builds them (its OP
    first): (cfg, RunInputs)."""
    cc = ts.compile_circuit(ts.parse(deck))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    ov = (overrides or _rc_spread)(cc, lanes)
    params, _ = ts.batch_params(cc, ov, device=device)
    r = run.run_inputs(cc, cfg, params, ts.init_state(cc, device=device),
                       ts.SimOptions(integration="trap" if trap else "be"),
                       semantics)
    assert r.plan.nonlinear
    return cfg, r


@pytest.mark.parametrize("np1", [2, 4, 5, 8, 9, 16, 17, 32])
def test_newton_segment_kernel_is_bit_identical(cuda, np1):
    """The Newton instantiation on segments of 4, 8, 16 and 32 lanes at
    every bucket edge, 259 lanes: counters, state, t, dt, jv and the
    store's rows equal to run_plain/store_plain bit for bit."""
    cfg, r = _newton_inputs(newton_ladder(np1), 259, cuda)
    assert r.plan.np1 == np1
    ks, kw = _run_and_store_bits(r.plan, r.dev, r.src, r.st, r.sc,
                                 run.Store(cfg.tstart, cfg.max_store), r.jv)
    assert not ks.fail.any() and torch.equal(kw.out_n, ks.accepted)
    assert bool((ks.nr_iters > ks.attempts).all())


@pytest.mark.parametrize("deck,semantics,trap", [
    (HWR, "compat", False), (MIXED16, "compat", False),
    (LM_DIODE, "compat", False), (HWR, "physics", False),
    (BJT_TRAN, "physics", False), (NMOS_INV, "physics", True),
    (D_BV_SIN, "physics", True), (newton_ladder(17), "physics", True),
    (LM_DIODE, "physics", True), (LM_DIODE, "physics", False)],
    ids=["compat", "compat_mixed16", "compat_mag", "phys_be",
         "phys_be_bjt", "phys_trap_mos", "phys_trap_bv", "phys_trap_32",
         "phys_mag_trap", "phys_mag_be"])
def test_newton_segment_instantiations_are_bit_identical(cuda, deck,
                                                          semantics, trap):
    """compat, compat MAG, PHYS BE and trap and PHYS MAG Newton, run and
    store, 259 lanes from the OP's bias point, to 600 attempts."""
    cfg, r = _newton_inputs(deck, 259, cuda, semantics, trap)
    sc = r.sc._replace(max_attempts=min(r.sc.max_attempts, 600))
    ks, _ = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                run.Store(cfg.tstart, cfg.max_store), r.jv)
    assert not ks.fail.any()


@pytest.mark.parametrize("semantics,trap", [("compat", False),
                                            ("physics", True)])
def test_newton_segment_lanes_of_a_warp_diverge(cuda, semantics, trap):
    """PULSED at 259 lanes with max_iter = 5: lanes of one warp take
    different Newton counts, reject at different attempts and some
    hard-fail (under physics); run and store bit for bit with the plain
    versions."""
    cfg, r = _newton_inputs(PULSED, 259, cuda, semantics, trap,
                            pulsed_spread)
    sc = r.sc._replace(max_iter=5)
    ks, _ = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc,
                                run.Store(cfg.tstart, cfg.max_store), r.jv)
    # np1 = 4: segments of 4, eight lanes a warp
    assert len(set(ks.nr_iters[:8].tolist())) > 1
    assert bool((ks.attempts > ks.accepted).any())
    assert not bool(ks.fail.all())


def test_newton_segment_failing_lanes_beside_finite_ones(cuda):
    """A lane whose stamps are NaN (C = NaN) and a lane with R = 0 in the
    same warp as finite lanes, then every lane with minstep NaN: bit for
    bit with the plain versions, the NaN lane hard-failed."""
    def bad(cc, lanes):
        ov = _rc_spread(cc, lanes)
        ov["C"]["value"][1] = np.nan
        ov["R"]["value"][2] = 0.0
        return ov

    cfg, r = _newton_inputs(HWR, 12, cuda, overrides=bad)
    keep = run.Store(0.0, 64)
    sc = r.sc._replace(max_attempts=400)
    ks, _ = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc, keep, r.jv)
    assert ks.fail[1] == 1
    assert not ks.fail[[0, 3, 4, 5, 6, 7]].any()
    nan = sc._replace(minstep=float("nan"))
    ks, _ = _run_and_store_bits(r.plan, r.dev, r.src, r.st, nan, keep, r.jv)
    assert bool(ks.fail.all())


def test_newton_segment_stream_pauses_lanes_of_one_warp(cuda):
    """A streamed chunk of PULSED (max_iter = 5) whose rows fill at
    different attempts on the lanes of one warp, then the re-entry from
    where each lane paused with its junction voltages: both bit for bit
    with the plain store."""
    cfg, r = _newton_inputs(PULSED, 37, cuda, overrides=pulsed_spread)
    sc = r.sc._replace(max_iter=5)
    keep = run.Store(cfg.tstart, 60, True)
    k1, _ = _run_and_store_bits(r.plan, r.dev, r.src, r.st, sc, keep, r.jv,
                                start=run.fresh_start(37, sc, cuda))
    assert len(set(k1.attempts[:8].tolist())) > 1
    start = run.RunStart(k1.t, k1.dt, k1.attempts)
    _run_and_store_bits(r.plan, r.dev, r.src, k1.state, sc, keep, k1.jv,
                        start=start)


@pytest.mark.parametrize("store", [False, True], ids=["run", "store"])
def test_newton_segment_refuses_a_short_slice(cuda, monkeypatch, store):
    """A launch whose lane_doubles (ops/run.py run_doubles) is one short of
    the deck's source values, junction voltages and value slots fails
    every lane before its first attempt
    and leaves jv and state as they were, where it would otherwise write
    past its segment's slice."""
    cfg, r = _newton_inputs(MIXED16, 37, cuda)
    need = run.newton_doubles(r.plan)
    monkeypatch.setattr(run, "newton_doubles", lambda plan: need - 1)
    if store:
        k, _ = run.launch_store_kernel(r.plan, r.dev, r.src, r.st, r.sc,
                                       run.Store(cfg.tstart, 8), r.jv)
    else:
        k = run.launch_run_kernel(r.plan, r.dev, r.src, r.st, r.sc, r.jv)
    torch.cuda.synchronize()
    assert bool(k.fail.all()) and not k.attempts.any()
    assert not k.accepted.any()
    assert torch.equal(k.jv, r.jv) and torch.equal(k.state, r.st)


@pytest.mark.parametrize("deck,semantics,store,tag", [
    (HWR, "compat", False, "<4, true, false, false, false, true>"),
    (HWR, "compat", True, "<4, true, false, true, false, true>"),
    (newton_ladder(8), "physics", False,
     "<8, true, false, false, true, true>"),
    (newton_ladder(9), "physics", True,
     "<16, true, false, true, true, true>"),
    (MIXED16, "compat", False, "<32, true, false, false, false, true>"),
    (LM_DIODE, "compat", True, "<8, true, true, true, false, true>"),
    (LM_DIODE, "physics", False, "<8, true, true, false, true, true>")],
    ids=["compat_4", "compat_store_4", "phys_8", "phys_store_16",
         "compat_32", "compat_mag_store", "phys_mag"])
def test_newton_segment_launch_shape(cuda, deck, semantics, store, tag):
    """Each Newton instantiation launches the segment kernel (the one
    kernel of the launch, by its name in a profile of the card) in the
    shape the compat library reports: segments of W threads, 128 / W lanes
    a block, enough blocks for 259 lanes, the table and the slices (with
    the junction voltages and value slots) within an SM's shared
    memory."""
    from torch.profiler import ProfilerActivity, profile

    cfg, r = _newton_inputs(deck, 259, cuda, semantics)
    sc = r.sc._replace(max_attempts=20)
    got = run.segment_shape(r.plan, 259)
    w = int(tag[1:tag.index(",")])
    assert got[:4] == (w, 128 // w, -(-259 // (128 // w)), 128)
    # a slice: the exchange buffer and W build rows, x, the lane's 192 rows
    # (csrc/run_kernel.cuh seg_slice), then its source values (an even
    # count), junction voltages and value slots, an even count; the table
    # in shared memory
    base = (w + 2) * (w + 1) + w + 192
    nl = (run.run_doubles(r.plan) + 1) // 2 * 2
    assert run.newton_doubles(r.plan) >= r.plan.kj > 0
    assert got[4] == 8 * ((r.plan.topo.size + 3) // 4 * 2
                          + (128 // w) * (base + nl))
    assert got[4] <= 227 * 1024 and got[6] == 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if store:
            run.launch_store_kernel(r.plan, r.dev, r.src, r.st, sc,
                                    run.Store(cfg.tstart, 8), r.jv)
        else:
            run.launch_run_kernel(r.plan, r.dev, r.src, r.st, sc, r.jv)
        torch.cuda.synchronize()
    names = {e.key for e in prof.key_averages() if "run_" in e.key}
    assert len(names) == 1, names
    assert "run_seg_kernel" + tag in names.pop().replace(" ", "").replace(
        ",", ", ")


# ------------------- the OP and DC sweep kernels on a warp segment

HARD_I = """i-driven stack
.op
I1 0 1 DC 1
D1 1 2 DM
D2 2 0 DM
.model DM D (Is=1e-15 N=1.0)
"""


def _v_draw(lo, hi, seed=0):
    """Every V source's dc drawn per lane, uniform in [lo, hi]."""
    def ov(cc, b):
        nv = len(cc.params["V"]["dc"])
        return {"V": {"dc": np.random.default_rng(seed).uniform(
            lo, hi, (b, nv))}}
    return ov


def _mixed_op_draw(cc, b):
    return {"V": {"dc": np.stack([np.full(b, 5.0), np.linspace(0.5, 4.5, b)],
                                 axis=1)}}


def _op_pair(deck, lanes, device, semantics="compat", ov=None,
             max_iter=None):
    """make_op_fused through the kernel (its launches counted) and through
    the plain version on the same lanes: (kernel result, plain result,
    kernel launches)."""
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, (ov or _rc_spread)(cc, lanes),
                                device=device)
    state0 = ts.init_state(cc, device=device)
    opts = DEFAULTS if max_iter is None else ts.SimOptions(max_iter=max_iter)
    before = op.launch_op_kernel.launches
    k = op.make_op_fused(cc, opts, semantics, solve=op.op_lanes)(params,
                                                                state0)
    torch.cuda.synchronize()
    launched = op.launch_op_kernel.launches - before
    p = op.make_op_fused(cc, opts, semantics, solve=op.op_plain)(params,
                                                                state0)
    assert op.launch_op_kernel.launches - before == launched >= 1
    return k, p, launched


@pytest.mark.parametrize("np1", [2, 4, 5, 8, 9, 16, 17, 32])
def test_op_segment_kernel_is_bit_identical(cuda, np1):
    """The OP kernel on segments of 4, 8, 16 and 32 lanes at every bucket
    edge, 259 lanes (not a multiple of a block's lanes): converged, stage,
    iterations, x and jv equal to op_plain bit for bit."""
    deck = newton_ladder(np1)
    assert ts.compile_circuit(ts.parse(deck)).np1 == np1
    k, p, _ = _op_pair(deck, 259, cuda)
    _assert_op_bits(k, p)
    assert bool(k.converged.all())


@pytest.mark.parametrize("deck,semantics,ov,max_iter", [
    (MIXED16, "compat", None, None), (MIXED16, "physics", None, None),
    (MIXED_OP, "compat", _mixed_op_draw, None),
    (LM_DIODE, "compat", None, None), (LM_DIODE, "physics", None, None),
    (D_RS_SIN, "physics", None, None), (D_BV_SIN, "physics", None, None),
    (HARD_V, "compat", _v_draw(2.0, 100.0), None),
    (HARD_V, "physics", _v_draw(2.0, 100.0), None),
    (HARD_I, "compat", lambda cc, b: {"I": {"dc": np.ones((b, 1))}}, None),
    (BJT_TRAN, "compat", None, 2)],
    ids=["mixed16", "mixed16_physics", "levels_polarities", "lm_diode",
         "lm_diode_physics", "diode_rs", "diode_bv", "hard_v",
         "hard_v_physics", "hard_i", "max_iter_2"])
def test_op_segment_instantiations_are_bit_identical(cuda, deck, semantics,
                                                      ov, max_iter):
    """D, Q and M together at np1 = 32, level-2/3 MOSFETs of both
    polarities, LM decks, the Rs and Bv diodes, HARD_V's ladder (lanes at
    stages 0 and 2, from a non-finite linear estimate), HARD_I (no lane
    converges) and max_iter = 2, 259 lanes: bit for bit with op_plain."""
    k, p, launched = _op_pair(deck, 259, cuda, semantics, ov, max_iter)
    _assert_op_bits(k, p)
    stages = torch.bincount(k.stage.long(), minlength=3).tolist()
    if deck is HARD_V:
        assert stages[0] and stages[2] and bool(k.converged.all())
    elif deck is HARD_I or max_iter == 2:
        assert stages[2] == 259 and not bool(k.converged.any())
        assert launched > 3
    elif deck is MIXED_OP:
        assert launched > 1  # lanes of one warp on different rungs
    else:
        assert bool(k.converged.all())


def _first_op_inputs(deck, lanes, device, ov=None):
    """The first launch's (plan, dev, dyn, x0, jv0, scalars) of a deck's
    OP ladder."""
    cc = ts.compile_circuit(ts.parse(deck))
    params, _ = ts.batch_params(cc, (ov or _rc_spread)(cc, lanes),
                                device=device)
    seen = []

    def solve(*args):
        seen.append(args)
        return op.op_plain(*args)

    op.make_op_fused(cc, DEFAULTS, solve=solve)(
        params, ts.init_state(cc, device=device))
    return seen[0]


def test_op_segment_non_finite_estimate_is_zero(cuda):
    """HARD_V's linear estimate is singular (its diode nodes have no linear
    stamp): with use_seed and no lane active, x is the zero vector, jv0
    is kept and no lane iterates, on every lane; then half the lanes
    active, half not: bit for bit with op_plain."""
    plan, dev, dyn, x0, jv0, sc = _first_op_inputs(HARD_V, 37, cuda,
                                                   _v_draw(2.0, 100.0))
    dyn = dyn.clone()
    dyn[:, 2] = 0.0  # act
    k = op.launch_op_kernel(plan, dev, dyn, x0, jv0, sc)
    p = op.op_plain(plan, dev, dyn, x0, jv0, sc)
    assert bool((k.x == 0).all()) and not k.iters.any()
    assert not k.conv.any() and torch.equal(k.jv, jv0)
    for a, b in zip(k, p):
        assert _same_bits(a, b) if a.is_floating_point() else \
            torch.equal(a, b)
    dyn[::2, 2] = 1.0
    dyn[1::4, 1] = 0.0  # some lanes from x0 instead of the estimate
    x1 = torch.rand_like(x0)
    k = op.launch_op_kernel(plan, dev, dyn, x1, jv0, sc)
    p = op.op_plain(plan, dev, dyn, x1, jv0, sc)
    for a, b in zip(k, p):
        assert _same_bits(a, b) if a.is_floating_point() else \
            torch.equal(a, b)
    assert not k.iters[1::2].any() and bool(k.iters[::2].gt(0).all())


def _dc_sweep(deck, pts, slots=None):
    cc = ts.compile_circuit(ts.parse(deck))
    if slots is None:
        d = cc.netlist.dc
        slots = (cc.names["V"].index(d.source1),)
    return cc, np.asarray(pts), slots


def _diode_pts():
    return np.asarray(ts.sweep_values(0.2, 0.9, 0.02))


@pytest.mark.parametrize("case", [
    "diode", "diode_rs_physics", "diode_lane_table", "diode_150_points",
    "diode_max_iter_2", "mos_nested", "lm_diode", "lm_diode_physics",
    "ladder5", "ladder9", "ladder17", "ladder32", "mixed16"])
def test_dc_segment_kernel_is_bit_identical(cuda, case):
    """The DC sweep kernel on segments of 4, 8, 16 and 32 lanes, 259
    lanes, compat and physics (the diode's Rs per lane), a per-lane source
    table, a sweep of 150 points, max_iter = 2, a nested sweep of level-2/3
    MOSFETs, LM decks, ladders at the bucket edges and D, Q and M together
    at np1 = 32: conv and iterations per point equal to dc_plain, xs bit
    for bit."""
    semantics, max_iter, lanes = "compat", None, 259
    ov = _rc_spread
    if case.startswith("diode"):
        cc, pts, slots = _dc_sweep(DIODE_IV, _diode_pts())
        if case == "diode_rs_physics":
            semantics = "physics"

            def ov(cc, b):
                o = _rc_spread(cc, b)
                o["D"] = {"rs": np.linspace(1.0, 20.0, b)[:, None]}
                return o
        elif case == "diode_lane_table":
            ov = _v_draw(0.1, 0.3)
        elif case == "diode_150_points":
            pts = np.linspace(-1.0, 0.9, 150)
        elif case == "diode_max_iter_2":
            max_iter = 2
    elif case == "mos_nested":
        cc, pts, slots = _dc_sweep(MOS_DC, [])
        d = cc.netlist.dc
        inner = np.asarray(ts.sweep_values(d.start1, d.stop1, d.increment1))
        pts = np.array([(a, b) for a in (3.0, 5.0) for b in inner])
        slots = (cc.names["V"].index("VDD"), cc.names["V"].index("VG"))
    elif case.startswith("lm_diode"):
        cc, pts, slots = _dc_sweep(LM_DIODE, np.linspace(-2.0, 5.0, 15),
                                   (0,))
        semantics = "physics" if case.endswith("physics") else "compat"
    elif case == "mixed16":
        cc, pts, slots = _dc_sweep(MIXED16, np.linspace(0.0, 3.0, 9), (1,))
    else:
        np1 = int(case[len("ladder"):])
        cc, pts, slots = _dc_sweep(newton_ladder(np1),
                                   np.linspace(-3.0, 3.0, 11), (0,))
        assert cc.np1 == np1
    params, _ = ts.batch_params(cc, ov(cc, lanes), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    opts = DEFAULTS if max_iter is None else ts.SimOptions(max_iter=max_iter)
    before = dc.launch_dc_kernel.launches
    k = dc.make_dc_fused(cc, slots, opts, semantics)(params, state0, pts)
    torch.cuda.synchronize()
    assert dc.launch_dc_kernel.launches == before + 1
    p = dc.make_dc_fused(cc, slots, opts, semantics, solve=dc.dc_plain)(
        params, state0, pts)
    _assert_dc_bits(k, p)
    assert k.xs.shape == (lanes, len(pts), cc.np1)
    if max_iter == 2:
        assert not bool(k.conv.any()) and bool((k.iters == 2).all())
        return
    if case != "mos_nested":
        assert bool(k.conv.all())
    if case.startswith("lm_diode"):  # every point in 2 iterations
        assert bool((k.iters == 2).all())
        return
    # the first warp's segments (one lane at np1 > 16) end their Newton at
    # different iterations
    per_warp = 32 // (4 if cc.np1 <= 4 else 8 if cc.np1 <= 8 else
                      16 if cc.np1 <= 16 else 32)
    assert len(set(k.iters[:per_warp].flatten().tolist())) > 1


@pytest.mark.parametrize("kind", ["op", "dc"])
def test_opdc_segment_refuses_a_short_slice(cuda, monkeypatch, kind):
    """A launch whose lane_doubles is one short of the deck's counts reads
    and writes no slice: every lane (and point) returns x all NaN, 0
    iterations and not converged, the OP its jv0."""
    cc = ts.compile_circuit(ts.parse(MIXED16))
    params, _ = ts.batch_params(cc, _rc_spread(cc, 37), device=cuda)
    state0 = ts.init_state(cc, device=cuda)
    mod = op if kind == "op" else dc
    need = mod.lane_doubles(run_plan.make_plan(cc, "op"))
    monkeypatch.setattr(mod, "lane_doubles", lambda plan: need - 1)
    if kind == "op":
        plan, dev, dyn, x0, jv0, sc = _first_op_inputs(MIXED16, 37, cuda)
        k = op.launch_op_kernel(plan, dev, dyn, x0, jv0, sc)
        torch.cuda.synchronize()
        assert bool(k.x.isnan().all()) and torch.equal(k.jv, jv0)
        assert not k.iters.any() and not k.conv.any()
    else:
        k = dc.make_dc_fused(cc, (1,), DEFAULTS)(params, state0,
                                                 np.linspace(0.0, 3.0, 5))
        torch.cuda.synchronize()
        assert bool(k.xs.isnan().all())
        assert not k.iters.any() and not k.conv.any()


@pytest.mark.parametrize("deck,semantics,kind,tag", [
    (HWR, "compat", "op", "op_seg_kernel<4, false, true>"),
    (HWR, "physics", "op", "op_seg_kernel<4, true, true>"),
    (newton_ladder(8), "compat", "op", "op_seg_kernel<8, false, true>"),
    (newton_ladder(9), "physics", "op", "op_seg_kernel<16, true, true>"),
    (MIXED16, "compat", "op", "op_seg_kernel<32, false, true>"),
    (DIODE_IV, "compat", "dc", "dc_seg_kernel<4, false, true>"),
    (DIODE_IV, "physics", "dc", "dc_seg_kernel<4, true, true>"),
    (LM_DIODE, "compat", "dc", "dc_seg_kernel<8, false, true>"),
    (newton_ladder(16), "physics", "dc", "dc_seg_kernel<16, true, true>"),
    (MIXED16, "compat", "dc", "dc_seg_kernel<32, false, true>")],
    ids=["op_4", "op_4_physics", "op_8", "op_16_physics", "op_32", "dc_4",
         "dc_4_physics", "dc_8", "dc_16_physics", "dc_32"])
def test_opdc_segment_launch_shape(cuda, deck, semantics, kind, tag):
    """Each OP and DC sweep instantiation launches its segment kernel (by
    its name in a profile of the card, the one kernel of its kind in the
    run) in the shape the op library reports: segments of W threads,
    128 / W lanes a block, enough blocks for 259 lanes, the table and the
    slices (the lane's inputs, junction voltages and value slots) within
    a block's shared memory."""
    from torch.profiler import ProfilerActivity, profile

    cc = ts.compile_circuit(ts.parse(deck))
    params, axes = ts.batch_params(cc, _rc_spread(cc, 259), device=cuda)
    plan = run_plan.make_plan(cc, "op")
    lane = (op if kind == "op" else dc).lane_doubles(plan)
    got = op.segment_shape(plan, 259, lane)
    w = int(tag[tag.index("<") + 1:tag.index(",")])
    assert got[:4] == (w, 128 // w, -(-259 // (128 // w)), 128)
    base = (w + 2) * (w + 1) + w
    assert got[4] == 8 * ((plan.topo.size + 3) // 4 * 2
                          + (128 // w) * (base + (lane + 1) // 2 * 2))
    assert got[4] <= 227 * 1024 and got[6] == 1
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if kind == "op":
            ts.run_op_batch(cc, params, axes, semantics=semantics)
        else:
            ts.run_dc_batch(cc, (0,), params, axes, [0.1, 0.5, 0.9],
                            semantics=semantics)
        torch.cuda.synchronize()
    key = tag[:tag.index("<")]
    names = {e.key for e in prof.key_averages() if key in e.key}
    assert len(names) == 1, names
    assert tag in names.pop().replace(" ", "").replace(",", ", ")


# ---------------------------------------------------- one lane (B = 1)


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 9, 16, 17, 32, 33, 48, 49, 64,
                               65, 96, 97, 127, 144, 145, 168, 169])
def test_single_lane_gj_and_stamped_are_bit_identical(cuda, n):
    """The single-instance API's solves: one system a launch (B = 1), on
    csrc/gj_kernel.cu and every body of csrc/stamped_solve.cu (a warp
    segment with one live lane to 32, a warp to 64, a block above), a
    regular, a singular and a NaN system each alone: the same bits as the
    plain versions."""
    from toyspice_tpu_torch.ops import solve

    a8, b8 = _dense_sets(n, 8, cuda)
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                         np.arange(1, n))
    g = torch.zeros(1, dtype=torch.float64, device=cuda)
    for lane in (0, 5, 6):
        a, b = a8[lane:lane + 1].contiguous(), b8[lane:lane + 1].contiguous()
        want = solve.gj_plain(a, b)
        gb = solve.launch_gj.launches
        sb = solve_stamped.launch_stamped.launches
        got = solve.linear_solve(a, b)
        vals = a[:, 1:, :].reshape(1, -1).contiguous()
        rv = b[:, 1:].contiguous()
        st = fn(vals, rv, g)
        torch.cuda.synchronize()
        assert solve.launch_gj.launches == gb + 1
        assert solve_stamped.launch_stamped.launches == sb + 1
        assert _same_bits(got, want), lane
        assert _same_bits(st, solve_stamped.solve_plain(fn.pattern, vals, rv,
                                                        g)), lane
        assert bool(torch.isfinite(want).all()) == (lane == 0)


@pytest.mark.parametrize("np1", [2, 8, 9, 16, 17, 32])
def test_single_instance_ac_kernel_is_bit_identical(cuda, np1):
    """The AC kernel with one system a frequency (B = 1), one and three
    frequencies: the same bits as the plain version."""
    rng = np.random.default_rng(100 + np1)
    g = rng.normal(size=(1, np1, np1)) + 3.0 * np.eye(np1)
    bh = rng.normal(size=(1, np1, np1)) * 1e-3
    r = rng.normal(size=(1, 2 * np1))
    args = [torch.as_tensor(v, device=cuda) for v in (g, bh, r)]
    for freqs in (np.array([1e3]), np.array([0.0, 10.0, 1e4])):
        before = ac.launch_ac_kernel.launches
        k = ac.ac_solve_batch(*args, freqs)
        torch.cuda.synchronize()
        assert ac.launch_ac_kernel.launches == before + 1
        assert _same_bits(k, ac.ac_solve_batch(*args, freqs,
                                               solve=ac.ac_plain))


@pytest.mark.parametrize("name", ["divider_op.cir", "ce_amplifier_op.cir",
                                  "diode_iv_sweep.cir", "ce_amplifier_ac.cir",
                                  "rc_lowpass_tran.cir",
                                  "half_wave_rectifier.cir"])
def test_run_analysis_on_the_card_matches_its_plain_versions(
        cuda, name, monkeypatch):
    """run_analysis on the card launches the stamped solve (and on a
    nonlinear OP or AC the GJ kernel) and gives the Results of the same
    call under TOYSPICE_SOLVER=xla (the plain versions on the card, no
    launch) bit for bit."""
    import os

    from toyspice_tpu_torch.ops import solve

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "circuits", name)
    monkeypatch.delenv("TOYSPICE_SOLVER", raising=False)
    sb, gb = solve_stamped.launch_stamped.launches, solve.launch_gj.launches
    k = ts.run_analysis(path)
    assert solve_stamped.launch_stamped.launches > sb
    monkeypatch.setenv("TOYSPICE_SOLVER", "xla")
    s1, g1 = solve_stamped.launch_stamped.launches, solve.launch_gj.launches
    p = ts.run_analysis(path)
    assert (solve_stamped.launch_stamped.launches, solve.launch_gj.launches
            ) == (s1, g1)
    assert set(k) == set(p)
    for key in p:
        assert np.array_equal(k[key], p[key], equal_nan=True), key
    if name in ("ce_amplifier_op.cir", "ce_amplifier_ac.cir"):
        assert g1 > gb


def test_tran_impl_xla_takes_the_plain_run_on_the_card(cuda, monkeypatch):
    """TOYSPICE_TRAN_IMPL=xla: the run and OP kernels' plain versions on
    the card, no launch, the kernels' bits."""
    cc, cfg, params, state0 = _inputs(
        _deck_text("half_wave_rectifier.cir"), 8, cuda)[:4]
    monkeypatch.delenv("TOYSPICE_TRAN_IMPL", raising=False)
    k = ts.make_tran_batch(cc, cfg, None)(params, state0)
    monkeypatch.setenv("TOYSPICE_TRAN_IMPL", "xla")
    r0, o0 = run.launch_run_kernel.launches, op.launch_op_kernel.launches
    p = ts.make_tran_batch(cc, cfg, None)(params, state0)
    assert (run.launch_run_kernel.launches, op.launch_op_kernel.launches) \
        == (r0, o0)
    for key in ("accepted", "attempts", "fail", "nr_iters"):
        assert torch.equal(getattr(k, key), getattr(p, key)), key
    assert _same_bits(k.t_final, p.t_final)


def _deck_text(name):
    import os

    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "circuits", name)) as f:
        return f.read()


def test_wrappers_launch_under_every_override(cuda, monkeypatch):
    """The engine overrides are read where an engine is built: a wrapper
    given card tensors launches its kernel under TOYSPICE_SOLVER=xla and
    TOYSPICE_TRAN_IMPL=xla alike, with the plain version's bits."""
    from toyspice_tpu_torch.ops import solve

    monkeypatch.setenv("TOYSPICE_SOLVER", "xla")
    monkeypatch.setenv("TOYSPICE_TRAN_IMPL", "xla")
    a, b = _dense_sets(9, 8, cuda)
    a, b = a[:1].contiguous(), b[:1].contiguous()
    before = solve.launch_gj.launches
    x = solve.linear_solve(a, b)
    torch.cuda.synchronize()
    assert solve.launch_gj.launches == before + 1
    assert _same_bits(x, solve.gj_plain(a, b))
    rng = np.random.default_rng(9)
    g = torch.as_tensor(rng.normal(size=(1, 4, 4)) + 3.0 * np.eye(4),
                        device=cuda)
    bh = torch.as_tensor(rng.normal(size=(1, 4, 4)) * 1e-3, device=cuda)
    r = torch.as_tensor(rng.normal(size=(1, 8)), device=cuda)
    before = ac.launch_ac_kernel.launches
    k = ac.ac_solve_batch(g, bh, r, np.array([1e3]))
    torch.cuda.synchronize()
    assert ac.launch_ac_kernel.launches == before + 1
    assert _same_bits(k, ac.ac_solve_batch(g, bh, r, np.array([1e3]),
                                           solve=ac.ac_plain))
