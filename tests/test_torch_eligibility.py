"""What the port's transient and OP do not cover raise NotImplementedError
with the reason.  Compat and physics semantics run every deck of R, C, L,
LM, K, V, I, D, Q and M within the kernels' caps (any np1: to 64 on
warps, past it a block a lane; 32 sources, a stamp plan within the 48 KB
shared-memory table: 718 diodes in a bank), magnetic decks with diodes
included, and their OP, DC sweep and AC; a deck past the kernels' caps
takes the general engine (engine "general", with the kernels' reason);
trapezoidal integration under compat stays refused."""

import os
import re

import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.options import SimOptions
from toyspice_tpu_torch.ops import op, run

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RLC = """* RLC Test
.tran 0.01m 2ms
Vin 1 0 SIN(0 5 1k)
R1 1 2 100
L1 2 3 1m
C1 3 0 1u
"""


def _ladder(stages):
    """An RC ladder with np1 = stages + 3: the ground row, nodes
    1..stages+1 and the source's branch row."""
    lines = ["* rc ladder", ".tran 0.01m 1m", "Vin 1 0 SIN(0 1 1k)"]
    for k in range(1, stages + 1):
        lines.append(f"R{k} {k} {k + 1} 100")
        lines.append(f"C{k} {k + 1} 0 1n")
    return "\n".join(lines) + "\n"


def _many_sources(count):
    """``count`` DC current sources into one resistor (np1 = 2)."""
    lines = ["* many sources", ".tran 0.01m 1m", "R1 1 0 1k"]
    lines += [f"I{k} 0 1 DC 1m" for k in range(count)]
    return "\n".join(lines) + "\n"


def _diodes(count):
    """``count`` diodes in series from a DC source (np1 = count + 3)."""
    lines = ["* diode chain", ".tran 0.01m 1m", "V1 1 0 DC 5", "R1 1 2 1k"]
    lines += [f"D{k} {k + 2} {k + 3} DM" for k in range(count - 1)]
    lines += [f"D{count - 1} {count + 1} 0 DM", ".model DM D (Is=1e-14)"]
    return "\n".join(lines) + "\n"


def _diode_bank(count):
    """``count`` diodes in parallel behind 1 kΩ (np1 = 4): past 718 their
    stamp plan outgrows the kernels' shared-memory table."""
    lines = ["* diode bank", ".tran 0.01m 1m", "V1 1 0 DC 5", "R1 1 2 1k"]
    lines += [f"D{k} 2 0 DM" for k in range(count)]
    lines += [".model DM D (Is=1e-14)"]
    return "\n".join(lines) + "\n"


def _mosfet_bank(count):
    """``count`` diode-connected NMOS in parallel behind 1 kΩ (np1 = 4)."""
    lines = ["* nmos bank", ".tran 1u 20u", "V1 1 0 SIN(3 2 100k)",
             "R1 1 2 1k"]
    lines += [f"M{k} 2 2 0 0 NM L=2u W=20u" for k in range(count)]
    lines += [".model NM NMOS(Vto=1 Kp=2e-5)"]
    return "\n".join(lines) + "\n"


TABLE_CAP = "exceeds the kernel's shared-memory table cap"


def _build(text, **kw):
    cc = ts.compile_circuit(ts.parse(text))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    params, axes = ts.batch_params(cc, {}, device="cpu")
    return ts.make_tran_batch(cc, cfg, axes, **kw)


def _deck(name):
    with open(os.path.join(ROOT, "circuits", name)) as f:
        return f.read()


# a transformer whose secondary feeds a diode: K with a nonlinear device
K_DIODE = """* transformer into a diode
.tran 5u 1m
Vpri in 0 SIN(0 10 2k)
Rpri in p1 4.7
Lp p1 0 8m
Ls s1 0 2m
K1 Lp Ls 0.995
D1 s1 out DM
Rl out 0 150
.model DM D (Is=1e-14)
"""


@pytest.mark.parametrize("text,kw,reason,general", [
    (_diode_bank(719), {}, "(719 diodes, BJTs and MOSFETs) " + TABLE_CAP,
     True),
    (RLC, {"store": "bogus"}, "store='bogus'", False),
    (RLC, {"opts": SimOptions(integration="trap")},
     "integration='trap' requires semantics='physics'", False),
    (K_DIODE, {"opts": SimOptions(integration="trap")},
     "integration='trap' requires semantics='physics'", False),
    (_many_sources(33), {}, "33 sources exceed the kernel's cap of 32",
     True),
    (_ladder(62), {}, None, False),
    (_ladder(130), {}, None, False),
], ids=["diode", "store_bogus", "trap", "trap_mutual_with_diode",
        "source_cap", "np1_cap", "np1_past_nbig"])
def test_ineligible_raises_with_reason(text, kw, reason, general):
    """Past the kernels' caps the general engine takes the run, with the
    kernels' reason; past the general engine's too, it raises.  np1 is no
    cap: past 64 rows (np1 = 65, and 133 past NBIG) the run engine takes
    the deck on the kernels' block bucket."""
    if reason is None:
        fn = _build(text, **kw)
        assert fn.engine == "run" and "whole-run kernel" in fn.engine_reason
        return
    if general:
        fn = _build(text, **kw)
        assert fn.engine == "general" and reason in fn.engine_reason
        return
    with pytest.raises(NotImplementedError, match="no transient engine") as e:
        _build(text, **kw)
    assert reason in str(e.value)


def test_np1_cap_boundary():
    """np1 = 64 is the 64-row bucket's (a warp a lane), 65 the block
    bucket's (a block a lane); both run on the kernels."""
    ok = ts.compile_circuit(ts.parse(_ladder(61)))
    assert ok.np1 == run.WARP_NP1 == 64
    assert run.run_ineligible_reason(ok, "compat", "none",
                                     SimOptions()) is None
    assert run.run_bucket(run.make_plan(ok)) == 64
    big = ts.compile_circuit(ts.parse(_ladder(62)))
    assert big.np1 == 65
    assert run.run_ineligible_reason(big, "compat", "none",
                                     SimOptions()) is None
    assert run.run_bucket(run.make_plan(big)) == run.BLOCK_BUCKET


def test_make_tran_run_refuses_ineligible():
    cc = ts.compile_circuit(ts.parse(_deck("saturating_transformer.cir")))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    with pytest.raises(NotImplementedError, match="integration='trap'"):
        run.make_tran_run(cc, cfg, SimOptions(integration="trap"))
    with pytest.raises(NotImplementedError, match="store='bogus'"):
        run.make_tran_run(cc, cfg, semantics="physics", store="bogus")


@pytest.mark.parametrize("text,kw", [
    (_deck("coupled_inductors.cir"), {"semantics": "physics"}),
    (_deck("saturating_transformer.cir"), {"semantics": "physics"}),
    (K_DIODE, {"semantics": "physics",
               "opts": SimOptions(integration="trap")}),
    (K_DIODE, {}),
], ids=["mutual_physics", "magnetic_physics", "mutual_with_diode_physics",
        "mutual_with_diode"])
def test_magnetic_decks_select_the_run_engine(text, kw):
    """Physics with LM or K (the live Jiles-Atherton core, the physics
    mutual) and LM or K with a diode run through the run kernel; a
    nonlinear or physics deck takes its OP first."""
    fn = _build(text, **kw)
    assert fn.engine == "run"
    assert fn.op is not None


@pytest.mark.parametrize("integration", ["be", "trap"])
def test_physics_decks_select_the_run_and_store_engines(integration):
    """Every deck runs under physics through the PHYS run kernel
    (store='none') or its store instantiation (store='full' and resume),
    the magnetic ones included."""
    opts = SimOptions(integration=integration)
    for name in TRAN_DECKS:
        fn = _build(_deck(name), semantics="physics", opts=opts)
        assert fn.engine == "run", name
        assert f"physics/{integration}" in fn.engine_reason
        fn = _build(_deck(name), semantics="physics", opts=opts,
                    store="full")
        assert fn.engine == "store", name
        fn = _build(_deck(name), semantics="physics", opts=opts,
                    resume=True)
        assert fn.engine == "store", name


def test_physics_transient_builds_its_op():
    """A physics run starts at the bias point, so a linear deck takes the
    linear OP unless UIC; a resumed run takes none."""
    from toyspice_tpu_torch.engine.batch import linear_op_ineligible_reason

    lin = ts.compile_circuit(ts.parse(RLC))
    tp = lin.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    assert linear_op_ineligible_reason(lin, "physics") is None
    assert run.make_tran_run(lin, cfg, semantics="physics").op is not None
    assert run.make_tran_run(lin, cfg._replace(uic=True),
                             semantics="physics").op is None
    assert run.make_tran_run(lin, cfg, semantics="physics",
                             resume=True).op is None
    nl = ts.compile_circuit(ts.parse(_deck("half_wave_rectifier.cir")))
    assert run.make_tran_run(nl, cfg, semantics="physics").op is not None


TRAN_DECKS = ("rc_lowpass_tran.cir", "rl_tran.cir", "rlc_ringdown.cir",
              "pulse_drive.cir", "pwl_drive.cir", "current_sin.cir",
              "half_wave_rectifier.cir", "nmos_inverter_tran.cir",
              "coupled_inductors.cir", "saturating_transformer.cir")


def test_eligible_decks_select_the_run_engine():
    for name in TRAN_DECKS:
        fn = _build(_deck(name))
        assert fn.engine == "run", name
        assert "whole-run kernel" in fn.engine_reason


@pytest.mark.parametrize("name", ["coupled_inductors.cir",
                                  "saturating_transformer.cir"])
def test_magnetic_decks_run(name):
    cc = ts.compile_circuit(ts.parse(_deck(name)))
    assert run.run_ineligible_reason(cc, "compat", "none",
                                     SimOptions()) is None
    assert run.run_ineligible_reason(cc, "compat", "full",
                                     SimOptions()) is None


def test_store_full_selects_the_store_engine():
    for name in TRAN_DECKS:
        fn = _build(_deck(name), store="full")
        assert fn.engine == "store", name
        assert "store instantiation" in fn.engine_reason


def test_nonlinear_device_cap_boundary():
    """The count of diodes, BJTs and MOSFETs is capped by the stamp plan's
    shared-memory table alone (718 diodes in a bank), at least 32 of any
    kind: 61 diodes in series at np1 = 64 and 32 MOSFETs on a 4-row deck
    (the run kernel's 64-row bucket) are eligible too."""
    for text in (_diode_bank(718), _diodes(61), _mosfet_bank(32)):
        ok = ts.compile_circuit(ts.parse(text))
        assert run.run_ineligible_reason(ok, "compat", "none",
                                         SimOptions()) is None
        assert op.op_fused_ineligible_reason(ok) is None
    big = ts.compile_circuit(ts.parse(_diode_bank(719)))
    assert TABLE_CAP in op.op_fused_ineligible_reason(big)


@pytest.mark.parametrize("text,kw,reason", [
    (_deck("divider_op.cir"), {}, "linear circuit"),
    # compat under trap is served as BE (tests/test_torch_compat_trap.py)
    (_deck("ce_amplifier_op.cir"), {"semantics": "bogus"},
     "semantics='bogus'"),
    (_deck("saturating_transformer.cir"), {"semantics": "physics"},
     "linear circuit"),
    (_diode_bank(719), {}, TABLE_CAP),
], ids=["linear", "physics", "magnetic", "device_cap"])
def test_op_ineligible_reasons(text, kw, reason):
    cc = ts.compile_circuit(ts.parse(text))
    kw = dict(kw)
    opts = kw.pop("opts", SimOptions())
    assert reason in op.op_fused_ineligible_reason(cc, opts=opts, **kw)
    with pytest.raises(NotImplementedError, match="not eligible"):
        op.make_op_fused(cc, opts, **kw)


def test_op_serves_physics():
    for name in ("ce_amplifier_op.cir", "half_wave_rectifier.cir",
                 "nmos_inverter_tran.cir", "diode_iv_sweep.cir"):
        cc = ts.compile_circuit(ts.parse(_deck(name)))
        for opts in (SimOptions(), SimOptions(integration="trap")):
            assert op.op_fused_ineligible_reason(cc, "physics", opts) is None
    assert "semantics='bogus'" in op.op_fused_ineligible_reason(
        cc, "bogus")


def test_nonlinear_transient_builds_its_op():
    cc = ts.compile_circuit(ts.parse(_deck("half_wave_rectifier.cir")))
    tp = cc.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    assert run.make_tran_run(cc, cfg).op is not None
    assert run.make_tran_run(cc, cfg._replace(uic=True)).op is None
    lin = ts.compile_circuit(ts.parse(RLC))
    tp = lin.netlist.tran
    cfg = ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)
    assert run.make_tran_run(lin, cfg).op is None


def _ac(text):
    """The deck with an AC card in place of its analysis card."""
    lines = [ln for ln in text.splitlines()
             if not ln.lower().startswith((".tran", ".op", ".dc", ".ac"))]
    return "\n".join(lines[:1] + [".ac DEC 5 10 100k"] + lines[1:]) + "\n"


@pytest.mark.parametrize("text,kw,reason", [
    (_deck("ce_amplifier_ac.cir"), {"semantics": "bogus"},
     "semantics='bogus'"),
    (_ac(_ladder(30)), {}, None),
    (_ac(_diode_bank(719)), {}, TABLE_CAP),
], ids=["physics", "np1_cap", "device_cap"])
def test_ac_ineligible_raises_with_reason(text, kw, reason):
    """The AC kernel's reasons; past the bias's caps the general AC takes
    the deck (engine "general"), and what neither serves raises.  The AC
    kernel has no np1 cap: a deck of np1 = 33 takes it (engine "fused")."""
    from toyspice_tpu_torch.engine.ac import make_ac_batch
    from toyspice_tpu_torch.ops.ac import ac_ineligible_reason

    cc = ts.compile_circuit(ts.parse(text))
    if reason is None:
        assert cc.np1 == 33 and ac_ineligible_reason(cc, **kw) is None
        fn = make_ac_batch(cc, None, **kw)
        assert fn.engine == "fused" and "AC kernel eligible" in \
            fn.engine_reason
        xr, xi, opr = ts.run_ac_batch(cc, ts.batch_params(
            cc, {}, device="cpu")[0], None, [1e3], **kw)
        assert xr.shape == (1, 1, cc.np1) and bool(opr.converged.all())
        assert bool(torch.isfinite(xr).all() & torch.isfinite(xi).all())
        return
    assert reason in ac_ineligible_reason(cc, **kw)
    if "cap" in reason:
        fn = make_ac_batch(cc, None, **kw)
        assert fn.engine == "general" and reason in fn.engine_reason
        xr, _, opr = ts.run_ac_batch(cc, ts.batch_params(
            cc, {}, device="cpu")[0], None, [1e3], **kw)
        assert xr.shape == (1, 1, cc.np1) and bool(opr.converged.all())
        return
    with pytest.raises(NotImplementedError, match="no AC engine") as e:
        make_ac_batch(cc, None, **kw)
    assert reason in str(e.value)
    with pytest.raises(NotImplementedError, match="no AC engine"):
        ts.run_ac_batch(cc, ts.batch_params(cc, {}, device="cpu")[0], None,
                        [1e3], **kw)


def test_ac_np1_cap_boundary():
    """No np1 cap: the warp bodies' last size (32), the block bodies'
    first (33), lc16's 36 and lc31's 66 all take the AC kernel."""
    from toyspice_tpu_torch.engine.ac import make_ac_batch
    from toyspice_tpu_torch.ops.ac import ac_ineligible_reason

    for stages, np1 in ((29, 32), (30, 33), (33, 36), (63, 66)):
        ok = ts.compile_circuit(ts.parse(_ac(_ladder(stages))))
        assert ok.np1 == np1 and ac_ineligible_reason(ok) is None
        assert make_ac_batch(ok, None).engine == "fused"


@pytest.mark.parametrize("text,kw,reason", [
    (_deck("diode_iv_sweep.cir"), {"semantics": "bogus"},
     "semantics='bogus'"),
    (_deck("divider_op.cir"), {"semantics": "bogus"}, "semantics='bogus'"),
    (_diode_bank(719), {}, TABLE_CAP),
    (_ladder(126), {}, None),
], ids=["physics", "physics_linear", "device_cap", "np1_cap"])
def test_dc_and_linear_op_ineligible_raise_with_reason(text, kw, reason):
    """Past the OP kernel's device cap the general engine takes the OP and
    the sweep (engine "general"); a linear deck past NBIG (np1 = 129)
    takes the linear OP and sweep, whose stamped solve has no cap on np1,
    and converges; what none serves raises."""
    from toyspice_tpu_torch.engine.batch import select_op_engine

    cc = ts.compile_circuit(ts.parse(text))
    params = ts.batch_params(cc, {}, device="cpu")[0]
    if reason is None:
        assert cc.np1 == 129 and select_op_engine(cc, **kw)[0] == "linear"
        xs, conv = ts.run_dc_batch(cc, (0,), params, None, [0.0, 1.0], **kw)
        assert xs.shape == (1, 2, cc.np1) and bool(conv.all())
        assert bool(torch.isfinite(xs).all())
        assert bool(ts.run_op_batch(cc, params, **kw).converged.all())
        return
    if reason == TABLE_CAP:
        engine, why = select_op_engine(cc, **kw)
        assert engine == "general" and reason in why
        xs, conv = ts.run_dc_batch(cc, (0,), params, None, [0.0, 1.0], **kw)
        assert xs.shape == (1, 2, cc.np1) and bool(conv.all())
        assert bool(ts.run_op_batch(cc, params, **kw).converged.all())
        return
    with pytest.raises(NotImplementedError, match="no OP engine") as e:
        ts.run_dc_batch(cc, (0,), params, None, [0.0, 1.0], **kw)
    assert reason in str(e.value)
    with pytest.raises(NotImplementedError, match=re.escape(reason)):
        ts.run_op_batch(cc, params, **kw)


def test_linear_decks_select_the_linear_engines():
    from toyspice_tpu_torch.engine.batch import select_op_engine
    from toyspice_tpu_torch.ops.ac import ac_ineligible_reason
    from toyspice_tpu_torch.ops.op import op_fused_ineligible_reason

    for name in ("divider_op.cir", "rc_lowpass_tran.cir", "rl_tran.cir",
                 "rlc_ringdown.cir", "current_sin.cir"):
        cc = ts.compile_circuit(ts.parse(_deck(name)))
        assert select_op_engine(cc)[0] == "linear", name
        assert ac_ineligible_reason(cc) is None, name
        assert "linear circuit" in op_fused_ineligible_reason(cc), name
    for name in ("diode_iv_sweep.cir", "ce_amplifier_ac.cir",
                 "half_wave_rectifier.cir", "nmos_inverter_tran.cir"):
        cc = ts.compile_circuit(ts.parse(_deck(name)))
        assert select_op_engine(cc)[0] == "fused", name
        assert ac_ineligible_reason(cc) is None, name
        assert op_fused_ineligible_reason(cc) is None, name


def test_physics_selects_the_same_op_engines():
    """The OP stamps of a linear deck do not depend on the semantics, so a
    physics linear deck takes the stamped solve; a nonlinear one the OP
    kernel's physics flavour; AC serves both."""
    from toyspice_tpu_torch.engine.batch import select_op_engine
    from toyspice_tpu_torch.ops.ac import ac_ineligible_reason

    for name, engine in (("divider_op.cir", "linear"),
                         ("rlc_ringdown.cir", "linear"),
                         ("diode_iv_sweep.cir", "fused"),
                         ("ce_amplifier_ac.cir", "fused")):
        cc = ts.compile_circuit(ts.parse(_deck(name)))
        assert select_op_engine(cc, "physics")[0] == engine, name
        assert ac_ineligible_reason(cc, "physics") is None, name


@pytest.mark.parametrize("name,engine", [
    ("coupled_inductors.cir", "linear"),
    ("saturating_transformer.cir", "linear")])
@pytest.mark.parametrize("semantics", ["compat", "physics"])
def test_magnetic_decks_select_the_op_and_ac_engines(name, engine,
                                                     semantics):
    """A magnetic deck's OP and DC sweep stamp each winding's +1e-3 branch
    diagonal and no mutual (the stamped solve on a linear deck); its AC
    stamps -ωL and -ωM on the branch rows."""
    from toyspice_tpu_torch.engine.batch import select_op_engine
    from toyspice_tpu_torch.ops.ac import ac_ineligible_reason

    cc = ts.compile_circuit(ts.parse(_deck(name)))
    assert select_op_engine(cc, semantics)[0] == engine
    assert ac_ineligible_reason(cc, semantics) is None
    cc = ts.compile_circuit(ts.parse(K_DIODE))
    assert select_op_engine(cc, semantics)[0] == "fused"
    assert op.op_fused_ineligible_reason(cc, semantics) is None
