"""Decks past the kernels' former caps (more than 32 sources, a stamp plan
past 48 KB), the cells of chip_smoke.py phase 38 and their cut versions,
and on the CPU, without JAX:

* the placement of the table and the lanes' slices (``ops/run.py
  placement``, csrc/newton.cuh ``fit_bucket`` and ``block_place``) at each
  of its edges: the table beside the slices, the table alone in shared
  memory, the slice alone, and neither;
* the engines the full decks of the cells, the two CMOS rings, the
  719-diode bank and 33 sources take (compile only): "run", "store" with
  ``store='full'`` and streamed, "fused" for the OP and the DC sweep of a
  nonlinear deck, and no reason that names a cap; the general engine only
  under the overrides;
* a size past the kernels' int32 launch arguments raises ValueError.

tests/test_torch_past_caps_{ring,bus,pv}.py hold the cut decks to the JAX
package's general engine."""

from types import SimpleNamespace

import numpy as np
import pytest

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.engine.batch import make_dc_engine, select_op_engine
from toyspice_tpu_torch.ops import run


def nmos_ring(stages, tstop="500n"):
    """A resistor-load NMOS ring oscillator of ``stages`` inverters (odd),
    kicked by a current pulse into n0; np1 = stages + 3."""
    lines = [f"* {stages}-stage NMOS ring oscillator", f".tran 1n {tstop} uic",
             "VDD vdd 0 DC 5", "IK n0 0 PULSE(0 200u 0 1n 1n 5n 1)"]
    for i in range(stages):
        out = f"n{(i + 1) % stages}"
        lines += [f"RP{i} vdd {out} 10k", f"MN{i} {out} n{i} 0 0 NSW",
                  f"CL{i} {out} 0 1p"]
    lines.append(".model NSW NMOS (VTO=1.1 KP=3m LAMBDA=0.01)")
    return "\n".join(lines) + "\n"


def cmos_ring(stages, tstop="2n"):
    """A level-1 CMOS ring of ``stages`` inverters (odd) with 5 fF loads,
    kicked by a current pulse into n0; np1 = stages + 3."""
    lines = ["* ring", f".tran 10p {tstop}", "VDD vdd 0 DC 1.8",
             "IK n0 0 PULSE(0 100u 0 50p 50p 100p 1)"]
    for i in range(stages):
        out = f"n{(i + 1) % stages}"
        lines += [f"MP{i} {out} n{i} vdd vdd PM W=2u L=0.18u",
                  f"MN{i} {out} n{i} 0 0 NM W=1u L=0.18u",
                  f"CL{i} {out} 0 5f"]
    lines += [".model NM NMOS(LEVEL=1 VTO=0.5 KP=200u)",
              ".model PM PMOS(LEVEL=1 VTO=-0.5 KP=80u)"]
    return "\n".join(lines) + "\n"


def pv_module(cells, bypass=24, points=".dc VLOAD 0 60 0.5"):
    """``cells`` PV cells in series (a photocurrent, a diode and a shunt
    each), a bypass diode across every ``bypass`` cells, a series
    resistance into the swept load source; np1 = cells + 3, cells + 1
    sources."""
    lines = [f"* {cells}-cell PV module", points]
    for i in range(cells):
        a, b = ("0" if i == 0 else f"c{i}"), f"c{i + 1}"
        lines += [f"IPH{i} {b} {a} DC 8.5", f"D{i} {b} {a} DCELL",
                  f"RSH{i} {b} {a} 250"]
    for k in range(cells // bypass):
        a = "0" if k == 0 else f"c{k * bypass}"
        lines.append(f"DB{k} {a} c{(k + 1) * bypass} DBYP")
    lines += [f"RS c{cells} out 0.3", "VLOAD out 0 DC 0",
              ".model DCELL D(IS=1e-10 N=1.2)",
              ".model DBYP D(IS=1e-8 N=1.0)"]
    return "\n".join(lines) + "\n"


def bus(lines_, tstop="10n"):
    """A parallel bus of ``lines_`` RC lines, each driven by its own PULSE
    source through 50 Ω, neighbours coupled by 0.2 pF; np1 = 3 lines_ +
    1."""
    lines = [f"* {lines_}-line coupled bus", f".tran 0.05n {tstop}"]
    for i in range(lines_):
        lines += [f"V{i} d{i} 0 PULSE(0 1 {0.1 * i:.1f}n 0.1n 0.1n 2n 5n)",
                  f"R{i} d{i} l{i} 50", f"C{i} l{i} 0 1p"]
        if i:
            lines.append(f"CC{i} l{i - 1} l{i} 0.2p")
    return "\n".join(lines) + "\n"


def many_sources(count, np1):
    """``count`` DC current sources spread over the nodes of an RC ladder
    of np1 - 2 nodes from a SIN source (np1 unknowns)."""
    nodes = np1 - 2
    lines = [f"* {count} sources, np1 = {np1}", ".tran 0.01m 0.2m",
             "Vin 1 0 SIN(0 1 5k)"]
    for k in range(1, nodes):
        lines += [f"R{k} {k} {k + 1} 100", f"C{k} {k + 1} 0 10n"]
    lines.append(f"R{nodes} {nodes} 0 1k")
    lines += [f"I{k} 0 {k % nodes + 1} DC {0.01 * (k % 7 + 1):.2f}m"
              for k in range(count)]
    return "\n".join(lines) + "\n"


def resistor_bank(count, diode=False):
    """``count`` resistors in parallel from a SIN source's node to a
    capacitor's (np1 = 4), with ``diode`` a diode across the capacitor: a
    deck whose stamp plan alone outgrows a block's shared memory past
    about 1,650 (np1's segment bucket, the table in device memory)."""
    lines = ["* resistor bank", ".tran 0.01m 0.2m", "Vin 1 0 SIN(0 1 5k)",
             "C1 2 0 1u"]
    lines += [f"R{k} 1 2 {1e3 * count * (1 + k % 3)}" for k in range(count)]
    if diode:
        lines += ["D1 2 0 DM", ".model DM D (Is=1e-14)"]
    return "\n".join(lines) + "\n"


def coupled_sources(count):
    """circuits/coupled_inductors.cir's 2:1 transformer with ``count`` DC
    current sources into its secondary's load: LM-free magnetic stamps (K)
    beside more than 32 sources."""
    lines = ["* transformer with many sources", ".tran 5u 0.2m",
             "Vpri in 0 SIN(0 10 2k)", "Rpri in p1 4.7", "Lp p1 0 8m",
             "Ls s1 0 2m", "K1 Lp Ls 0.995", "Rsec s1 0 150"]
    lines += [f"I{k} 0 s1 DC {0.1 * (k % 5 + 1):.1f}m" for k in range(count)]
    return "\n".join(lines) + "\n"


# --------------------------------------------------- the placement's edges


def _plan(np1, words):
    """What ``placement`` reads of a plan: np1 and the table's words."""
    return SimpleNamespace(np1=np1, topo=np.zeros(words, np.int32))


def _words(doubles):
    """Table words of exactly ``doubles`` doubles of shared memory."""
    return 2 * doubles


def _seg(b, lane, rows=0):
    return (b + 2) * (b + 1) + b + run.even(rows + lane)


ROOM = run.SEG_SMEM // 8  # doubles of a segment block's shared memory


def test_block_bucket_table_beside_the_slice_then_one_of_them():
    """np1 = 100 (the block bucket): the table beside the slice up to
    BLOCK_ROOM together, one 16-byte row of table more and the one
    BLOCK_SLICE_FIRST names stays in shared memory, the other leaves."""
    lane = 10
    slice_ = run.block_slice(100, lane)
    edge = run.BLOCK_ROOM - slice_
    assert run.placement(_plan(100, _words(edge)), lane) == (
        run.BLOCK_BUCKET, True, True)
    first = run.BLOCK_SLICE_FIRST
    assert run.placement(_plan(100, _words(edge + 2)), lane) == (
        run.BLOCK_BUCKET, not first, first)
    assert run.BLOCK_SLICE_FIRST == (run.placement(
        _plan(100, _words(run.BLOCK_ROOM)), lane)[1:] == (False, True))


def test_block_bucket_table_alone_then_neither():
    """np1 = 200: a slice past BLOCK_ROOM takes the workspace; the table
    stays in shared memory up to BLOCK_ROOM, and one row past it is read
    in device memory too."""
    assert run.block_slice(200, 0) > run.BLOCK_ROOM
    assert run.placement(_plan(200, _words(run.BLOCK_ROOM)), 0) == (
        run.BLOCK_BUCKET, True, False)
    assert run.placement(_plan(200, _words(run.BLOCK_ROOM + 2)), 0) == (
        run.BLOCK_BUCKET, False, False)
    assert run.placement(_plan(200, 0), 0) == (run.BLOCK_BUCKET, True,
                                               False)


def test_segment_bucket_table_beside_its_slices_then_the_64_row_bucket():
    """np1 = 4 (32 lanes a block): the table beside the 32 slices up to
    SEG_SMEM; past it the 64-row bucket, the table still in shared memory,
    while one lane fits beside the table, then the block bucket while the
    table fits a block; past BLOCK_ROOM the 64-row bucket reads the table
    in device memory (np1's own bucket keeps it in shared memory or not at
    all)."""
    seg, seg64 = _seg(4, 2, run.SEG_ROWS), _seg(64, 2, run.SEG_ROWS)
    edge = ROOM - 32 * seg
    for doubles, want in ((edge, (4, True, True)),
                          (edge + 2, (64, True, True)),
                          (ROOM - seg64, (64, True, True)),
                          (ROOM - seg64 + 2,
                           (run.BLOCK_BUCKET, True, True)),
                          (run.BLOCK_ROOM + 2, (64, False, True))):
        at = run.placement(_plan(4, _words(doubles)), 2, run.SEG_ROWS)
        assert at == want, (doubles, at)


def test_64_row_bucket_lanes_beside_the_table_then_the_table_alone():
    """np1 = 4 with slices too large for 32 lanes a block: the 64-row
    bucket beside the table while one lane fits, and past BLOCK_ROOM the
    64-row bucket with the table in device memory, as many lanes a block
    as fit."""
    lane = 4000  # 32 lanes of 4-row slices overflow SEG_SMEM
    assert 32 * _seg(4, lane) > ROOM
    seg64 = _seg(64, lane)
    edge = ROOM - seg64
    assert run.placement(_plan(4, _words(edge)), lane) == (64, True, True)
    assert run.placement(_plan(4, _words(edge + 2)), lane)[0] == \
        run.BLOCK_BUCKET
    assert run.placement(_plan(4, _words(run.BLOCK_ROOM + 2)), lane) == (
        64, False, True)


def test_run_doubles_are_the_deck_s_sources_and_newton_slots():
    """A lane keeps its deck's source values (an even count), no longer a
    fixed 32, then its junction voltages and value slots."""
    from test_torch_eligibility import _many_sources

    for text, nsrc in ((_many_sources(33), 33), (_many_sources(200), 200),
                       (bus(3), 3)):
        plan = run.make_plan(ts.compile_circuit(ts.parse(text)))
        assert sum(len(v) for v in plan.stype.values()) == nsrc
        assert run.run_doubles(plan) == run.even(nsrc) + \
            run.newton_doubles(plan)


# ------------------------------------ the cells' decks: their engines


def _cfg(cc):
    tp = cc.netlist.tran
    if tp is None or not tp.tstop:  # a DC deck: a short transient of it
        return ts.build_config(0.0, 1e-9, 1e-11, 0.0, False)
    return ts.build_config(tp.tstart, tp.tstop, tp.tstep, tp.tmax, tp.uic)


def _full_decks():
    from test_torch_eligibility import _diode_bank, _many_sources

    return {"nmos_ring101": nmos_ring(101), "pv72": pv_module(72),
            "bus48": bus(48), "cmos_ring101": cmos_ring(101),
            "cmos_ring151": cmos_ring(151), "diode_bank719": _diode_bank(719),
            "sources33": _many_sources(33)}


FULL = ("nmos_ring101", "pv72", "bus48", "cmos_ring101", "cmos_ring151",
        "diode_bank719", "sources33")


@pytest.mark.parametrize("name", FULL)
def test_full_decks_take_the_kernels(name):
    """make_tran_batch gives "run", store='full' and make_tran_stream
    "store", select_op_engine and make_dc_engine "fused" on a nonlinear
    deck ("linear", the stamped solve, on a linear one); no reason names a
    cap."""
    from toyspice_tpu_torch.ops.run_plan import nonlinear

    cc = ts.compile_circuit(ts.parse(_full_decks()[name]))
    cfg = _cfg(cc)
    reasons = []
    fn = ts.make_tran_batch(cc, cfg, None)
    assert fn.engine == "run", fn.engine_reason
    reasons.append(fn.engine_reason)
    fn = ts.make_tran_batch(cc, cfg, None, store="full")
    assert fn.engine == "store", fn.engine_reason
    reasons.append(fn.engine_reason)
    for fn in ts.make_tran_stream(cc, cfg, 64):
        assert fn.engine == "store", fn.engine_reason
        reasons.append(fn.engine_reason)
    want = "fused" if nonlinear(cc) else "linear"
    engine, why = select_op_engine(cc)
    assert engine == want, why
    engine, why, _ = make_dc_engine(cc, (0,))
    assert engine == want, why
    reasons.append(why)
    assert not any("cap" in r for r in reasons), reasons


def test_the_general_engine_runs_only_under_the_overrides(monkeypatch):
    """Past the former caps the general engine takes a run, its stream
    and an OP only when an override asks for it."""
    from test_torch_eligibility import _diode_bank, _many_sources

    many = ts.compile_circuit(ts.parse(_many_sources(33)))
    bank = ts.compile_circuit(ts.parse(_diode_bank(719)))
    monkeypatch.setenv("TOYSPICE_TRAN", "general")
    monkeypatch.setenv("TOYSPICE_OP", "general")
    assert ts.make_tran_batch(many, _cfg(many), None).engine == "general"
    fns = ts.make_tran_stream(many, _cfg(many), 64)
    assert all(f.engine == "general" and "TOYSPICE_TRAN=general" in
               f.engine_reason for f in fns)
    assert select_op_engine(bank)[0] == "general"


def test_a_size_past_int32_raises(monkeypatch):
    """The kernels have no cap but their int32 launch arguments: past
    them the wrappers raise ValueError naming the size; no other engine
    takes the deck quietly."""
    from test_torch_eligibility import _diode_bank

    plan = run.make_plan(ts.compile_circuit(ts.parse(_diode_bank(719))))
    run.check_shape(plan, run.run_doubles(plan))
    monkeypatch.setattr(run, "INT32_MAX", int(plan.topo.size) - 1)
    with pytest.raises(ValueError, match=f"{plan.topo.size} stamp plan "
                       "words"):
        run.check_shape(plan, run.run_doubles(plan))
