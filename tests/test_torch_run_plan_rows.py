"""The row view of the stamp plan (``ops/run_plan.py`` ``row_view``): the
table from which the linear run kernel's segment builds each row of the
system, one row a thread.  It must hold the plan's entries, each row's in
plan order, so that every element sums its stamps as the per-thread build
and the plain version do.  CPU only."""

from pathlib import Path

import numpy as np
import pytest
import torch

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.ops import run
from toyspice_tpu_torch.ops.run_plan import H_ROWS, make_plan, row_view

CIRCUITS = Path(__file__).resolve().parent.parent / "circuits"
TRAN_DECKS = sorted(p.name for p in CIRCUITS.glob("*.cir")
                    if ".tran" in p.read_text().lower())


def ladder(np1, kind):
    """An RC or RL ladder of np1 unknowns from a SIN source (np1 = 2: a
    current source into R || C)."""
    if np1 == 2:
        return "* np1 2\n.tran 1u 1m\nI1 0 1 SIN(0 1m 1k)\nR1 1 0 1k\n" \
               "C1 1 0 1u\n"
    # ground and the source's branch; an RL ladder adds a branch per L
    nodes = np1 - 2 if kind == "RC" else (np1 - 1) // 2
    lines = ["* ladder", ".tran 1u 1m", "Vin 1 0 SIN(0 5 1k)"]
    for i in range(1, nodes):
        lines.append(f"R{i} {i} {i + 1} {100 + i}")
        lines.append(f"C{i} {i + 1} 0 1u" if kind == "RC"
                     else f"L{i} {i + 1} 0 {i}m")
    if kind == "RL" and 2 * nodes + 1 < np1:  # one more branch row
        lines.append(f"L{nodes} 1 0 1m")
    lines.append(f"R{nodes} {nodes} 0 1k")
    return "\n".join(lines) + "\n"


LADDERS = [(np1, kind) for np1 in (2, 8, 9, 16, 17, 32)
           for kind in ("RC", "RL")]


def plan_of(text):
    return make_plan(ts.compile_circuit(ts.parse(text)))


def decoded(plan):
    """The view and offsets as the kernel reads them from the table."""
    pos, e = int(plan.topo[H_ROWS]), len(plan.entries)
    view = plan.topo[pos:pos + 4 * e].reshape(e, 4)
    offsets = plan.topo[pos + 4 * e:pos + 4 * e + plan.np1 + 1]
    assert pos + 4 * e + plan.np1 + 1 == plan.topo.size
    return pos, view, offsets


def check_view(plan):
    ent = plan.entries
    pos, view, off = decoded(plan)
    # 16-byte aligned (the kernel loads each entry as one int4), after the
    # table the per-thread kernels copy
    assert pos % 4 == 0 and pos == plan.base_len
    # the offsets bracket each row: row 0 (ground) has none
    assert off[0] == 0 and off[-1] == len(ent) and off[1] == 0
    assert bool(np.all(np.diff(off) >= 0))
    for i in range(plan.np1):
        mine = ent[ent[:, 0] == i]  # row i's entries in plan order
        assert np.array_equal(view[off[i]:off[i + 1]], mine[:, 1:]), i
    # a permutation of the entries
    rows = np.repeat(np.arange(plan.np1), np.diff(off))
    full = np.concatenate([rows[:, None], view], axis=1)
    key = lambda a: sorted(map(tuple, a.tolist()))  # noqa: E731
    assert key(full) == key(ent)
    v2, o2 = row_view(ent, plan.np1)
    assert np.array_equal(v2, view) and np.array_equal(o2, off)
    return view, off


def scatter_matches(plan, view, off):
    """Random values per (tag, index), summed into each element as
    (double)sign * v: plan order and row-view order give the same bits."""
    ent = plan.entries
    rng = np.random.default_rng(0)
    n = plan.np1
    vals = {}
    for tag, k in {(int(t), int(k)) for t, k in ent[:, 2:4]}:
        vals[tag, k] = float(rng.standard_normal() * 10.0 ** rng.integers(
            -12, 12))

    def value(tag, k):
        return vals[int(tag), int(k)]

    a = [[0.0] * (n + 1) for _ in range(n)]
    for r, c, tag, k, sign in ent.tolist():
        a[r][c] += float(sign) * value(tag, k)
    a[0][0] = 1.0
    b = [[0.0] * (n + 1) for _ in range(n)]
    for i in range(n):
        for c, tag, k, sign in view[off[i]:off[i + 1]].tolist():
            b[i][c] += float(sign) * value(tag, k)
    b[0][0] = 1.0
    ta = torch.tensor(a, dtype=torch.float64)
    tb = torch.tensor(b, dtype=torch.float64)
    assert torch.equal(ta, tb)
    # the same bits as torch's own scatter in plan order
    flat = torch.zeros(n * (n + 1), dtype=torch.float64)
    for r, c, tag, k, sign in ent.tolist():
        flat[r * (n + 1) + c] += torch.tensor(
            float(sign), dtype=torch.float64) * value(tag, k)
    flat[0] = 1.0
    assert torch.equal(flat.reshape(n, n + 1), tb)


@pytest.mark.parametrize("name", TRAN_DECKS)
def test_row_view_of_each_transient_deck(name):
    plan = plan_of((CIRCUITS / name).read_text())
    view, off = check_view(plan)
    scatter_matches(plan, view, off)


@pytest.mark.parametrize("np1,kind", LADDERS,
                         ids=[f"{k}{n}" for n, k in LADDERS])
def test_row_view_of_ladders(np1, kind):
    plan = plan_of(ladder(np1, kind))
    assert plan.np1 == np1
    view, off = check_view(plan)
    scatter_matches(plan, view, off)


def test_op_plan_has_no_view_and_the_caps_count_the_base_table(
        monkeypatch):
    """The OP plan too carries the row view (the OP and DC sweep kernels
    build on a warp segment from it), then each row's linear prefix; a
    kernel's placement counts the whole table, the view included (it is
    copied to shared memory, or read in device memory, whole), for either
    plan."""
    cc = ts.compile_circuit(ts.parse((CIRCUITS / "rlc_ringdown.cir")
                                     .read_text()))
    op_plan = make_plan(cc, mode="op")
    pos, e = int(op_plan.topo[H_ROWS]), len(op_plan.entries)
    assert pos % 4 == 0 and pos == op_plan.base_len
    assert pos + 4 * e + 2 * op_plan.np1 + 1 == op_plan.topo.size
    tran = make_plan(cc)
    assert tran.base_len < tran.topo.size
    for plan in (tran, op_plan):
        assert run.table_doubles(plan) == (plan.topo.size + 3) // 4 * 2
        # a table one block of shared memory past the room: device memory
        monkeypatch.setattr(run, "BLOCK_ROOM", run.table_doubles(plan) - 1)
        monkeypatch.setattr(run, "SEG_SMEM", 8 * run.BLOCK_ROOM)
        assert run.run_placement(plan)[1] is False


HWR_MOS = """* a diode and an NMOS
.tran 1u 0.1m
Vdd vdd 0 DC 5
Vg g 0 SIN(2.5 2 10k)
R1 vdd d 10k
M1 d g 0 0 NM L=2u W=20u
D1 d 0 DM
.model NM NMOS(Vto=1 Kp=2e-5)
.model DM D(Is=1e-14)
"""


def test_newton_doubles_follow_the_kernels_slot_layout():
    """newton_doubles sizes a Newton lane's slice of the run kernel's
    shared memory: its junction voltages, then D_SLOTS, Q_SLOTS and
    M_SLOTS value slots per diode, BJT and MOSFET (csrc/newton.cuh), which
    the kernel checks at entry; NL_SLOTS must hold the header's counts."""
    import re

    from toyspice_tpu_torch.ops.run_plan import NL_SLOTS

    header = (Path(run.__file__).resolve().parent.parent / "csrc"
              / "newton.cuh").read_text()
    slots = re.search(r"constexpr int D_SLOTS = (\d+), Q_SLOTS = (\d+), "
                      r"M_SLOTS = (\d+);", header)
    assert slots and NL_SLOTS == dict(zip("DQM", map(int, slots.groups())))
    plan = plan_of(HWR_MOS)
    assert plan.nonlinear
    nd, nq, nm = plan.counts[5:]
    assert (nd, nq, nm) == (1, 0, 1)
    assert run.newton_doubles(plan) == plan.kj + 2 * nd + 21 * nm
    assert run.newton_doubles(plan_of(ladder(6, "RC"))) == 0
