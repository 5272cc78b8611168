"""The tables of the OP and DC sweep kernels' warp segments (``csrc/
op_kernel.cu``, ``csrc/dc_sweep_kernel.cu`` on ``csrc/newton.cuh``
``seg_newton``): the OP plan's row view with each row's linear prefix,
from which a segment builds row i of the Newton's systems and of the
linear-devices-only estimate on thread i, and the doubles each lane keeps
in its segment's slice of shared memory.  CPU only."""

from pathlib import Path

import numpy as np
import pytest

import toyspice_tpu_torch as ts
from toyspice_tpu_torch.ops import dc, op, run
from toyspice_tpu_torch.ops.run_plan import (H_ROWS, NL_SLOTS, TAG_NL,
                                             make_plan)

CIRCUITS = Path(__file__).resolve().parent.parent / "circuits"
NL_DECKS = sorted(p.name for p in CIRCUITS.glob("*.cir")
                  if make_plan(ts.compile_circuit(ts.parse(p.read_text())),
                               "op").nonlinear)

# sixteen level-3 MOSFETs (the most value slots a deck can have) at
# np1 = 31
M16 = "\n".join(
    ["* sixteen nmos", ".op", "Vdd vdd 0 DC 5", "Vin in 0 DC 2"]
    + [f"R{i} vdd d{i} 10k\nM{i} d{i} in 0 0 NM L=2u W=20u"
       for i in range(16)]
    + [f"Rx{i} d{i} x{i} 1k" for i in range(10)]
    + [".model NM NMOS(Level=3 VTO=0.7 KP=30u THETA=0.05 KAPPA=0.3)"]) + "\n"
# six diodes, four BJTs and six MOSFETs at np1 = 32 (the 16-device cap)
MIXED16 = "\n".join(
    ["* mixed sixteen", ".op", "Vdd vdd 0 DC 5", "Vin in 0 DC 2"]
    + [f"R{i} vdd d{i} 10k\nM{i} d{i} in 0 0 NM L=2u W=20u"
       for i in range(6)]
    + [f"Rb{i} vdd b{i} 68k\nRc{i} vdd c{i} 3.3k\nRe{i} e{i} 0 680\n"
       f"Q{i} c{i} b{i} e{i} QN" for i in range(4)]
    + [f"D{i} d{i} n{i} DM\nRd{i} n{i} 0 22k" for i in range(6)]
    + [f"Ry{i} c{i} y{i} 1k" for i in range(3)]
    + [".model NM NMOS(Level=2 VTO=0.7 KP=30u UCRIT=1e4 UEXP=0.1)",
       ".model QN NPN(Bf=180 Vaf=90)", ".model DM D(Is=1e-14 N=1.05)"]) \
    + "\n"

# an SM's shared memory on an H100 (228 KB) and what the card reserves
# for each block (1 KB)
SM_SHARED = 233472
BLOCK_RESERVED = 1024


def op_plan(text):
    return make_plan(ts.compile_circuit(ts.parse(text)), "op")


@pytest.mark.parametrize("name", NL_DECKS)
def test_op_plan_view_rows_and_linear_prefixes(name):
    """Row i of the view is row i's entries in plan order, its linear
    prefix those among the plan's leading n_lin, and the rest its
    nonlinear ones; then the prefixes end the table."""
    plan = op_plan((CIRCUITS / name).read_text())
    ent, n, n_lin = plan.entries, plan.np1, plan.n_lin
    assert plan.nonlinear and 0 < n_lin < len(ent)
    assert bool((ent[n_lin:, 2] == TAG_NL).all())
    assert not bool((ent[:n_lin, 2] == TAG_NL).any())
    pos, e = int(plan.topo[H_ROWS]), len(ent)
    assert pos % 4 == 0 and pos == plan.base_len
    view = plan.topo[pos:pos + 4 * e].reshape(e, 4)
    off = plan.topo[pos + 4 * e:pos + 4 * e + n + 1]
    pre = plan.topo[pos + 4 * e + n + 1:]
    assert pre.size == n and off[0] == 0 and off[-1] == e
    for i in range(n):
        mine = np.flatnonzero(ent[:, 0] == i)  # row i's entries in order
        assert np.array_equal(view[off[i]:off[i + 1]], ent[mine, 1:]), i
        lin = mine[mine < n_lin]
        assert pre[i] == lin.size, i
        assert np.array_equal(mine[:pre[i]], lin), i  # a prefix


@pytest.mark.parametrize("name", NL_DECKS + ["M16", "MIXED16"])
def test_opdc_lane_doubles_are_the_decks_counts(name):
    """A lane's doubles in the slice: the OP's dyn row [gmin, use_seed,
    act, vsrc, isrc, lrhs], the DC sweep's [isrc, lrhs] and the point's nV
    source values, each with newton_doubles (the junction voltages and
    value slots) from the deck's counts, not the caps."""
    text = {"M16": M16, "MIXED16": MIXED16}.get(name)
    plan = op_plan(text or (CIRCUITS / name).read_text())
    nr, nc, nl, nv, ni, n_d, n_q, n_m = plan.counts
    slots = NL_SLOTS["D"] * n_d + NL_SLOTS["Q"] * n_q + NL_SLOTS["M"] * n_m
    assert run.newton_doubles(plan) == plan.kj + slots
    assert plan.kj == n_d + 2 * n_q + 3 * n_m > 0
    assert op.lane_doubles(plan) == 3 + nv + ni + nl + plan.kj + slots
    assert dc.lane_doubles(plan) == ni + nl + nv + plan.kj + slots


def opdc_block_bytes(plan, lane):
    """Shared memory of a block (csrc/newton.cuh opdc_shape): the table
    in whole 16-byte words, then 128 / W slices of the exchange buffer
    and W build rows (stride W + 2), x and the lane's doubles (even)."""
    w = 4 if plan.np1 <= 4 else 8 if plan.np1 <= 8 else \
        16 if plan.np1 <= 16 else 32
    slice_ = (w + 2) * (w + 1) + w + (lane + 1) // 2 * 2
    return 8 * ((plan.topo.size + 3) // 4 * 2 + 128 // w * slice_)


@pytest.mark.parametrize("text,np1", [(M16, 31), (MIXED16, 32)],
                         ids=["m16", "mixed16"])
def test_opdc_slices_hold_four_blocks_an_sm_at_the_caps(text, np1):
    """At the 16-device cap and the 32-row bucket (segments of 32, four
    lanes a block) a block's table and slices leave room for the four
    blocks an SM the kernels' launch bounds ask for."""
    plan = op_plan(text)
    assert plan.np1 == np1 and sum(plan.counts[5:]) == 16
    for lane in (op.lane_doubles(plan), dc.lane_doubles(plan)):
        assert 4 * (opdc_block_bytes(plan, lane) + BLOCK_RESERVED) \
            <= SM_SHARED
