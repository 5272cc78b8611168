"""The row view of a stamped pattern (``ops/solve_stamped.py``
``row_view``, ``StampPattern.view``): the table from which the stamped
solve's segment kernel (``csrc/stamped_solve.cu`` ``stamped_seg_kernel``,
np1 <= 32) builds row i of each lane's system on thread i.  A numpy
emulation of that build (each row's terms summed in view order from 0,
then gmin on the diagonal after the sum, row 0 the ground identity row)
must give ``build_plain``'s matrices bit for bit: on random patterns with
duplicate cells, RHS entries and entries into row 0, and on one whose view
is past the segment kernel's shared-memory stage (``SEG_VSTAGE``).  CPU
only."""

import numpy as np
import pytest
import torch

from toyspice_tpu_torch.ops import solve_stamped
from toyspice_tpu_torch.ops.solve_stamped import SEG_VSTAGE

LANES = 5


def pattern(n, seed, depth=6, deep=0):
    """A random pattern of n unknowns: a diagonal, depth * n random cells
    (rows 0 included, so duplicates and ground-row entries), 2n RHS
    entries; ``deep`` more entries in every cell."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.arange(n), rng.integers(0, n, depth * n)])
    cols = np.concatenate([np.arange(n), rng.integers(0, n, depth * n)])
    if deep:
        r, c = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        rows = np.concatenate([rows, np.repeat(r.ravel(), deep)])
        cols = np.concatenate([cols, np.repeat(c.ravel(), deep)])
    rrows = rng.integers(0, n, 2 * n)
    pat = solve_stamped.StampPattern(n, rows, cols, rrows)
    vals = rng.normal(size=(LANES, rows.size)) * 10.0 ** rng.integers(
        -6, 6, rows.size)
    vals[1] = np.round(vals[1])  # exact cancellations
    rvals = rng.normal(size=(LANES, rrows.size))
    gmin = np.where(np.arange(LANES) % 2 == 0, 0.0,
                    rng.uniform(0.0, 1e-3, LANES))
    return pat, vals, rvals, gmin


def decoded(pat):
    """The view's int4 terms and its n + 1 row offsets, as the kernel reads
    them."""
    n = pat.n
    nterm = (pat.view.size - (n + 1)) // 4
    return pat.view[:4 * nterm].reshape(nterm, 4), pat.view[4 * nterm:]


def segment_build(pat, vals, rvals, gmin):
    """The segment kernel's build: thread i (row i) sums its terms in view
    order into a zeroed row, then adds gmin to its diagonal (rows past 0),
    and row 0 is the ground identity row."""
    n = pat.n
    ent, roff = decoded(pat)
    value = np.concatenate([vals, rvals], axis=1)
    m = np.zeros((vals.shape[0], n, n + 1))
    for i in range(n):
        row = np.zeros((vals.shape[0], n + 1))
        for col, _, src, sign in ent[roff[i]:roff[i + 1]]:
            row[:, col] += np.float64(sign) * value[:, src]
        if i > 0:
            row[:, i] = row[:, i] + gmin
        else:
            row[:, 0] = 1.0
        m[:, i] = row
    return m


@pytest.mark.parametrize("n,deep", [(2, 0), (4, 0), (5, 0), (8, 0), (9, 0),
                                    (16, 0), (17, 0), (32, 0), (24, 9)],
                         ids=["n2", "n4", "n5", "n8", "n9", "n16", "n17",
                              "n32", "past_max_topo"])
def test_segment_build_matches_build_plain(n, deep):
    pat, vals, rvals, gmin = pattern(n, n, deep=deep)
    if deep:
        assert pat.view.size > SEG_VSTAGE
    got = segment_build(pat, vals, rvals, gmin)
    want = solve_stamped.build_plain(pat, torch.as_tensor(vals),
                                     torch.as_tensor(rvals),
                                     torch.as_tensor(gmin)).numpy()
    assert np.array_equal(got.view(np.int64), want.view(np.int64))


@pytest.mark.parametrize("n", [3, 17, 32])
def test_row_view_holds_the_table_row_by_row(n):
    """The view holds every term of the table once, row by row, each row's
    in table order, as (col, 0, src, +1); no term of row 0 (the ground
    row's entries are dropped from the table)."""
    pat = pattern(n, 100 + n)[0]
    ent, roff = decoded(pat)
    nterm = int(pat.table[0])
    rows, cols, src = (pat.table[1 + k * nterm:1 + (k + 1) * nterm]
                       for k in range(3))
    assert roff[0] == roff[1] == 0 and roff[-1] == nterm
    assert np.all(np.diff(roff) >= 0)
    for i in range(n):
        mine = np.flatnonzero(rows == i)
        seg = ent[roff[i]:roff[i + 1]]
        assert seg[:, 0].tolist() == cols[mine].tolist()
        assert seg[:, 2].tolist() == src[mine].tolist()
        assert set(seg[:, 1].tolist()) <= {0}
        assert set(seg[:, 3].tolist()) <= {1}
    assert pat.view.dtype == np.int32
