"""The port's batched dense solve (``ops/solve.py``: ``gj_plain``, the
arithmetic of csrc/gj_kernel.cu, and ``linear_solve``) and the stamped
solve past np1 = 32 (``ops/solve_stamped.solve_plain``, the arithmetic of
csrc/stamped_solve.cu's block instantiation) on the CPU, against the JAX
package's ``ops/solve.py::_solve_batched`` (f64, rtol 1e-13) and its TPU
kernel ``ops/pallas_solve.py::pallas_solve_batched`` in Pallas interpret
mode (double-float, the 1e-9 bar of tests/test_pallas_solve.py).

The sets: well-conditioned random systems with a structural zero on a
diagonal (pivoting needed), a lane with an all-zero row (singular: a zero
pivot poisons its row), B = 130 (not a multiple of 128), n in {6, 40, 72}
and the GJ kernel's bucket edges (csrc/gj_block.cuh: gj_bucket, a row a
thread, 1, 16, 17, 32, 33, 48, 49, 64, 65, 72, 73, 96; gj_wide_bucket, the
system in a 512-thread block's registers, 97, 127, 128, 144; the
shared-memory body 145 and 168; the device-memory body 169), and a tie
between rows that the wide body keeps on different warps.
The Pallas kernel runs at n = 6 only: its interpret mode unrolls every
column into the traced program and took 344 s at n = 40 on one CPU core.

On a singular lane every package gives a non-finite x: the JAX package
gathers x with a one-hot contraction, so one non-finite right-hand side
spreads NaN into every x of the system, and the port (every elimination
in csrc/ too) indexes the pivot rows and then sets every x of a system
with a non-finite one to NaN (tests/test_torch_singular_newton.py holds
a Newton through such a solve).  The tests hold the lane-wise pattern
(any x non-finite) equal."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from toyspice_tpu.ops.pallas_solve import pallas_solve_batched
from toyspice_tpu.ops.solve import _solve_batched

from toyspice_tpu_torch.ops import solve, solve_stamped

LANES = 130
SINGULAR = 5  # the lane with an all-zero row


def systems(n, seed=0):
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=(LANES, n, n)) + 4.0 * np.eye(n)
    b = rng.normal(size=(LANES, n))
    if n > 3:
        a[:, 3, 3] = 0.0  # a branch-row style zero on the diagonal
    a[SINGULAR, min(2, n - 1), :] = 0.0
    return a, b


def port(a, b):
    return solve.gj_plain(torch.as_tensor(a), torch.as_tensor(b)).numpy()


def assert_close(x, want, rtol):
    bad_x = ~np.isfinite(x).all(axis=1)
    bad_w = ~np.isfinite(want).all(axis=1)
    np.testing.assert_array_equal(bad_x, bad_w)
    assert bad_x.tolist() == [i == SINGULAR for i in range(LANES)]
    ok = ~bad_w
    np.testing.assert_allclose(x[ok], want[ok], rtol=rtol,
                               atol=rtol * np.abs(want[ok]).max())


@pytest.mark.parametrize("n", [1, 6, 16, 17, 32, 33, 40, 48, 49, 64, 65,
                               72, 73, 96, 97, 127, 128, 144, 145, 168,
                               169])
def test_gj_plain_matches_jax_solve(n):
    a, b = systems(n)
    want = np.asarray(_solve_batched(jnp.asarray(a), jnp.asarray(b)))
    assert_close(port(a, b), want, 1e-13)


def test_gj_plain_matches_pallas_kernel():
    a, b = systems(6)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(pallas_solve_batched(jnp.asarray(a),
                                               jnp.asarray(b)))
    assert_close(port(a, b), want, 1e-9)


def test_pivot_ties_take_the_first_row():
    # column 0 holds +-2 in rows 1 and 2: row 1 pivots first
    a = torch.tensor([[[0.0, 1.0, 1.0], [2.0, 1.0, 0.0], [-2.0, 0.0, 3.0]]],
                     dtype=torch.float64)
    b = torch.tensor([[1.0, 2.0, 3.0]], dtype=torch.float64)
    x = solve.gj_plain(a, b)
    np.testing.assert_allclose(x.numpy(), np.linalg.solve(a[0].numpy(),
                                                          b[0].numpy())[None],
                               rtol=1e-14)


def cross_warp_tie(n, lanes=LANES, seed=0):
    """Integer systems (rows 1..n-1 round(2 a), a random with 4 on the
    diagonal; row 0 the ground identity) whose column 1 holds its largest
    |a| twice: +10 in row 2 and -10 in row 17 (warps 2 and 1 of the wide
    body, whose rows interleave over 16 warps); the pivot rule takes row 2,
    the lower row on the higher warp.  Integer entries tie in later columns
    too, and there the choice of row changes the bits (with real entries
    and the two rows alone tied, both choices gave the same bits)."""
    rng = np.random.default_rng(seed + n)
    a = rng.normal(size=(lanes, n, n)) + 4.0 * np.eye(n)
    b = rng.normal(size=(lanes, n))
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    b[:, 0] = 0.0
    a[:, 1:, :] = np.round(2.0 * a[:, 1:, :])
    a[:, 1:, 1] = np.clip(a[:, 1:, 1], -3.0, 3.0)
    a[:, 2, 1], a[:, 17, 1] = 10.0, -10.0
    return a, b


@pytest.mark.parametrize("n", [18, 97, 130])
def test_cross_warp_tie_matches_jax_solve(n):
    """gj_plain and solve_plain on the tie set against the JAX package's
    _solve_batched (its first eligible row wins a tie, as the kernels'
    lowest row does)."""
    a, b = cross_warp_tie(n)
    want = np.asarray(_solve_batched(jnp.asarray(a), jnp.asarray(b)))
    x = port(a, b)
    assert np.isfinite(want).all()
    np.testing.assert_allclose(x, want, rtol=1e-13,
                               atol=1e-13 * np.abs(want).max())
    rows, cols = np.meshgrid(np.arange(1, n), np.arange(n), indexing="ij")
    fn = solve_stamped.solve_stamped_for(n, rows.ravel(), cols.ravel(),
                                         np.arange(1, n))
    xs = fn(torch.as_tensor(a[:, 1:, :].reshape(LANES, -1).copy()),
            torch.as_tensor(b[:, 1:].copy()), torch.zeros(LANES,
                                                          dtype=torch.float64))
    np.testing.assert_array_equal(xs.numpy(), x)


def test_gj_edges_match_the_header():
    """ops/solve.py's edges (NREG, NWIDE, NBIG), which size ``work_for``
    and name ``body``, are csrc/gj_block.cuh's (read from its text), and
    NBIG is the largest n whose shared-memory system fits a block's 227 KB
    (gj_shared_bytes)."""
    import re
    from pathlib import Path

    text = (Path(solve.__file__).resolve().parent.parent / "csrc"
            / "gj_block.cuh").read_text()
    const = {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", text)}
    assert (const["GJ_NREG"], const["GJ_NWIDE"], const["NBIG"]) == (
        solve.NREG, solve.NWIDE, solve.NBIG)
    assert solve.NREG < const["GJ_WIDE_MID"] < solve.NWIDE < solve.NBIG

    def shared_bytes(n):  # gj_shared_bytes
        return (n * (n + 1) + n) * 8 + 2 * n * 4

    assert shared_bytes(solve.NBIG) <= 232448 < shared_bytes(solve.NBIG + 1)
    for n in (1, 96, 97, 144, 145, 168):
        assert solve.work_for(n, 10, "cpu") is None
    assert [solve.body(n) for n in (96, 97, 144, 145, 168, 169)] == [
        "registers, a row a thread", "registers, 16 warps",
        "registers, 16 warps", "shared memory", "shared memory",
        "device memory"]


def test_nan_column_makes_every_x_nan():
    a, b = systems(6)
    a[7, 4, 1] = np.nan
    x = port(a, b)
    assert np.isnan(x[7]).all()
    assert np.isfinite(x[8]).all()


def test_linear_solve_takes_the_plain_version_on_the_cpu():
    a, b = systems(40)
    before = solve.launch_gj.launches
    x = solve.linear_solve(torch.as_tensor(a), torch.as_tensor(b))
    assert solve.launch_gj.launches == before
    np.testing.assert_array_equal(x.numpy(), port(a, b))
    with pytest.raises(ValueError, match="CUDA"):
        solve.launch_gj(torch.as_tensor(a), torch.as_tensor(b))


@pytest.mark.parametrize("n", [40, 72, 144, 145, 168, 169])
def test_large_stamped_solve_matches_jax_solve(n):
    """A stamped pattern past np1 = 32: the plain version of the block
    instantiation (cells summed in entry order, the ground row, gmin on
    the diagonals 1..n-1) against the JAX package's dense build and
    solve of the same entries."""
    rng = np.random.default_rng(n)
    rows = np.concatenate([np.arange(n), rng.integers(0, n, 4 * n),
                           np.arange(1, n)]).astype(np.int32)
    cols = np.concatenate([np.arange(n), rng.integers(0, n, 4 * n),
                           np.arange(1, n)]).astype(np.int32)
    rrows = rng.integers(0, n, 2 * n).astype(np.int32)
    vals = rng.normal(size=(LANES, rows.size))
    vals[:, :n] += 8.0
    rvals = rng.normal(size=(LANES, rrows.size))
    gmin = np.full(LANES, 1e-3)
    x = solve_stamped.solve_stamped_for(n, rows, cols, rrows)(
        torch.as_tensor(vals), torch.as_tensor(rvals), torch.as_tensor(gmin))
    a = np.zeros((LANES, n, n))
    np.add.at(a, (slice(None), rows, cols), vals)
    rhs = np.zeros((LANES, n))
    np.add.at(rhs, (slice(None), rrows), rvals)
    a[:, 0, :] = 0.0
    a[:, 0, 0] = 1.0
    rhs[:, 0] = 0.0
    a[:, np.arange(1, n), np.arange(1, n)] += gmin[:, None]
    want = np.asarray(_solve_batched(jnp.asarray(a), jnp.asarray(rhs)))
    np.testing.assert_allclose(x.numpy(), want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())
    assert solve_stamped.caps_reason(n, 0) is None
    assert solve_stamped.caps_reason(129, 0) is None
