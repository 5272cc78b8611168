"""Build and solve MNA systems from flat stamp values: each iteration of
the general engine's Newton, and a linear deck's whole Newton (the linear
OP and its rescue rungs, every point of a linear DC sweep, the bias of a
linear AC).

The counterpart of ``ops/pallas_solve.py``'s ``_cell_groups``,
``_build_solve_kernel`` and ``solve_stamped_for`` in the JAX package.  A
deck's stamp pattern (the static rows, cols and RHS rows of
``ops/assemble.assemble_entries``) becomes a ``StampPattern``: each cell's
entries in the order ``_cell_groups`` lists them, entries into the ground
row dropped.  Per lane the system is built from the flat values (vals, then
the RHS values rvals) by summing each cell's entries from 0, row 0 is the
ground identity row, gmin goes on diagonals 1..n-1 (matrix/circuit.go:
107-114), and Gauss-Jordan with the kernels' pivot rule solves it (a zero
pivot poisons its row, so a singular system gives an x of NaN).

* ``launch_stamped``: the wrapper of ``csrc/stamped_solve.cu`` (a warp
  segment of 4 to 32 lanes per lane up to n = 32, row i built from the
  pattern's row view and eliminated on thread i; one warp per lane up to
  n = 64, the rows in registers or in the warp's shared memory; one block
  per lane up to NBIG = 168, the system built in shared memory and
  eliminated as the GJ kernel does, in registers to n = 144; past NBIG
  one block per lane in a workspace in device memory; f64); it counts its
  launches in ``.launches``.
* ``solve_plain``: the same arithmetic as batched torch operations.
* ``solve_lanes``: the kernel for CUDA tensors, the plain version for CPU
  tensors.
"""

import functools

import numpy as np
import torch

from . import _build
from .newton import gauss_jordan, poison_rows
from .solve import checked, work_args, work_for

# ints of a row view the segment kernel copies to shared memory; past it
# the build reads the view through the cache (csrc/stamped_solve.cu
# SEG_VSTAGE)
SEG_VSTAGE = 16384

F64 = torch.float64


def cell_groups(rows, cols, rrows):
    """(i, j) cell -> its flat entry indices in order; column n holds the
    RHS (indices into rvals).  The JAX package's ``_cell_groups``."""
    mat = {}
    for e, (i, j) in enumerate(zip(np.asarray(rows).tolist(),
                                   np.asarray(cols).tolist())):
        mat.setdefault((i, j), []).append(e)
    rhs = {}
    for e, i in enumerate(np.asarray(rrows).tolist()):
        rhs.setdefault(i, []).append(e)
    return mat, rhs


@functools.lru_cache(maxsize=None)
def _sum_plan(flat_bytes, device):
    """The cells of a flat index array and, per summing step, the entry of
    each cell and whether the cell has one (built once per pattern and
    device)."""
    groups = {}
    for e, c in enumerate(np.frombuffer(flat_bytes, np.int64).tolist()):
        groups.setdefault(c, []).append(e)
    cells = list(groups)
    steps = []
    for s in range(max((len(v) for v in groups.values()), default=0)):
        ent = torch.as_tensor([groups[c][s] if s < len(groups[c]) else 0
                               for c in cells], device=device)
        mask = torch.as_tensor([s < len(groups[c]) for c in cells],
                               device=device)
        steps.append((ent, mask))
    return torch.as_tensor(cells, dtype=torch.int64, device=device), steps


def cell_sums(flat, vals, size):
    """(B, size) with vals[:, e] summed into column flat[e], each column's
    entries in entry order from 0 (a deterministic scatter-add: the same
    bits on any device)."""
    b = vals.shape[0]
    out = torch.zeros((b, size), dtype=vals.dtype, device=vals.device)
    cells, steps = _sum_plan(np.asarray(flat, np.int64).tobytes(),
                             vals.device)
    if not steps:
        return out
    acc = torch.zeros((b, len(cells)), dtype=vals.dtype, device=vals.device)
    for ent, mask in steps:
        acc = acc + torch.where(mask, vals[:, ent], 0.0)
    out[:, cells] = acc
    return out


class StampPattern:
    """One deck's static stamp pattern: the term table of the kernel (a
    count, then the rows, cols and value indices of the terms, each cell's
    terms in entry order), its row view (``view``) and the sizes."""

    def __init__(self, n, rows, cols, rrows):
        self.n = int(n)
        self.nnz = int(np.asarray(rows).size)
        self.nrhs = int(np.asarray(rrows).size)
        mat, rhs = cell_groups(rows, cols, rrows)
        terms = [(i, j, e) for (i, j), es in mat.items() if i != 0
                 for e in es]
        terms += [(i, self.n, self.nnz + e) for i, es in rhs.items() if i != 0
                  for e in es]
        t = np.asarray(terms, np.int32).reshape(-1, 3)
        self.table = np.concatenate([[len(t)], t[:, 0], t[:, 1],
                                     t[:, 2]]).astype(np.int32)
        self.flat = t[:, 0] * (self.n + 1) + t[:, 1]  # cell of each term
        self.src = t[:, 2]
        self.view = row_view(self.n, t)
        self._tables = {}

    def table_on(self, device):
        """The term table and the row view on ``device``, copied there once
        (a pattern is cached per deck, and the general engine launches it
        every Newton iteration)."""
        tabs = self._tables.get(device)
        if tabs is None:
            tabs = self._tables[device] = (
                torch.as_tensor(self.table, device=device),
                torch.as_tensor(self.view, device=device))
        return tabs

    def check(self, vals, rvals, gmin):
        b = vals.shape[0]
        for name, x, shape in (("vals", vals, (b, self.nnz)),
                               ("rvals", rvals, (b, self.nrhs)),
                               ("gmin", gmin, (b,))):
            if x.dtype != F64:
                raise TypeError(f"{name} must be float64, got {x.dtype}")
            if tuple(x.shape) != shape:
                raise ValueError(f"{name} must be {shape}, got "
                                 f"{tuple(x.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"{name} must be contiguous")
            if x.device != vals.device:
                raise ValueError(f"{name} is on {x.device}, vals on "
                                 f"{vals.device}")


def row_view(n, terms):
    """The row view of a term table's (row, col, src) terms, from which the
    segment kernel (n <= 32) builds row i on thread i: each term's int4
    (col, 0, src, +1), row by row, each row's in table order (so each cell
    sums its own terms in entry order from 0, as ``cell_sums``), then the
    n + 1 row offsets; int32."""
    order = np.argsort(terms[:, 0], kind="stable")
    ent = np.zeros((len(terms), 4), np.int32)
    ent[:, 0] = terms[order, 1]
    ent[:, 2] = terms[order, 2]
    ent[:, 3] = 1
    roff = np.searchsorted(terms[order, 0], np.arange(n + 1)).astype(np.int32)
    return np.concatenate([ent.ravel(), roff]).astype(np.int32)


def caps_reason(n, table_size):
    """Why the kernel can NOT hold this pattern; None when it can.  Every
    pattern fits: past its shared-memory stage the segment body reads the
    row view through the cache, and past NBIG a block works in device
    memory, so only the card's memory bounds n."""
    return None


def launch_stamped(pat: StampPattern, vals, rvals, gmin):
    """x (B, n) of every lane's system with ``csrc/stamped_solve.cu``."""
    if not vals.is_cuda:
        raise ValueError("launch_stamped needs CUDA tensors")
    pat.check(vals, rvals, gmin)
    why = caps_reason(pat.n, pat.table.size)
    if why is not None:
        raise ValueError(f"deck exceeds the kernel's caps: {why}")
    lib = _build.load("stamped")
    device = vals.device
    b = vals.shape[0]
    tab, view = pat.table_on(device)
    x = torch.empty((b, pat.n), dtype=F64, device=device)
    work = work_for(pat.n, b, device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.tsr_stamped(pat.n, tab.data_ptr(), int(pat.table.size),
                              view.data_ptr(), int(pat.view.size), pat.nnz,
                              pat.nrhs, vals.data_ptr(), rvals.data_ptr(),
                              gmin.data_ptr(), x.data_ptr(), b,
                              *work_args(work), stream)
    if err != 0:
        raise RuntimeError(f"stamped-solve kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err, 'stamped')})")
    _build.count(launch_stamped)
    return x


launch_stamped.launches = 0


def build_plain(pat: StampPattern, vals, rvals, gmin):
    """The augmented (B, n, n+1) systems the kernel builds (chip_smoke.py
    hands them to the library solve too)."""
    pat.check(vals, rvals, gmin)
    b, n = vals.shape[0], pat.n
    m = cell_sums(pat.flat, torch.cat([vals, rvals], dim=1)[:, pat.src],
                  n * (n + 1))
    m[:, 0] = 1.0  # ground row: x[0] = 0
    diag = torch.arange(1, n, device=vals.device) * (n + 2)
    m[:, diag] = m[:, diag] + gmin[:, None]
    return m.view(b, n, n + 1)


def solve_plain(pat: StampPattern, vals, rvals, gmin):
    """The kernel's arithmetic as batched torch operations on any device."""
    return gauss_jordan(build_plain(pat, vals, rvals, gmin),
                        poison_rows(pat.n, vals.device))


def solve_lanes(pat: StampPattern, vals, rvals, gmin):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if vals.is_cuda:
        x = launch_stamped(pat, vals, rvals, gmin)
    elif vals.device.type == "cpu":
        x = solve_plain(pat, vals, rvals, gmin)
    else:
        raise ValueError(f"no stamped-solve kernel for device {vals.device}")
    return checked(x, "stamped solve")


@functools.lru_cache(maxsize=None)
def _pattern(n, rows_b, cols_b, rrows_b):
    return StampPattern(n, np.frombuffer(rows_b, np.int32),
                        np.frombuffer(cols_b, np.int32),
                        np.frombuffer(rrows_b, np.int32))


def solve_stamped_for(n, rows, cols, rrows, solve=solve_lanes):
    """The stamped solve of one static pattern: fn(vals (B, nnz), rvals
    (B, nrhs), gmin) -> x (B, n), gmin a float or a (B,) tensor (the
    pattern is cached; ``solve`` is the per-launch solver, ``solve_plain``
    to run the plain version on the card)."""
    pat = _pattern(int(n), np.asarray(rows, np.int32).tobytes(),
                   np.asarray(cols, np.int32).tobytes(),
                   np.asarray(rrows, np.int32).tobytes())

    def solver(vals, rvals, gmin):
        b = vals.shape[0]
        g = torch.as_tensor(gmin, dtype=F64, device=vals.device)
        g = g.expand(b).contiguous() if g.ndim == 0 else g.contiguous()
        return solve(pat, vals.contiguous(), rvals.contiguous(), g)

    solver.pattern = pat
    return solver
