"""Batched dense linear solve: x = a^-1 b for (B, n, n) and (B, n) f64
systems, with the kernels' pivot rule.

The counterpart of ``ops/solve.py::linear_solve`` in the JAX package, whose
batching rule runs the TPU kernel ``ops/pallas_solve.py::_gj_kernel``
(``pallas_solve_batched``): the general engine's dense solves, the OP's
linear-devices-only initial estimate and the general AC's (2np1, 2np1)
system per (instance, frequency).  Gauss-Jordan with partial pivoting: the
largest |pivot| among the unused rows, the first (lowest) row on a tie; a
zero pivot poisons its row, so a singular system gives a non-finite x
(solve.py:17-23), and then, as after a NaN in a pivot column, every x of
the system is NaN (as the JAX package's one-hot gather gives).

* ``launch_gj``: the wrapper of ``csrc/gj_kernel.cu`` (one block per
  system, f64: up to NREG = 96 row i on thread i in registers, the dead
  columns dropped, the pivot row alone through shared memory, a division
  a thread; up to NWIDE = 144 the system in the registers of a 512-thread
  block; up to NBIG = 168 the matrix in shared memory; past it in a
  workspace in device memory, ``work_for``; ``body`` names the one that
  runs); it counts its launches in ``.launches``.
* ``gj_plain``: the same arithmetic as batched torch operations
  (``ops/newton.py::gauss_jordan``).
* ``linear_solve``: the kernel for CUDA tensors, the plain version for CPU
  tensors.

``debug_nans`` makes the two solves raise at their first non-finite x.
The JAX package's engine overrides are read where an engine is built
(``engine/overrides.py``), never here.
"""

import torch

from . import _build
from .newton import gauss_jordan, poison_rows

F64 = torch.float64
# csrc/gj_block.cuh's edges: GJ_NREG, the largest n with a row a thread;
# GJ_NWIDE, the largest with the system in a 512-thread block's registers;
# NBIG, the largest in shared memory (a block's 227 KB)
NREG = 96
NWIDE = 144
NBIG = 168
# blocks an SM of the device-memory body past NBIG (csrc/gj_block.cuh
# GJ_WORK_THREADS has the measurements), each with its slice of the
# workspace: at n = 256 a slice is 530 KB, 132 SMs x 1 take ~70 MB
WORK_BLOCKS_PER_SM = 1


def work_for(n, systems, device):
    """The workspace of the kernels' device-memory body past NBIG as an f64
    tensor on ``device``, None up to NBIG: a slice for each block of the
    bounded grid (at most ``systems``, WORK_BLOCKS_PER_SM an SM), each of
    csrc/gj_block.cuh gj_slice_doubles(n) = n (n + 3) doubles (the (n, n+1)
    matrix, n factors, n pivot rows and n used flags).  An allocation the
    card cannot hold raises, as torch does."""
    if n <= NBIG:
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    slices = max(1, min(systems, WORK_BLOCKS_PER_SM * sms))
    return torch.empty(slices * n * (n + 3), dtype=F64, device=device)


def body(n):
    """The elimination the GJ kernel, and the stamped solve past n = 64,
    run on systems of n (csrc/gj_block.cuh)."""
    if n <= NREG:
        return "registers, a row a thread"
    if n <= NWIDE:
        return "registers, 16 warps"
    return "shared memory" if n <= NBIG else "device memory"


def work_args(work):
    """(pointer, doubles) of a workspace for the C entries (0, 0 for
    None)."""
    return (0, 0) if work is None else (work.data_ptr(), work.numel())


def _check(a, b):
    if a.dtype != F64 or b.dtype != F64:
        raise TypeError(f"a and b must be float64, got {a.dtype} and "
                        f"{b.dtype}")
    if a.ndim != 3 or a.shape[1] != a.shape[2] or tuple(b.shape) != tuple(
            a.shape[:2]):
        raise ValueError(f"a must be (B, n, n) and b (B, n), got "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if b.device != a.device:
        raise ValueError(f"b is on {b.device}, a on {a.device}")


def launch_gj(a, b):
    """x (B, n) of every system with ``csrc/gj_kernel.cu``."""
    if not a.is_cuda:
        raise ValueError("launch_gj needs CUDA tensors")
    _check(a, b)
    n = a.shape[1]
    if n < 1:
        raise ValueError("the systems are empty (n = 0)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    lib = _build.load("gj")
    x = torch.empty((a.shape[0], n), dtype=F64, device=a.device)
    work = work_for(n, a.shape[0], a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = lib.tsr_gj(n, a.data_ptr(), b.data_ptr(), x.data_ptr(),
                         a.shape[0], *work_args(work), stream)
    if err != 0:
        raise RuntimeError(f"GJ kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err, 'gj')})")
    _build.count(launch_gj)
    return x


launch_gj.launches = 0


def gj_plain(a, b):
    """The kernel's arithmetic as batched torch operations on any device."""
    _check(a, b)
    return gauss_jordan(torch.cat([a, b[..., None]], dim=-1),
                        poison_rows(a.shape[1], a.device))


_debug = {"nans": False}


def debug_nans(on=True):
    """Make the GJ and stamped solves raise FloatingPointError at the
    first non-finite x they return (the port's ``jax_debug_nans``: one
    host sync a solve, and the rescue ladders legitimately pass through
    non-finite solves)."""
    _debug["nans"] = bool(on)


def checked(x, what):
    """x, or FloatingPointError under ``debug_nans``."""
    if _debug["nans"] and not bool(torch.isfinite(x).all()):
        raise FloatingPointError(f"debug_nans: the {what} returned a "
                                 "non-finite x")
    return x


def linear_solve(a, b):
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if a.is_cuda:
        x = launch_gj(a.contiguous(), b.contiguous())
    elif a.device.type == "cpu":
        x = gj_plain(a, b)
    else:
        raise ValueError(f"no GJ kernel for device {a.device}")
    return checked(x, "dense solve")
