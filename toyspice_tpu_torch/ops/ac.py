"""The AC solve of every (instance, frequency) pair in one kernel launch.

The counterpart of ``ops/pallas_ac.py`` in the JAX package
(``ac_fused_ineligible_reason``, ``_ac_core``, ``ac_solve_batch``).  The
AC system is exactly linear in omega, so one assemble per instance at
omega = 1 (``engine/ac.make_ac_batch``) gives G and the susceptance base
B^ (B, N, N) and the RHS (B, 2N); per lane b·F + f the solve builds
[[G, -omega B^], [omega B^, G]] with omega = 2 pi freqs[f] and eliminates
the real 2N system with the kernels' pivot rule.

* ``launch_ac_kernel``: the wrapper of ``csrc/ac_kernel.cu`` (f64, every
  np1: to 2N = 64 a segment of 16 or 32 lanes of a warp per system; past
  it a block per system on ``csrc/gj_block.cuh``'s bodies, the GJ
  kernel's, chosen by 2N as ``ops/solve.py body`` names them, past NBIG
  = 168 on a workspace in device memory, ``ops/solve.py work_for``; G, B^
  and the RHS read once per instance); it counts its launches in
  ``.launches``.
* ``ac_plain``: the same arithmetic as batched torch operations, at every
  size.
* ``ac_solve_batch``: the kernel for CUDA tensors, the plain version for
  CPU tensors.
"""

import math

import torch

from . import _build
from .newton import gauss_jordan, poison_rows
from .op import op_fused_ineligible_reason
from .run_plan import SLICE_KINDS, nonlinear, semantics_reason
from .solve import work_args, work_for

F64 = torch.float64


def ac_ineligible_reason(cc, semantics: str = "compat", opts=None):
    """Why this deck can NOT run the port's AC (its bias and the AC
    kernel); None when it can.  The AC kernel takes every np1, as the
    JAX package's ``ac_fused_ineligible_reason`` does; a nonlinear deck's
    bias is the OP kernel's, at any size of deck."""
    why = semantics_reason(semantics)
    if why is not None:
        return why
    extra = set(cc.idx.keys()) - set(SLICE_KINDS)
    if extra:
        return (f"device kinds {sorted(extra)} are not ported (the port "
                "runs R, C, L, LM, K, V, I, D, Q and M)")
    if nonlinear(cc):  # the bias is the OP kernel's
        return op_fused_ineligible_reason(cc, semantics, opts)
    return None


def _check(g, bh, r, omega):
    b, n = g.shape[0], g.shape[1]
    for name, x, shape in (("g", g, (b, n, n)), ("bh", bh, (b, n, n)),
                           ("r", r, (b, 2 * n)),
                           ("omega", omega, (omega.shape[0],))):
        if x.dtype != F64:
            raise TypeError(f"{name} must be float64, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if x.device != g.device:
            raise ValueError(f"{name} is on {x.device}, g on {g.device}")


def launch_ac_kernel(g, bh, r, omega):
    """x (B, F, 2N) of every (instance, frequency) system with
    ``csrc/ac_kernel.cu``."""
    if not g.is_cuda:
        raise ValueError("launch_ac_kernel needs CUDA tensors")
    _check(g, bh, r, omega)
    b, n, nf = g.shape[0], g.shape[1], omega.shape[0]
    if n < 1:
        raise ValueError("the systems are empty (np1 = 0)")
    lib = _build.load("ac")
    x = torch.empty((b, nf, 2 * n), dtype=F64, device=g.device)
    work = work_for(2 * n, b * nf, g.device)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.tsr_ac(n, b, nf, g.data_ptr(), bh.data_ptr(), r.data_ptr(),
                         omega.data_ptr(), x.data_ptr(), *work_args(work),
                         stream)
    if err != 0:
        raise RuntimeError(f"AC kernel launch failed: CUDA error {err} "
                           f"({_build.error_string(err, 'ac')})")
    _build.count(launch_ac_kernel)
    return x


launch_ac_kernel.launches = 0


def build_systems(g, bh, r, omega):
    """The augmented (B·F, 2N, 2N+1) systems the kernel solves, lane
    b·F + f (``chip_smoke.py`` hands them to the library solve too)."""
    b, n, nf = g.shape[0], g.shape[1], omega.shape[0]
    wb = omega[None, :, None, None] * bh[:, None]  # (B, F, N, N)
    gg = g[:, None].expand(b, nf, n, n)
    top = torch.cat([gg, -wb], dim=3)
    bot = torch.cat([wb, gg], dim=3)
    rhs = r[:, None, :, None].expand(b, nf, 2 * n, 1)
    m = torch.cat([torch.cat([top, bot], dim=2), rhs], dim=3)
    return m.reshape(b * nf, 2 * n, 2 * n + 1)


def ac_plain(g, bh, r, omega):
    """The kernel's arithmetic as batched torch operations on any device."""
    _check(g, bh, r, omega)
    b, n, nf = g.shape[0], g.shape[1], omega.shape[0]
    x = gauss_jordan(build_systems(g, bh, r, omega),
                     poison_rows(2 * n, g.device))
    return x.reshape(b, nf, 2 * n)


def ac_solve_batch(g, bh, r, freqs, solve=None):
    """x2 (B, F, 2N) for G, B^ (B, N, N), the RHS (B, 2N) and the
    frequencies (F,) in Hz: the kernel for CUDA tensors, its plain version
    for CPU tensors (``solve`` overrides: ``ac_plain`` runs the plain
    version on the card)."""
    omega = (2.0 * math.pi * torch.as_tensor(freqs, dtype=F64,
                                              device=g.device)).contiguous()
    args = (g.contiguous(), bh.contiguous(), r.contiguous(), omega)
    if solve is not None:
        return solve(*args)
    if g.is_cuda:
        return launch_ac_kernel(*args)
    if g.device.type == "cpu":
        return ac_plain(*args)
    raise ValueError(f"no AC kernel for device {g.device}")
