"""The JAX package's engine overrides, read in one place.

``TOYSPICE_TRAN``, ``TOYSPICE_OP`` and ``TOYSPICE_AC``
(``general|fused|auto``) and ``TOYSPICE_TRAN_RUN=off`` choose an engine;
``TOYSPICE_SOLVER`` (``pallas|xla|auto``) and ``TOYSPICE_TRAN_IMPL=xla``
choose between a kernel and its plain version.  They are read when an
engine is built (the select functions of ``engine/batch.py``,
``engine/ac.make_ac_batch`` and the entry points of ``engine/__init__.py``),
which hand the chosen solves to the builders.  A kernel's wrapper reads
none of them: it launches its kernel on a CUDA tensor and runs its plain
version on a CPU tensor.  An engine built under an override names it in its
reason (``note``).
"""

import os

from ..ops import solve, solve_stamped

VARS = ("TOYSPICE_TRAN", "TOYSPICE_TRAN_RUN", "TOYSPICE_OP", "TOYSPICE_AC",
        "TOYSPICE_SOLVER", "TOYSPICE_TRAN_IMPL")


def mode(name):
    """``TOYSPICE_<name>`` (TRAN, OP or AC): "general", "fused" or
    "auto" (unset or any other value)."""
    v = os.environ.get(f"TOYSPICE_{name}", "auto")
    return v if v in ("general", "fused") else "auto"


def tran_run_off():
    """``TOYSPICE_TRAN_RUN=off``: a ``store='none'`` transient through the
    store instantiation."""
    return os.environ.get("TOYSPICE_TRAN_RUN", "auto") == "off"


def solver_backend():
    """``TOYSPICE_SOLVER`` as the JAX package names its values
    (ops/solve.py ``_solver_backend``): "pallas", the stamped-solve and GJ
    kernels alone, which refuse a CPU tensor; "xla", their plain torch
    versions on any device; "auto" (unset or any other value), the kernels
    for CUDA tensors and the plain versions for CPU tensors."""
    v = os.environ.get("TOYSPICE_SOLVER", "auto")
    return v if v in ("pallas", "xla") else "auto"


def kernels_plain():
    """``TOYSPICE_TRAN_IMPL=xla`` (the JAX package's switch to its kernels'
    XLA twins): the run, store, OP, DC sweep and AC kernels' plain
    versions on any device."""
    return os.environ.get("TOYSPICE_TRAN_IMPL", "kernel") == "xla"


def general_reason(name, why):
    """Why the general engine runs in place of the kernel engine that
    ``TOYSPICE_<name>`` chooses: ``why``, the kernel's own refusal; else
    ``TOYSPICE_<name>=general``; else the "xla" solver backend unless
    ``TOYSPICE_<name>=fused`` forces the kernel.  None when the kernel
    runs (engine/batch.py:96-112 and :319, engine/ac.py:91-111 of the JAX
    package)."""
    if why is not None:
        return why
    m = mode(name)
    if m == "general":
        return f"TOYSPICE_{name}=general override"
    if m == "auto" and solver_backend() == "xla":
        return ("solver backend is 'xla', not the hand-written kernels (set "
                f"TOYSPICE_{name}=fused to force)")
    return None


# the solves are looked up in their modules at each call, so that a caller
# that puts a recorder in a module's place sees every call


def _stamped_plain(pat, vals, rvals, gmin):
    return solve.checked(solve_stamped.solve_plain(pat, vals, rvals, gmin),
                         "stamped solve")


def _dense_plain(a, b):
    return solve.checked(solve.gj_plain(a, b), "dense solve")


def _kernel_only(t, what):
    if not t.is_cuda:
        raise ValueError(f"TOYSPICE_SOLVER=pallas asks for the {what} "
                         f"kernel, which does not run on {t.device}")


def _stamped_kernel(pat, vals, rvals, gmin):
    _kernel_only(vals, "stamped-solve")
    return solve.checked(solve_stamped.launch_stamped(pat, vals, rvals, gmin),
                         "stamped solve")


def _dense_kernel(a, b):
    _kernel_only(a, "GJ")
    return solve.checked(solve.launch_gj(a.contiguous(), b.contiguous()),
                         "dense solve")


def solves():
    """The general engine's stamped and dense solves as keywords of
    ``engine/op.make_op``, ``engine/tran.make_tran``, ``engine/ac.make_ac``
    (``solve``, ``dense_solve``) and ``engine/dc.make_dc`` (``solve``):
    {} under "auto" (the wrappers' own choice by device), the plain
    versions under "xla", the kernels alone under "pallas"."""
    backend = solver_backend()
    if backend == "xla":
        return {"solve": _stamped_plain, "dense_solve": _dense_plain}
    if backend == "pallas":
        return {"solve": _stamped_kernel, "dense_solve": _dense_kernel}
    return {}


def tran_op(cc, opts, semantics):
    """The OP a whole-run transient takes under the overrides, or None for
    ``ops/run.make_run_inputs``' own: the general OP under
    ``TOYSPICE_OP=general`` (pallas_run.py:727 of the JAX package) on a
    nonlinear deck, and the general OP with ``solves`` on a linear one."""
    from ..ops.run_plan import nonlinear
    from .op import make_op

    kw = solves()
    if (mode("OP") == "general") if nonlinear(cc) else bool(kw):
        return make_op(cc, opts, semantics, **kw)
    return None


def note(kernel):
    """What an engine built now runs in place of the default, for its
    reason: ``kernel`` True for a kernel engine (the run, store, OP, DC
    sweep or AC kernel), False for the general engine's solves; "" when
    nothing is overridden."""
    if kernel and kernels_plain():
        return "; TOYSPICE_TRAN_IMPL=xla: the kernel's plain version runs"
    if not kernel and solver_backend() == "xla":
        return ("; TOYSPICE_SOLVER=xla: the stamped and dense solves' "
                "plain versions run")
    if not kernel and solver_backend() == "pallas":
        return "; TOYSPICE_SOLVER=pallas: the solve kernels alone"
    return ""
