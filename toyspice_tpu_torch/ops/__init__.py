"""The whole-run transient, the OP, DC sweep and AC kernels, the stamped
and dense solves: host tables, kernel wrappers and plain versions.

The exports are the counterparts of the JAX package's ``ops``: the dense
solve ``linear_solve`` (its batching rule's Pallas kernel is the GJ kernel
in the port, ``launch_gj``, in place of ``pallas_solve_batched``), the
assembly functions, and ``solve_stamped_for`` over the stamped-solve kernel
(``launch_stamped``).
"""

from .solve import launch_gj, linear_solve
from .assemble import (
    assemble_entries,
    assemble_system,
    assemble_system_ac,
    load_gmin,
)
from .solve_stamped import launch_stamped, solve_stamped_for

__all__ = [
    "linear_solve",
    "assemble_entries",
    "assemble_system",
    "assemble_system_ac",
    "load_gmin",
    "launch_gj",
    "launch_stamped",
    "solve_stamped_for",
]
