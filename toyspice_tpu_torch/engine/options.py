"""Solver options: the reference's hard-coded knobs as a proper dataclass.

The reference hard-codes every solver constant (SURVEY.md §5 "Config"):
convergence in anlysis.go:38-41, trtol in tran.go:50, the timestep clamps in
tran.go:30-34, and 300.15 K everywhere (op.go:41, tran.go:108, dc.go:116).
``SimOptions`` exposes them with identical defaults; every ``make_*`` engine
factory and ``run_*`` entry point accepts one.  Frozen + hashable so an
options value can key the per-circuit engine cache and act as a static
argument of jitted factories.
"""

from dataclasses import dataclass


@dataclass(frozen=True)
class SimOptions:
    # Newton-Raphson convergence (reference anlysis.go:38-41)
    max_iter: int = 100
    reltol: float = 1e-6
    abstol: float = 1e-12
    gmin: float = 1e-12  # floor for the capacitor OP leak (capacitor.go:73)

    # transient step control (tran.go:30-34, 50)
    trtol: float = 7.0
    tstep_divisor: float = 300.0  # tstep clamped to tstop/this
    minstep_divisor: float = 50.0  # minstep = tstep/this

    # simulation temperature in kelvin (op.go:41, tran.go:108, dc.go:116)
    temp: float = 300.15

    # companion-model integration for physics semantics: "be" (backward
    # Euler, the reference's effective method — it only ever calls
    # GetIntegratorCoeffs(Gear, 1, dt), integrator.go) or "trap"
    # (trapezoidal, 2nd order).  compat semantics is BE by definition.
    integration: str = "be"

    def __post_init__(self):
        if self.integration not in ("be", "trap"):
            raise ValueError(
                f"integration must be 'be' or 'trap', got {self.integration!r}")


DEFAULTS = SimOptions()
