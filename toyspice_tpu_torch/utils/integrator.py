"""Integration-method coefficient tables (a copy of the JAX package's
utils/integrator.py).

Mirrors reference pkg/util/integrator.go.  The reference engine only ever calls
``GetIntegratorCoeffs(GearMethod, 1, dt)`` (inductor.go:72, magnetic.go:244,265)
— i.e. it is effectively backward-Euler order 1 — but the full BDF 1-6 and
trapezoidal tables are provided for the ``physics`` semantics mode and future
higher-order integration.
"""

GEAR = 0
TRAPEZOIDAL = 1

# (coefficients, beta) per order 1..6
_BDF = [
    ([1.0], 1.0),
    ([4.0 / 3.0, -1.0 / 3.0], 2.0 / 3.0),
    ([18.0 / 11.0, -9.0 / 11.0, 2.0 / 11.0], 6.0 / 11.0),
    ([48.0 / 25.0, -36.0 / 25.0, 16.0 / 25.0, -3.0 / 25.0], 12.0 / 25.0),
    (
        [300.0 / 137.0, -300.0 / 137.0, 200.0 / 137.0, -75.0 / 137.0, 12.0 / 137.0],
        60.0 / 137.0,
    ),
    (
        [
            360.0 / 147.0,
            -450.0 / 147.0,
            400.0 / 147.0,
            -225.0 / 147.0,
            72.0 / 147.0,
            -10.0 / 147.0,
        ],
        60.0 / 147.0,
    ),
]


def get_bdf_coeffs(order: int, dt: float) -> list:
    if order < 1 or order > 6:
        order = 1
    coeffs, beta = _BDF[order - 1]
    scale = 1.0 / (beta * dt)
    return [scale] + [-c * scale for c in coeffs]


def get_trapezoidal_coeffs(order: int, dt: float) -> list:
    if order < 1 or order > 2:
        order = 1
    return [1.0 / dt] if order == 1 else [2.0 / dt]


def get_integrator_coeffs(method: int, order: int, dt: float) -> list:
    if method == TRAPEZOIDAL:
        return get_trapezoidal_coeffs(order, dt)
    return get_bdf_coeffs(order, dt)
