"""Engineering units, the CLI's formatting and the integration tables
(copies of the JAX package's utils), and profiling hooks."""

from .units import parse_value
from .formatter import (
    format_value_factor,
    format_frequency,
    format_magnitude,
    format_phase,
)
from .integrator import get_integrator_coeffs, GEAR, TRAPEZOIDAL

__all__ = [
    "parse_value",
    "format_value_factor",
    "format_frequency",
    "format_magnitude",
    "format_phase",
    "get_integrator_coeffs",
    "GEAR",
    "TRAPEZOIDAL",
]
