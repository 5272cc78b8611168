"""Engineering-notation output formatting (a copy of the JAX package's
utils/formatter.py).

Mirrors reference pkg/util/formatter.go:8-59 — the CLI table format and, more
importantly, FormatValueFactor is part of the *algorithm*: transient result
rows whose formatted time strings collide are deduplicated
(pkg/analysis/anlysis.go:61-72).
"""


def format_value_factor(value: float, unit: str) -> str:
    a = abs(value)
    if a >= 1:
        return f"{value:.3f} {unit}"
    if a >= 1e-3:
        return f"{value * 1e3:.3f} m{unit}"
    if a >= 1e-6:
        return f"{value * 1e6:.3f} u{unit}"
    if a >= 1e-9:
        return f"{value * 1e9:.3f} n{unit}"
    if a >= 1e-12:
        return f"{value * 1e12:.3f} p{unit}"
    return f"{value:.3e} {unit}"


def format_frequency(freq: float) -> str:
    if freq >= 1e6:
        return f"{freq / 1e6:7.3f} MHz"
    if freq >= 1e3:
        return f"{freq / 1e3:7.3f} kHz"
    return f"{freq:7.3f} Hz "


def format_magnitude(value: float) -> str:
    if value >= 1000 or (value < 0.001 and value != 0):
        return f"{value:8.2e}"
    return f"{value:8.3g}"


def format_phase(value: float) -> str:
    return f"{value:6.1f}"
