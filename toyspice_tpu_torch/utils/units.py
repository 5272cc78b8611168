"""SPICE engineering-unit value parsing.

Behavior mirrors the reference ParseValue (pkg/netlist/parser.go:727-748)
including its quirks:

* the suffix regex accepts ``M`` but the unit map has no ``M`` entry, so
  ``1M`` parses as 1.0 (only ``meg`` means 1e6);
* an optional trailing ``s`` is swallowed (``0.1ms`` == 1e-4, ``20ns`` == 2e-8);
* ``K`` and ``k`` both mean 1e3.
"""

import re

_UNIT_MAP = {
    "T": 1e12,
    "G": 1e9,
    "meg": 1e6,
    "K": 1e3,
    "k": 1e3,
    "m": 1e-3,
    "u": 1e-6,
    "n": 1e-9,
    "p": 1e-12,
    "f": 1e-15,
}

_VALUE_RE = re.compile(r"^([-+]?\d*\.?\d+(?:[eE][-+]?\d+)?)(meg|[TGMKkmunpf])?s?$")


def parse_value(text: str) -> float:
    """Parse ``1k`` -> 1000.0 etc.  Raises ValueError on malformed input."""
    m = _VALUE_RE.match(text.strip())
    if m is None:
        raise ValueError(f"invalid value format: {text}")
    num = float(m.group(1))
    suffix = m.group(2)
    if suffix:
        # Unknown suffixes that matched the regex ('M') are ignored, like the
        # reference's missing-map-entry behavior.
        num *= _UNIT_MAP.get(suffix, 1.0)
    return num
