"""Engineering-unit parsing (copy of the JAX package's utils/units.py)."""

from .units import parse_value

__all__ = ["parse_value"]
