"""Shared example preamble: the examples run on the card unless
TOYSPICE_PLATFORM=cpu (the variable the JAX package's examples read)."""

import os


def device() -> str:
    return "cpu" if os.environ.get("TOYSPICE_PLATFORM") == "cpu" else "cuda"
