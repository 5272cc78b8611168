"""Analyses of the port: so far the batched transient (``batch``)."""
