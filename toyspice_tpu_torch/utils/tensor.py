"""Tensor arithmetic that rounds as the CUDA kernels' arithmetic does.

PyTorch computes a tensor over a Python float as the tensor times the
float's reciprocal on the card, and a Python float over a tensor as the
tensor's reciprocal times the float: one rounding more than the one
division the kernels in csrc/ do.  The plain versions divide by a tensor
of the float instead (``full_like`` keeps it free of host copies, so it
can run inside a captured CUDA graph)."""

import torch


def true_div(a, b: float):
    """a / b for a tensor a and a Python float b, one rounding."""
    return a / torch.full_like(a, b)


def scalar_div(a: float, b):
    """a / b for a Python float a and a tensor b, one rounding."""
    return torch.full_like(b, a) / b
