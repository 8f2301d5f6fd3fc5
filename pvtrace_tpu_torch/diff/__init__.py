"""Differentiable transport: score-function gradients of fate fractions
and the Beer–Lambert surrogate (``transport``)."""
from pvtrace_tpu_torch.diff import transport

__all__ = ["transport"]
