"""``jnp.clip`` and ``jnp.abs`` with the JAX package's derivatives.

The pathwise channels (``engine/pathwise.py``) differentiate the physics
step with ``torch.autograd.forward_ad``, and must get the tangents that
``jax.linearize`` gets from the reference. The two libraries part at ties:

* ``jnp.clip`` (a ``maximum`` then a ``minimum``) has slope 1/2 at a bound
  where ``torch.clamp`` has 1: normal incidence puts the incidence cosine
  exactly at 1, and a wavelength on a grid point puts the grid fraction
  exactly at 0;
* ``jnp.abs`` has slope +1 at 0 (and at -0) where ``torch.abs`` has 0;
* ``torch.minimum`` and ``torch.maximum`` take 1/2 of each slope at a tie,
  as JAX does, but form the tangent as a difference that cancels when the
  other operand's slope is large: a box slab test whose ray is nearly
  parallel to one axis (a distance of 1e16 cm, its slope 1e33) then loses
  the slope of the face the ray does hit. ``minimum`` and ``maximum``
  below select the slope instead.

The forms below give the same values as the torch functions they stand
for, so the step's results do not change.
"""
import torch


def clip(x, lo=None, hi=None):
    """``torch.clamp(x, lo, hi)``: slope 1 inside, 1/2 at a bound, 0 outside."""
    y = torch.clamp(x, lo, hi)
    if lo is not None:
        y = torch.where(x == lo, 0.5 * (x + lo), y)
    if hi is not None:
        y = torch.where(x == hi, 0.5 * (x + hi), y)
    return y


def abs_(x):
    """``|x|``: slope +1 at 0."""
    return torch.where(x >= 0.0, x, -x)


def minimum(a, b):
    """``torch.minimum(a, b)``: the smaller one's slope, the mean at a tie."""
    return torch.where(a < b, a, torch.where(b < a, b, 0.5 * a + 0.5 * b))


def maximum(a, b):
    """``torch.maximum(a, b)``: the larger one's slope, the mean at a tie."""
    return torch.where(a > b, a, torch.where(b > a, b, 0.5 * a + 0.5 * b))
