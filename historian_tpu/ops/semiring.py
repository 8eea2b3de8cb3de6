"""Shared (log, +, logsumexp)-semiring helpers for the DP kernels.

The within-row recurrences u[j] = a[j] lse (u[j-1] + b[j]) of the
transducer DPs are affine maps in this semiring, so prefix results come
from an associative scan over (value, weight) pairs with composition
  (a_l, b_l) o (a_r, b_r) = (lse(a_r, a_l + b_r), b_l + b_r).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def lse(*xs):
    out = xs[0]
    for x in xs[1:]:
        out = jnp.logaddexp(out, x)
    return out


def cumsum(x):
    """Inclusive prefix sum via associative_scan.

    jnp.cumsum can lower to a padded reduce-window whose scratch scales
    with length^2; associative_scan lowers to log-depth slice/concat and
    stays small."""
    return jax.lax.associative_scan(jnp.add, x)


def affine_scan(a, b):
    """u[j] = logaddexp(a[j], u[j-1] + b[j]), u[-1] = -inf."""

    def combine(left, right):
        al, bl = left
        ar, br = right
        return jnp.logaddexp(ar, al + br), bl + br

    u, _ = jax.lax.associative_scan(combine, (a, b))
    return u
