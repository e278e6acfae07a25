"""What every Pallas kernel of this package shares: the route, the
interpret decision and the custom-VJP helpers.

The kernels are written for the GPU through Pallas' Triton route
(``backend="triton"``).  On the CPU backend, which only the tests use, they
run in interpret mode; on the GPU they always compile, and none falls back
to a reference.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def interpret_mode() -> bool:
    """True on the CPU backend (tests run the kernels interpreted there),
    False on the GPU, where every kernel compiles through Triton."""
    return jax.default_backend() == "cpu"


def pow2_at_least(n: int) -> int:
    """Smallest power of two >= n (Triton block sizes are powers of two)."""
    return 1 << max(int(n) - 1, 0).bit_length()


def zero_cotangent(tree):
    """Zero cotangents for a pytree of non-differentiable graph arrays
    (float0 for integer leaves), as a custom_vjp backward must return."""
    def z(leaf):
        if jnp.issubdtype(leaf.dtype, jnp.floating):
            return jnp.zeros(leaf.shape, leaf.dtype)
        return np.zeros(leaf.shape, jax.dtypes.float0)
    return jax.tree.map(z, tree)


def pad_rows(v: jax.Array, value=0) -> jax.Array:
    """Append one row of ``value`` (the dump row that padded edges and
    padding pieces index)."""
    return jnp.concatenate(
        [v, jnp.full((1,) + v.shape[1:], value, v.dtype)], axis=0)
