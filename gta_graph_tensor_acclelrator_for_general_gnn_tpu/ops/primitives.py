"""XLA reference implementations of the four IR primitives.

These are the *correctness oracles*: every Pallas kernel in this package must
be allclose to the functions here (SURVEY §7 layer 2 — "the IR lowers to a
JAX function; correctness oracle = plain XLA ops").  They are also a fast
production path in their own right — XLA fuses the elementwise chains, and
``segment_sum`` over receiver-sorted edges lowers to an efficient sorted
scatter-add.

Semantics mirror the reference ops (vTCAD/GraphOP/genGraphOP.py):
  scatter  ORDER=C: broadcast node rows to edges by *sender* (column-wise);
           ORDER=R: by *receiver* (row-wise).
  gather   segment-reduce edge rows to their receiver node (ADD/MAX/MEAN).
  apply_edge / apply_node: elementwise or dense-matmul transforms.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp

from .. import ir
from ..graph import GraphTensor

# ---------------------------------------------------------------------------
# scatter / gather
# ---------------------------------------------------------------------------


def scatter_to_edges(x: jax.Array, g: GraphTensor, order: str = "C") -> jax.Array:
    """Node [N, F] -> edge [E_pad, F].  Padding edges read a zero dump row."""
    idx = g.senders if order == "C" else g.receivers
    dump = jnp.zeros((1,) + x.shape[1:], x.dtype)
    x1 = jnp.concatenate([x, dump], axis=0)
    # padded edges carry idx == n_node -> the dump row
    return jnp.take(x1, idx, axis=0)


def gather_to_nodes(
    e: jax.Array,
    g: GraphTensor,
    reduce: str = ir.ADD,
    order: str = "R",
) -> jax.Array:
    """Edge [E_pad, F] -> node [N, F] segment reduction.

    Receiver-sorted edges let XLA use the sorted scatter path
    (indices_are_sorted=True); padding edges land in segment n_node which is
    sliced away.
    """
    idx = g.receivers if order == "R" else g.senders
    sorted_ = order == "R"  # GraphTensor sorts by receiver
    num = g.n_node + 1
    if reduce == ir.ADD:
        out = jax.ops.segment_sum(e, idx, num, indices_are_sorted=sorted_)
    elif reduce == ir.MAX:
        out = jax.ops.segment_max(e, idx, num, indices_are_sorted=sorted_)
        out = jnp.where(jnp.isfinite(out), out, jnp.zeros_like(out))
    elif reduce == ir.MEAN:
        s = jax.ops.segment_sum(e, idx, num, indices_are_sorted=sorted_)
        d = jax.ops.segment_sum(
            g.edge_mask.astype(e.dtype), idx, num, indices_are_sorted=sorted_)
        out = s / jnp.maximum(d, 1.0)[:, None]
    else:
        raise ValueError(f"bad gather reduce {reduce}")
    return out[: g.n_node]


# ---------------------------------------------------------------------------
# elementwise / matmul appliers
# ---------------------------------------------------------------------------

_SF_FNS: dict[str, Callable] = {
    "relu": jax.nn.relu,
    "leaky_relu": None,  # handled specially (slope)
    "exp": jnp.exp,
    "elu": jax.nn.elu,
    "sigmoid": jax.nn.sigmoid,
    "tanh": jnp.tanh,
    "identity": lambda x: x,
    "log_softmax": lambda x: jax.nn.log_softmax(x, axis=-1),
}


def special_function(x: jax.Array, name: str, negative_slope: float = 0.2) -> jax.Array:
    if name == "leaky_relu":
        return jax.nn.leaky_relu(x, negative_slope)
    fn = _SF_FNS.get(name)
    if fn is None:
        raise ValueError(f"unknown SF {name}")
    return fn(x)


def _broadcast_pair(a: jax.Array, b: jax.Array):
    """Broadcast rule for binary elementwise ops on [*, Fa] x [*, Fb].

    Equal widths -> as-is; width 1 broadcasts; if one width divides the other
    the narrow operand is head-major broadcast (alpha [E, H] against
    h [E, H*D] -> alpha repeated D times per head).  This is how multi-head
    attention coefficients meet per-head feature blocks in the IR.
    """
    fa, fb = a.shape[-1], b.shape[-1]
    if fa == fb:
        return a, b
    if fa == 1 or fb == 1:
        return a, b  # jnp broadcasting handles it
    if fb > fa and fb % fa == 0:
        a = jnp.repeat(a, fb // fa, axis=-1)
        return a, b
    if fa > fb and fa % fb == 0:
        b = jnp.repeat(b, fa // fb, axis=-1)
        return a, b
    raise ValueError(f"incompatible widths {fa} vs {fb}")


def binary_op(compute: str, a: jax.Array, b: jax.Array) -> jax.Array:
    a, b = _broadcast_pair(a, b)
    if compute == ir.ADD:
        return a + b
    if compute == ir.MUL:
        return a * b
    if compute == ir.SUB:
        return a - b
    if compute == ir.DIV:
        return a / b
    raise ValueError(f"bad binary compute {compute}")


def dense_mm(x: jax.Array, w: jax.Array, compute_dtype=None) -> jax.Array:
    """X @ W on the tensor cores with f32 accumulation.

    ``compute_dtype=jnp.bfloat16`` is the production policy;
    None keeps the input dtype (used by the allclose correctness tests).
    """
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
        w = w.astype(compute_dtype)
    return jnp.dot(x, w, preferred_element_type=jnp.float32)
