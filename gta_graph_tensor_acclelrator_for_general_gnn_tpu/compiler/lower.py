"""IR -> JAX lowering (the replacement for the reference's interpreter).

Where the reference interpreter lowers a fused schedule to a YAML instruction
stream that is *replayed by a simulator* (vTCAD/code/interpreter.py:809-853),
this module lowers an :class:`~..ir.OpGraph` to a plain JAX function that XLA
compiles for the device.  A second entry point (``lower_schedule``, in
``fusion.py``) pattern-matches fused blocks onto the CSR kernels; every other
block lowers to these XLA primitives, which XLA fuses further.
"""
from __future__ import annotations

from typing import Callable, Dict

import jax
import jax.numpy as jnp

from .. import ir
from ..graph import GraphTensor
from ..ops import primitives as P


def init_params(graph: ir.OpGraph, key: jax.Array, dtype=jnp.float32) -> Dict[str, jax.Array]:
    """Glorot-uniform init for every MM weight in the op graph."""
    params: Dict[str, jax.Array] = {}
    for name, iw, ow in graph.param_specs():
        key, sub = jax.random.split(key)
        limit = (6.0 / (iw + ow)) ** 0.5
        params[name] = jax.random.uniform(
            sub, (iw, ow), dtype, minval=-limit, maxval=limit)
    return params


def _eval_op(
    op: ir.Op,
    vals: Dict[int, jax.Array],
    params: Dict[str, jax.Array],
    g: GraphTensor,
    x: jax.Array,
    compute_dtype,
) -> jax.Array:
    def ref(i: int) -> jax.Array:
        if i == ir.X_INPUT:
            return x
        if i == ir.EDGE_WEIGHT:
            return g.edge_weight[:, None]
        return vals[i]

    ins = [ref(i) for i in op.inputs] if op.inputs else [x]

    if op.kind == ir.SCATTER:
        return P.scatter_to_edges(ins[0], g, op.order)
    if op.kind == ir.GATHER:
        return P.gather_to_nodes(ins[0], g, op.compute, op.order)

    # apply_edge / apply_node
    c = op.compute
    if c == ir.NONE:
        return ins[0]
    if c == ir.MM:
        name, _, _ = op.extra["weight"]
        return P.dense_mm(ins[0], params[name], compute_dtype)
    if c == ir.SF:
        return P.special_function(
            ins[0], op.extra.get("sf", "relu"),
            op.extra.get("negative_slope", 0.2))
    if c in (ir.ADD, ir.MUL, ir.SUB, ir.DIV):
        if len(ins) == 2:
            return P.binary_op(c, ins[0], ins[1])
        const = jnp.asarray(op.extra["const"], ins[0].dtype)
        return P.binary_op(c, ins[0], jnp.broadcast_to(const, (1, 1)))
    raise ValueError(f"op {op.op_id}: unhandled compute {c}")


def lower(
    graph: ir.OpGraph,
    compute_dtype=None,
) -> Callable[[Dict[str, jax.Array], GraphTensor, jax.Array], jax.Array]:
    """Lower an OpGraph to ``apply(params, g, x) -> out``.

    Returns the single designated output array (or a dict keyed by op id when
    the graph has several outputs).
    """
    order = graph.topo_order()
    outputs = list(graph.outputs)

    def apply(params: Dict[str, jax.Array], g: GraphTensor, x: jax.Array):
        vals: Dict[int, jax.Array] = {}
        for oid in order:
            op = graph.by_id[oid]
            vals[oid] = _eval_op(op, vals, params, g, x, compute_dtype)
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    return apply
