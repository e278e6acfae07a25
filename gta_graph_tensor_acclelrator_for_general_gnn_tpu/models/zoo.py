"""Multi-layer models stacked from single-layer op graphs.

The reference runs one layer at a time through its pipeline (GAT = layer1..3,
others ``alllayer`` — ``vTCAD/code/start.py:26-29``); here a :class:`Model`
stacks per-layer :class:`~..ir.OpGraph` s into one end-to-end JAX function so
XLA sees (and fuses across) the whole network.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import jax
import jax.numpy as jnp

from .. import ir
from ..compiler import lower as L
from ..graph import GraphTensor
from .builders import build_op_graph, NETWORKS


@dataclasses.dataclass
class Model:
    """A stack of per-layer op graphs with a shared parameter namespace."""

    name: str
    layers: List[ir.OpGraph]

    def init(self, key: jax.Array, dtype=jnp.float32) -> Dict[str, jax.Array]:
        params: Dict[str, jax.Array] = {}
        for g in self.layers:
            key, sub = jax.random.split(key)
            params.update(L.init_params(g, sub, dtype))
        return params

    def make_apply(self, compute_dtype=None, schedules=None, host_graph=None,
                   build_transpose=False):
        """Forward over the layer stack.

        ``schedules``: optional per-layer :class:`~..compiler.schedule.Schedule`
        (or one schedule reused for all layers) — layers then lower through
        the fusion compiler (CSR kernels / streaming per the schedule) and
        remain trainable (the kernels carry custom VJPs).  Requires
        ``host_graph`` for the CSR builds.

        The returned ``apply(params, g, x)`` carries ``apply.captures`` (the
        layers' graph data) and ``apply.inner(params, g, x, captures)``, so
        a caller can pass the graph data as jit ARGUMENTS instead of
        embedding GB-scale arrays in the program as constants.
        """
        if schedules is None:
            fns = [L.lower(g, compute_dtype) for g in self.layers]
            caps: tuple = ()
            inners = [None] * len(fns)
        else:
            from ..compiler.fusion import lower_schedule
            if not isinstance(schedules, (list, tuple)):
                schedules = [schedules] * len(self.layers)
            assert host_graph is not None, "schedules need host_graph"
            shared_cache: dict = {}
            fns = [lower_schedule(g, s, host_graph, compute_dtype,
                                  build_transpose=build_transpose,
                                  graph_cache=shared_cache)
                   for g, s in zip(self.layers, schedules)]
            caps = tuple(f.captures for f in fns)
            inners = [f.inner for f in fns]

        def inner(params, g: GraphTensor, x: jax.Array, captures):
            h = x
            for i, fn in enumerate(fns):
                h = (fn(params, g, h) if inners[i] is None
                     else inners[i](params, g, h, captures[i]))
            return h

        def apply(params, g: GraphTensor, x: jax.Array) -> jax.Array:
            return inner(params, g, x, caps)

        apply.inner = inner
        apply.captures = caps
        return apply


def build_model(
    network: str,
    in_width: int,
    n_class: int,
    *,
    hidden: int = 128,
    n_layers: int = 2,
    heads: int = 4,
    reorder: bool = False,
) -> Model:
    """Build an ``n_layers`` model of ``network`` ending in ``n_class`` logits.

    Hidden layers use the family's default activation; the last layer emits
    raw logits (sf=identity) for the classifier head.  GAT hidden layers use
    ``heads`` attention heads (out widths stay multiples of heads); the final
    GAT layer uses a single head, matching the usual Cora GAT configuration.
    """
    if network not in NETWORKS:
        raise ValueError(f"unknown network {network!r}")
    layers: List[ir.OpGraph] = []
    w = in_width
    for i in range(n_layers):
        last = i == n_layers - 1
        out_w = n_class if last else hidden
        kw = dict(
            reorder=reorder,
            layer_tag=f"l{i}",
            final_sf="identity" if last else ("elu" if network == "GAT" else "relu"),
        )
        if network == "GAT":
            kw["heads"] = 1 if last else heads
        if network in ("GIN", "PNA"):
            kw["hidden"] = hidden
        layers.append(build_op_graph(network, w, out_w, **kw))
        w = out_w
    return Model(name=f"{network}-{n_layers}l", layers=layers)
