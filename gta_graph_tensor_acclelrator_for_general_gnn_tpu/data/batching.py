"""Block-diagonal graph batching for serving.

The reference executes one graph at a time (its simulator replays one
instruction stream per layer, ``vTCAD/code/start.py:36-58``); at serving
scale the per-dispatch fixed cost (grid setup, narrow-operand padding)
dominates small graphs.  Batching B graphs as one block-diagonal adjacency
amortises that cost: node ids of graph i are offset by ``sum(n_j, j<i)``,
the union COO feeds the same CSR kernels as a single graph (a
block-diagonal adjacency is just more rows), and per-graph outputs are recovered by slicing or segment readout.

All shapes stay static for a fixed batch spec: pad the batch with empty
slots up to ``max_graphs`` / per-graph node caps when serving variable
inputs (same padding discipline as GraphTensor edges).
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from ..graph import HostGraph, build_host_graph


def batch_graphs(
    graphs: Sequence[HostGraph],
    *,
    edge_pad_multiple: int = 512,
) -> Tuple[HostGraph, np.ndarray]:
    """Combine graphs into one block-diagonal :class:`HostGraph`.

    Returns ``(batched, node_graph_id)`` where ``node_graph_id[v]`` is the
    graph index owning global node v (int32 [n_total], the readout segment
    map).  Edge weights are preserved per graph (e.g. each graph's own
    symmetric norm).
    """
    offs = np.cumsum([0] + [g.n_node for g in graphs])
    s = np.concatenate(
        [g.senders[: g.n_edge] + offs[i] for i, g in enumerate(graphs)])
    r = np.concatenate(
        [g.receivers[: g.n_edge] + offs[i] for i, g in enumerate(graphs)])
    w = np.concatenate([g.edge_weight[: g.n_edge] for g in graphs])
    out = build_host_graph(s, r, int(offs[-1]), edge_weight=w,
                           edge_pad_multiple=edge_pad_multiple)
    gid = np.repeat(np.arange(len(graphs), dtype=np.int32),
                    [g.n_node for g in graphs])
    return out, gid


def batch_features(xs: Sequence[np.ndarray]) -> np.ndarray:
    """Stack per-graph node features [n_i, F] into the batched [sum n_i, F]
    layout matching :func:`batch_graphs` node numbering."""
    return np.concatenate([np.asarray(x) for x in xs], axis=0)


def readout_mean(
    h: jax.Array,
    node_graph_id: jax.Array,
    n_graphs: int,
) -> jax.Array:
    """Per-graph mean pooling: [N, F] node states -> [n_graphs, F].

    Static output shape (n_graphs is a Python int); runs as two segment
    sums — XLA lowers these to one pass each, and next to the layer stack
    they are noise.
    """
    tot = jax.ops.segment_sum(h, node_graph_id, n_graphs)
    cnt = jax.ops.segment_sum(jnp.ones((h.shape[0], 1), h.dtype),
                              node_graph_id, n_graphs)
    return tot / jnp.maximum(cnt, 1)
