"""Block-diagonal batching: batched execution == per-graph execution."""
import numpy as np
import jax.numpy as jnp

from gta_graph_tensor_acclelrator_for_general_gnn_tpu import ir
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.batching import (
    batch_features, batch_graphs, readout_mean)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
    build_host_graph, csr_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import (
    primitives as P)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops.spmm import spmm_raw

from conftest import small_graph


def _one(rng, n, e):
    s, r = small_graph(rng, n=n, e=e)
    return build_host_graph(s, r, n, symmetric_norm=True,
                            edge_pad_multiple=128)


def test_batched_spmm_matches_per_graph(rng):
    gs = [_one(rng, 40 + 8 * i, 150 + 30 * i) for i in range(3)]
    xs = [rng.normal(size=(g.n_node, 24)).astype(np.float32) for g in gs]
    bat, gid = batch_graphs(gs, edge_pad_multiple=128)
    assert bat.n_node == sum(g.n_node for g in gs)
    assert bat.n_edge == sum(g.n_edge for g in gs)
    xb = jnp.asarray(batch_features(xs))
    yb = np.asarray(spmm_raw(csr_graph(bat), xb))[: bat.n_node]
    off = 0
    for g, x in zip(gs, xs):
        gd = g.to_device()
        e = P.scatter_to_edges(jnp.asarray(x), gd, "C") * \
            gd.edge_weight[:, None]
        y = np.asarray(P.gather_to_nodes(e, gd, ir.ADD))
        np.testing.assert_allclose(yb[off:off + g.n_node], y,
                                   rtol=1e-4, atol=1e-4)
        off += g.n_node


def test_readout_mean(rng):
    gs = [_one(rng, 30, 100), _one(rng, 50, 200)]
    bat, gid = batch_graphs(gs, edge_pad_multiple=128)
    h = jnp.asarray(rng.normal(size=(bat.n_node, 8)).astype(np.float32))
    out = np.asarray(readout_mean(h, jnp.asarray(gid), 2))
    np.testing.assert_allclose(out[0], np.asarray(h)[:30].mean(axis=0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out[1], np.asarray(h)[30:80].mean(axis=0),
                               rtol=1e-5, atol=1e-5)
