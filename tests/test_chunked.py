"""Edge-streaming (chunked) aggregation tests — the Reddit-scale full-batch
path must be allclose to the materialised XLA formulation."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as S
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion import lower_schedule
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import init_params, lower
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import chunked, primitives as P

from conftest import small_graph


def _g(rng, n=80, e=600):
    s, r = small_graph(rng, n=n, e=e, multi_edges=True)
    hg = gta.build_host_graph(s, r, n, add_self_loops=True, symmetric_norm=True)
    return hg, hg.to_device()


def test_spmm_chunked_matches_xla(rng):
    hg, g = _g(rng)
    x = jnp.asarray(rng.normal(size=(g.n_node, 24)).astype(np.float32))
    ref = P.gather_to_nodes(
        P.scatter_to_edges(x, g, "C") * g.edge_weight[:, None], g, "ADD")
    for chunk in (128, 512, 10**6):
        out = jax.jit(lambda gg, xx: chunked.spmm_chunked(gg, xx, chunk=chunk))(g, x)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                                   rtol=1e-5, atol=1e-5)


def test_gat_chunked_matches_xla_graph(rng):
    hg, g = _g(rng, n=60, e=400)
    og = gta.build_op_graph("GAT", 12, 8, heads=2)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(g.n_node, 12)).astype(np.float32))
    ref = lower(og)(params, g, x)

    part = S.pattern_partition(og)
    tiles = tuple(
        S.TileConfig(path=S.PATH_STREAM, tile_edges=1)
        if len(b) > 1 else S.TileConfig(path=S.PATH_XLA)
        for b in part)
    fn = lower_schedule(og, S.Schedule(blocks=part, tiles=tiles), hg)
    out = fn(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_spmm_stream_schedule_gcn(rng):
    hg, g = _g(rng)
    og = gta.build_op_graph("GCN", 16, 8)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(g.n_node, 16)).astype(np.float32))
    ref = lower(og)(params, g, x)
    part = S.max_fusion_partition(og)
    tiles = tuple(
        S.TileConfig(path=S.PATH_STREAM, tile_edges=1)
        if len(b) >= 2 else S.TileConfig(path=S.PATH_XLA) for b in part)
    fn = lower_schedule(og, S.Schedule(blocks=part, tiles=tiles), hg)
    out = fn(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_gat_chunked_gradients(rng):
    """Streaming path is pure XLA -> differentiable without custom vjp."""
    hg, g = _g(rng, n=40, e=250)
    H, D = 2, 4
    h = jnp.asarray(rng.normal(size=(g.n_node, H * D)).astype(np.float32))
    a1 = jnp.asarray(rng.normal(size=(g.n_node, H)).astype(np.float32))
    a2 = jnp.asarray(rng.normal(size=(g.n_node, H)).astype(np.float32))

    def loss_stream(h, a1, a2):
        return jnp.sum(chunked.gat_chunked(g, h, a1, a2, chunk=64) ** 2)

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops.gat import (
        gat_reference)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        csr_graph)
    cg = csr_graph(hg, unit_weight=True)

    def loss_ref(h, a1, a2):
        return jnp.sum(gat_reference(cg, h, a1, a2, 0.2) ** 2)

    gs = jax.grad(loss_stream, argnums=(0, 1, 2))(h, a1, a2)
    gr = jax.grad(loss_ref, argnums=(0, 1, 2))(h, a1, a2)
    for a, b in zip(gs, gr):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("spread", [10.0, 30.0])
def test_gat_chunked_gradients_finite_under_wide_logit_spread(rng, spread):
    """Rows whose logits all sit far below the shift bound get a den near
    float32's floor; the gradient stays finite there (autodiff of the plain
    quotient forms 1 / den**2 and turns it into NaN)."""
    hg, g = _g(rng, n=400, e=3000)
    H, D = 4, 8
    h = jnp.asarray(rng.normal(size=(g.n_node, H * D)).astype(np.float32))
    a1 = jnp.asarray(spread * rng.normal(size=(g.n_node, H)).astype(np.float32))
    a2 = jnp.asarray(spread * rng.normal(size=(g.n_node, H)).astype(np.float32))

    def loss(h, a1, a2):
        return jnp.sum(chunked.gat_chunked(g, h, a1, a2, chunk=1024) ** 2)

    for d in jax.grad(loss, argnums=(0, 1, 2))(h, a1, a2):
        assert bool(jnp.all(jnp.isfinite(d)))


def test_stream_normalise_derivative_is_the_quotient_rule():
    num = jnp.array([[3.0, -1.0], [2e-20, 5e-20]], jnp.float32)
    den = jnp.array([[2.0, 2.0], [3e-20, 3e-20]], jnp.float32)
    dn = jnp.array([[0.5, 1.0], [1e-20, 0.0]], jnp.float32)
    dd = jnp.array([[0.25, -1.0], [0.0, 1e-20]], jnp.float32)
    out, tan = jax.jvp(chunked._normalise, (num, den), (dn, dd))
    np.testing.assert_allclose(np.asarray(out), np.asarray(num / den),
                               rtol=1e-6)
    want = (np.float64(dn) * np.float64(den) - np.float64(num)
            * np.float64(dd)) / np.float64(den) ** 2
    np.testing.assert_allclose(np.asarray(tan), want, rtol=1e-5)
