"""Schedule search-space and fused-lowering tests.

Correctness contract: every legal schedule of every model family must produce
the same numbers as the plain per-op XLA lowering (the reference's schedule
space only changes *where* data moves, never *what* is computed)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import ir
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import schedule as S
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion import (
    lower_schedule, match_spmm)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import (
    init_params, lower)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops.gat import match_gat_block

from conftest import small_graph


def _graphs(rng, n=60, e=300):
    s, r = small_graph(rng, n=n, e=e)
    hg = gta.build_host_graph(s, r, n, add_self_loops=True, symmetric_norm=True)
    return hg, hg.to_device()


def test_enumerate_partitions_gcn(rng):
    og = gta.build_op_graph("GCN", 16, 8)
    parts = S.enumerate_partitions(og)
    # 3 DAG edges, no breakpoints in the GCN chain -> up to 8 partitions,
    # all legal here
    assert S.singleton_partition(og) in parts
    assert len(parts) >= 4
    for p in parts:
        assert ir.partition_is_legal(og, [list(b) for b in p])


def test_breakpoint_edges_never_fused(rng):
    og = gta.build_op_graph("SGC", 16, 8)  # gather->scatter inside
    parts = S.enumerate_partitions(og)
    for p in parts:
        for b in p:
            ops = [og.by_id[o] for o in b]
            for u in b:
                for v in b:
                    if v in og.by_id[u].inputs:
                        pass
        assert ir.partition_is_legal(og, [list(b) for b in p])
    mf = S.max_fusion_partition(og)
    assert ir.partition_is_legal(og, [list(b) for b in mf])
    # SGC has a gather->scatter breakpoint: max fusion cannot be one block
    assert len(mf) >= 2


def test_traffic_model_monotone(rng):
    """More fusion never increases modelled HBM traffic."""
    og = gta.build_op_graph("GCN", 64, 32)
    stats = S.GraphStats(n_node=1000, n_edge=5000, e_pad=5120)
    t_single = S.traffic_bytes(og, S.singleton_partition(og), stats)
    t_max = S.traffic_bytes(og, S.max_fusion_partition(og), stats)
    assert t_max < t_single


def test_match_spmm_on_gcn():
    og = gta.build_op_graph("GCN", 16, 8)
    plan = match_spmm(og, (0, 1, 2))
    assert plan is not None and plan.weighted and plan.in_op == ir.X_INPUT
    assert match_spmm(og, (0, 1)) is None           # MUL not included
    assert match_spmm(og, (0, 1, 2, 3)) is None     # MM inside


def test_match_gat_block():
    og = gta.build_op_graph("GAT", 16, 8, heads=2)
    parts = S.pattern_partition(og)
    assert parts is not None
    big = max(parts, key=len)
    plan = match_gat_block(og, big)
    assert plan is not None
    assert plan.heads == 2
    assert plan.out_op == 16
    assert set(big) == set(range(3, 17))  # ops 3..16: the attention chain
    assert S.partition_is_legal_with_patterns(og, [list(b) for b in parts])
    og_r = gta.build_op_graph("GAT", 16, 8, heads=2, reorder=True)
    parts_r = S.pattern_partition(og_r)
    big_r = max(parts_r, key=len)
    plan_r = match_gat_block(og_r, big_r)
    assert plan_r is not None and plan_r.out_op == 15


@pytest.mark.parametrize("network,kw", [
    ("GCN", {}),
    ("SGC", {}),
    ("GraphSAGE", {}),
    ("GIN", {}),
])
def test_fused_schedule_matches_xla(rng, network, kw):
    hg, g = _graphs(rng)
    og = gta.build_op_graph(network, 24, 16, **kw)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 24)).astype(np.float32))
    ref = lower(og)(params, g, x)

    sched = S.default_schedule(og)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    sched = S.Schedule(blocks=sched.blocks,
                       tiles=tuple(tc for _ in sched.blocks))
    fn = lower_schedule(og, sched, hg)
    out = fn(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("reorder", [False, True])
def test_fused_gat_matches_xla(rng, reorder):
    hg, g = _graphs(rng, n=50, e=250)
    og = gta.build_op_graph("GAT", 12, 8, heads=2, reorder=reorder)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 12)).astype(np.float32))
    ref = lower(og)(params, g, x)

    sched = S.default_schedule(og)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    sched = S.Schedule(blocks=sched.blocks,
                       tiles=tuple(tc for _ in sched.blocks))
    fn = lower_schedule(og, sched, hg)
    out = fn(params, g, x)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               rtol=1e-4, atol=1e-4)


def test_fused_gat_gradients(rng):
    """custom_vjp: grads through the fused path == grads through XLA path."""
    hg, g = _graphs(rng, n=40, e=200)
    og = gta.build_op_graph("GAT", 8, 8, heads=2)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 8)).astype(np.float32))

    sched = S.default_schedule(og)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    sched = S.Schedule(blocks=sched.blocks,
                       tiles=tuple(tc for _ in sched.blocks))
    fn_fused = lower_schedule(og, sched, hg)
    fn_ref = lower(og)

    def loss(f):
        return lambda p: jnp.sum(f(p, g, x) ** 2)

    g_fused = jax.grad(loss(fn_fused))(params)
    g_ref = jax.grad(loss(fn_ref))(params)
    for k in g_ref:
        np.testing.assert_allclose(np.asarray(g_fused[k]), np.asarray(g_ref[k]),
                                   rtol=2e-4, atol=2e-5)


def test_lower_schedule_captures_as_jit_arguments(rng):
    """apply.captures / apply.inner: threading the graph data through jit
    as ARGUMENTS (the large-graph / serving path — GB-scale closure
    constants would be embedded in the program) must match the direct
    call."""
    hg, g = _graphs(rng)
    og = gta.build_op_graph("GCN", 24, 16)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 24)).astype(np.float32))

    sched = S.default_schedule(og)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    sched = S.Schedule(blocks=sched.blocks,
                       tiles=tuple(tc for _ in sched.blocks))
    fn = lower_schedule(og, sched, hg)
    direct = fn(params, g, x)

    # captures ride the pytree boundary: jit(inner) with captures as an arg
    inner = jax.jit(fn.inner, static_argnames=())
    via_args = inner(params, g, x, fn.captures)
    np.testing.assert_allclose(np.asarray(via_args), np.asarray(direct),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("network", ["GraphSAGE", "GIN", "GCN"])
def test_aggregation_partition_isolates_spmm_chain(rng, network):
    """aggregation_partition: every family's neighbourhood aggregation gets
    its own SpMM-matchable block (the enumerator can't reach this shape for
    the wider graphs — 2^E blows the partition limit first), and the
    kernel-dispatched schedule matches the XLA oracle.  GraphSAGE exercises
    the gather-MEAN form (segment-sum kernel + 1/in-degree post-scale)."""
    hg, g = _graphs(rng)
    og = gta.build_op_graph(network, 24, 16)
    part = S.aggregation_partition(og)
    assert part is not None
    spmm_blocks = [b for b in part if match_spmm(og, b) is not None]
    assert len(spmm_blocks) == 1
    if network == "GraphSAGE":
        assert match_spmm(og, spmm_blocks[0]).mean

    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 24)).astype(np.float32))
    ref = lower(og)(params, g, x)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    tiles = tuple(
        tc if match_spmm(og, b) is not None else S.TileConfig(path=S.PATH_XLA)
        for b in part)
    fn = lower_schedule(og, S.Schedule(blocks=part, tiles=tiles), hg)
    np.testing.assert_allclose(np.asarray(fn(params, g, x)), np.asarray(ref),
                               rtol=2e-5, atol=2e-5)


def test_mean_spmm_kernel_gradients(rng):
    """Gradients flow through the mean-aggregation kernel path (SAGE
    training on a tuned schedule) and match the XLA lowering's grads."""
    hg, g = _graphs(rng, n=40, e=160)
    og = gta.build_op_graph("GraphSAGE", 12, 8)
    part = S.aggregation_partition(og)
    tc = S.TileConfig(block_rows=32, block_cols=32, tile_edges=128)
    tiles = tuple(
        tc if match_spmm(og, b) is not None else S.TileConfig(path=S.PATH_XLA)
        for b in part)
    fn = lower_schedule(og, S.Schedule(blocks=part, tiles=tiles), hg)
    ref = lower(og)
    params = init_params(og, jax.random.key(0))
    x = jnp.asarray(rng.normal(size=(hg.n_node, 12)).astype(np.float32))

    def loss(f):
        return lambda p, v: jnp.sum(f(p, g, v) ** 2)

    gk = jax.grad(loss(fn), argnums=(0, 1))(params, x)
    gr = jax.grad(loss(ref), argnums=(0, 1))(params, x)
    jax.tree_util.tree_map(
        lambda a, b: np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=2e-4, atol=2e-4), gk, gr)
