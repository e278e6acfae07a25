"""Dispatch to the kernel path: SpMM and GAT blocks on the ``csr`` path go
to the CSR kernels, every other block (and every block on ``xla``) to XLA;
each family lowered through the kernels matches the per-op XLA lowering;
the helpers the lowering relies on."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
    schedule as S)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion import (
    classify_block, lower_schedule)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
    dense_adjacency, densefull_max_n)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import backend

NETWORKS = ("GCN", "GAT", "SGC", "GraphSAGE", "GIN", "DGN", "PNA")
# what a pattern block lowers to on each path
WANT = {S.PATH_CSR: ("spmm", "gat"), S.PATH_STREAM: ("spmm_stream",
                                                      "gat_stream"),
        S.PATH_DENSEFULL: ("spmm_densefull", "xla"), S.PATH_XLA: ("xla",
                                                                  "xla")}


def _kernel_partition(og):
    return (S.aggregation_partition(og) or S.pattern_partition(og)
            or S.singleton_partition(og))


@pytest.mark.parametrize("path", S.PATHS)
@pytest.mark.parametrize("network", NETWORKS)
def test_dispatch(network, path):
    og = gta.build_op_graph(network, 16, 8,
                            heads=2 if network == "GAT" else 1)
    part = _kernel_partition(og)
    tc = S.TileConfig(path=path)
    kinds = [classify_block(og, b, tc)[0] for b in part]
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
        import match_spmm
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops.gat import (
        match_gat_block)
    for b, kind in zip(part, kinds):
        if match_spmm(og, b) is not None:
            assert kind == WANT[path][0]
        elif match_gat_block(og, b) is not None:
            assert kind == WANT[path][1]
        else:
            assert kind == "xla"        # everything else goes to XLA
    if network in ("GCN", "SGC", "GraphSAGE", "GIN", "GAT") \
            and path == S.PATH_CSR:
        assert any(k in ("spmm", "gat") for k in kinds)


@pytest.mark.parametrize("network", NETWORKS)
def test_family_through_kernels_matches_xla(network):
    ds = gta.load_dataset("tiny")
    og = gta.build_op_graph(network, ds.x.shape[1], 8,
                            heads=2 if network == "GAT" else 1)
    part = _kernel_partition(og)
    sched = S.Schedule(part, tuple(S.TileConfig() for _ in part))
    params = gta.init_params(og, jax.random.key(0))
    x = jnp.asarray(ds.x)
    want = gta.lower(og)(params, ds.graph, x)
    got = lower_schedule(og, sched, ds.host_graph)(params, ds.graph, x)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=2e-4, atol=2e-4)


def test_interpret_only_on_cpu():
    assert jax.default_backend() == "cpu" and backend.interpret_mode()


@pytest.mark.parametrize("n,want", [(1, 1), (3, 4), (32, 32), (41, 64),
                                    (602, 1024)])
def test_pow2_at_least(n, want):
    assert backend.pow2_at_least(n) == want


def test_zero_cotangent_dtypes():
    z = backend.zero_cotangent((jnp.ones(3, jnp.int32), jnp.ones(2)))
    assert z[0].dtype == jax.dtypes.float0 and float(z[1].sum()) == 0.0


def test_dense_adjacency_sums_multi_edges():
    hg = gta.build_host_graph(np.array([0, 0, 1]), np.array([1, 1, 2]), 3,
                              edge_weight=np.array([0.5, 0.25, 2.0]))
    a = dense_adjacency(hg, pad_multiple=4).astype(np.float32)
    assert a.shape == (4, 4)
    assert a[1, 0] == 0.75 and a[2, 1] == 2.0 and a.sum() == 2.75
    cnt = dense_adjacency(hg, weighted=False, pad_multiple=4)
    assert float(cnt.astype(np.float32)[1, 0]) == 2.0


def test_densefull_cap_follows_device_memory():
    # 80 GB: an eighth of it holds a bf16 [N, N] adjacency up to ~70k nodes
    assert densefull_max_n(80 * 2**30) == int((10 * 2**30 / 2) ** 0.5)
    assert densefull_max_n(8 * 2**30) < densefull_max_n(80 * 2**30)
    assert densefull_max_n() > 0            # the CPU backend's host memory


def test_densefull_above_cap_lowers_to_xla(monkeypatch):
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph
    monkeypatch.setattr(graph, "densefull_max_n", lambda *a: 10)
    ds = gta.load_dataset("tiny")
    og = gta.build_op_graph("GCN", ds.x.shape[1], 8)
    part = S.aggregation_partition(og)
    sched = S.Schedule(part, tuple(S.TileConfig(path=S.PATH_DENSEFULL)
                                   for _ in part))
    fn = lower_schedule(og, sched, ds.host_graph)
    assert all(d is None for d in fn.captures[0])


def test_schedule_key_roundtrip():
    og = gta.build_op_graph("GAT", 16, 8, heads=2)
    part = S.pattern_partition(og)
    tiles = tuple(S.TileConfig(path=p) for p, _ in
                  zip(S.PATHS * len(part), part))
    sched = S.Schedule(part, tiles)
    assert S.Schedule.from_key(sched.key()) == sched
