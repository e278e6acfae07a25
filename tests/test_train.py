"""Training-loop convergence tests (the reference has no training; the
framework's correctness anchor is that every family trains — SURVEY §7)."""
import numpy as np
import pytest

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import load_dataset
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train import train_node_classifier


@pytest.mark.parametrize("network", ["GCN", "GAT", "GraphSAGE", "GIN", "SGC", "DGN", "PNA"])
def test_train_converges_tiny(network):
    ds = load_dataset("tiny")
    _, res = train_node_classifier(
        ds, network, hidden=32, n_layers=2, heads=4, epochs=40, lr=1e-2)
    # planted-community features: must beat chance (0.25) solidly on train
    assert res.train_acc > 0.6, res
    assert np.isfinite(res.train_loss)


def test_train_bf16_compute():
    ds = load_dataset("tiny")
    import jax.numpy as jnp
    _, res = train_node_classifier(
        ds, "GCN", hidden=32, epochs=30, compute_dtype=jnp.bfloat16)
    assert res.train_acc > 0.6, res


def test_train_with_fused_schedule():
    """Training through the fused-block schedule path (stream lowering)."""
    import jax
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.zoo import (
        build_model)
    ds = load_dataset("tiny")
    model = build_model("GCN", ds.x.shape[1], ds.n_class, hidden=16,
                        n_layers=2)
    # per-layer schedules with the SpMM block dispatched to the stream path
    scheds = []
    for layer in model.layers:
        part = S.max_fusion_partition(layer)
        tiles = tuple(
            S.TileConfig(path=S.PATH_STREAM, tile_edges=1) if len(b) >= 2
            else S.TileConfig(path=S.PATH_XLA) for b in part)
        scheds.append(S.Schedule(blocks=part, tiles=tiles))
    _, res = train_node_classifier(ds, "GCN", hidden=16, epochs=30,
                                   model=model, schedules=scheds)
    assert res.train_acc > 0.6, res


@pytest.mark.parametrize("network", ["GCN", "GAT"])
@pytest.mark.parametrize("transpose", [True, False],
                         ids=["kernel_bwd", "xla_bwd"])
def test_train_with_csr_kernels(network, transpose):
    """Training through the CSR kernels (interpret mode); with the
    transposed CSR the gradients run the kernels backwards instead of the
    XLA [E, F] recompute — the full-batch-Reddit training recipe at tiny
    scale."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
        import classify_block
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.zoo import (
        build_model)
    ds = load_dataset("tiny")
    model = build_model(network, ds.x.shape[1], ds.n_class, hidden=16,
                        n_layers=2, heads=2)
    want = "spmm" if network == "GCN" else "gat"
    scheds = []
    for layer in model.layers:
        part = (S.aggregation_partition(layer) if network == "GCN"
                else S.pattern_partition(layer))
        tc = S.TileConfig(path=S.PATH_CSR)
        tiles = tuple(
            tc if classify_block(layer, b, tc)[0] == want
            else S.TileConfig(path=S.PATH_XLA) for b in part)
        scheds.append(S.Schedule(blocks=part, tiles=tiles))
    assert any(t.path == S.PATH_CSR for s in scheds for t in s.tiles)
    _, res = train_node_classifier(ds, network, hidden=16, heads=2,
                                   epochs=30, model=model, schedules=scheds,
                                   build_transpose=transpose)
    assert res.train_acc > 0.6, res


def test_checkpoint_roundtrip_with_compiled_schedules(tmp_path):
    """Train through compiled schedules, checkpoint, restore, and keep
    training — the serving/training state survives the kernel paths."""
    import jax
    import numpy as np
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.checkpoint \
        import restore_state, save_state
    ds = load_dataset("tiny")
    state, res = train_node_classifier(ds, "GCN", hidden=16, epochs=10)
    step = save_state(str(tmp_path), state)
    state2 = restore_state(str(tmp_path), state)
    assert int(state2.step) == int(state.step) == step
    for a, b in zip(jax.tree.leaves(state.params),
                    jax.tree.leaves(state2.params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
