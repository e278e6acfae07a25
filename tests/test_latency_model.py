"""CI floor for the compile-only latency model.

Ranks every memoised measured schedule of the calibrated device
(results/memo_*.csv, written by ``cli tune`` on an H100 and keyed by
kernel version and device kind — the reference's C15 regression log)
against the fitted linear model (compiler/latency.py) and enforces:

* Spearman rank correlation >= 0.9 on the Flickr- and Reddit-dimension
  memos, whose candidates differ by more than the run-to-run noise, and
* argmin regret <= 1.20 on every memo: the schedule the model WOULD pick
  measures within 20% of the measured-best schedule.  On the Cora memos
  the candidates sit within a few per cent of each other — inside the
  noise — so only the pick quality is asserted there.

Runs entirely on CPU; measured data is the committed memo CSVs.  The
compile-only pick at Reddit dimensions must send every aggregation block
to the CSR kernels, as the measured training steps there say it should.
"""
import os

import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
    latency as L)

ROOT = os.path.join(os.path.dirname(__file__), "..")
# (memo, dataset, network, minimum rows, ranked)
CASES = [
    ("results/memo_GCN_flickr.csv", "flickr", "GCN", 5, True),
    ("results/memo_GAT_flickr.csv", "flickr", "GAT", 4, True),
    ("results/memo_GCN_cora.csv", "cora", "GCN", 5, False),
    ("results/memo_GAT_cora.csv", "cora", "GAT", 4, False),
    ("results/memo_GCN_reddit.csv", "reddit", "GCN", 4, True),
    ("results/memo_GAT_reddit.csv", "reddit", "GAT", 4, True),
]


@pytest.mark.parametrize("memo,dataset,network,min_rows,ranked", CASES,
                         ids=[f"{c[2]}-{c[1]}" for c in CASES])
def test_latency_model_rank_fidelity(memo, dataset, network, min_rows,
                                     ranked):
    hg = L.memo_graph_stats(dataset)
    graph = gta.build_op_graph(network, 128, 128, heads=4, layer_tag="tune")
    r = L.rank_check(os.path.join(ROOT, memo), graph.name, graph, hg)
    assert r is not None, (
        f"memo {memo} has no {L.CALIBRATED_DEVICE} rows of the current "
        "KERNEL_VERSION for {graph.name} — re-run cli tune on the card")
    assert len(r["rows"]) >= min_rows, (
        f"memo shrank: {len(r['rows'])} < {min_rows}")
    if ranked:
        assert r["spearman"] >= 0.9, (
            f"{memo}: rank correlation {r['spearman']:.3f} < 0.9 — "
            "constants drifted; refit via scripts/latency_fit.py")
    assert r["argmin_regret"] <= 1.20, (
        f"{memo}: modelled pick measures {r['argmin_regret']:.2f}x the "
        "measured best")


@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_reddit_pick_sends_aggregation_to_csr(network):
    """Full-batch Reddit dimensions (602 -> 128 -> 41, H=4): the pick runs
    every SpMM / GAT block on the CSR kernels and never names a path that
    would silently run XLA instead (densefull above its node cap)."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
        import classify_block
    stats = L.LARGE_MEMO_GRAPHS["reddit"]
    model = gta.build_model(network, 602, 41, hidden=128, n_layers=2,
                            heads=4, reorder=network == "GCN")
    probe = S.TileConfig(path=S.PATH_CSR)
    scheds, t_ns = L.pick_model_schedules(model.layers, stats, 602)
    assert 0 < t_ns < float("inf")
    for g, sched in zip(model.layers, scheds):
        agg = [tc for b, tc in zip(sched.blocks, sched.tiles)
               if classify_block(g, b, probe)[0] != "xla"]
        assert agg and all(tc.path == S.PATH_CSR for tc in agg), sched.key()


@pytest.mark.parametrize("network", ["GCN", "GAT"])
def test_training_pick_leaves_out_the_stream_path(network):
    """The model prices forwards; the stream path's scan backward is far
    dearer, so the training pick (cli train --compiled) never streams."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    stats = L.memo_graph_stats("cora")
    model = gta.build_model(network, 1433, 7, hidden=128, n_layers=2,
                            heads=4)
    scheds, _ = L.pick_model_schedules(model.layers, stats, 1433,
                                       training=True)
    assert all(tc.path != S.PATH_STREAM for s in scheds for tc in s.tiles)


def test_pick_skips_densefull_above_cap(monkeypatch):
    """A densefull candidate above graph.densefull_max_n would lower to
    XLA under the dense name: neither the pick nor the tuner considers it."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu import graph as G
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.tune.search import (
        runnable)
    g = gta.build_op_graph("GCN", 16, 16, layer_tag="cap")
    stats = S.GraphStats(n_node=64, n_edge=256, e_pad=512)
    # free FLOPs and bytes: the dense matmul is the cheapest candidate
    dense = L.LatencyConstants(**{
        f: (0.0 if f in ("mm_flop", "xla_byte") else 1.0)
        for f in L.FEATURES})
    part = S.aggregation_partition(g)
    sched = S.Schedule(part, tuple(S.TileConfig(path=S.PATH_DENSEFULL)
                                   for _ in part))
    monkeypatch.setattr(G, "densefull_max_n", lambda *a: 1 << 20)
    assert runnable(sched, 16, stats.n_node)
    pick, _ = L.min_latency_schedule(g, stats, feat_width=16,
                                     constants=dense)
    assert any(tc.path == S.PATH_DENSEFULL for tc in pick.tiles)
    monkeypatch.setattr(G, "densefull_max_n", lambda *a: 32)
    assert not runnable(sched, 16, stats.n_node)
    pick, _ = L.min_latency_schedule(g, stats, feat_width=16,
                                     constants=dense)
    assert all(tc.path != S.PATH_DENSEFULL for tc in pick.tiles)


def test_spearman_helper():
    assert L.spearman_rank([1, 2, 3], [10, 20, 30]) == pytest.approx(1.0)
    assert L.spearman_rank([1, 2, 3], [30, 20, 10]) == pytest.approx(-1.0)
