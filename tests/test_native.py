"""Native (C++) preprocessing must match the numpy paths exactly."""
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import native

from conftest import small_graph

pytestmark = pytest.mark.skipif(not native.HAVE_NATIVE,
                                reason="native lib unavailable")


def test_sort_by_receiver_matches_numpy(rng):
    r = rng.integers(0, 500, size=4000).astype(np.int32)
    order_n = native.sort_by_receiver_native(r, 500)
    order_np = np.argsort(r, kind="stable")
    np.testing.assert_array_equal(order_n, order_np)


def test_degrees_match_numpy(rng):
    s = rng.integers(0, 300, size=2000).astype(np.int32)
    r = rng.integers(0, 300, size=2000).astype(np.int32)
    out_deg, in_deg = native.degrees_native(s, r, 300)
    ref_in = np.bincount(r, minlength=300).astype(np.float64)
    ref_out = np.bincount(s, minlength=300).astype(np.float64)
    np.testing.assert_array_equal(in_deg, ref_in)
    np.testing.assert_array_equal(out_deg, ref_out)


def test_native_sort_identical_to_numpy(rng, monkeypatch):
    """build_host_graph's receiver sort: the native counting sort and the
    numpy stable argsort give the same graph."""
    s, r = small_graph(rng, n=300, e=2500, multi_edges=True)
    hg_native = gta.build_host_graph(s, r, 300, add_self_loops=True,
                                     symmetric_norm=True)
    monkeypatch.setattr(native, "HAVE_NATIVE", False)
    hg_numpy = gta.build_host_graph(s, r, 300, add_self_loops=True,
                                    symmetric_norm=True)
    for field in ("senders", "receivers", "edge_mask", "edge_weight"):
        np.testing.assert_array_equal(getattr(hg_native, field),
                                      getattr(hg_numpy, field),
                                      err_msg=field)


def test_native_epoch_sampler_structure(rng):
    """The parallel C++ sampler must produce batches with every invariant
    the numpy NeighborSampler + build_host_graph pipeline guarantees."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.sampling import (
        NeighborSampler)

    s, r = small_graph(rng, n=400, e=6000, multi_edges=True)
    hg = gta.build_host_graph(s, r, 400)
    sam = NeighborSampler(hg, [4, 3], batch_size=32, seed=1)
    seeds = rng.permutation(rng.choice(400, 128, replace=False)).astype(
        np.int32)
    e_pad = sam.cap_edges + sam.cap_nodes
    out = native.sample_epoch_native(
        sam.row_ptr, sam.senders, seeds, [4, 3], 32, sam.cap_nodes,
        e_pad, 7)
    S = 4
    assert out["senders"].shape == (S, e_pad)
    edge_set = set(zip(hg.senders[: hg.n_edge].tolist(),
                       hg.receivers[: hg.n_edge].tolist()))
    for b in range(S):
        ids = out["ids"][b]
        src, dst = out["senders"][b], out["receivers"][b]
        m, w = out["mask"][b], out["weight"][b]
        # seeds occupy the leading local slots
        np.testing.assert_array_equal(ids[:32], seeds[b * 32:(b + 1) * 32])
        assert out["seed"][b][:32].all() and not out["seed"][b][32:].any()
        # real edges are a contiguous prefix; padding points at the dump row
        k = int(m.sum())
        assert m[:k].all() and not m[k:].any()
        np.testing.assert_array_equal(w, m.astype(np.float32))
        assert (src[k:] == sam.cap_nodes).all()
        assert (dst[k:] == sam.cap_nodes).all()
        # receiver-sorted (the GraphTensor invariant)
        assert (np.diff(dst[:k]) >= 0).all()
        # one self-loop per local slot (build_host_graph parity)
        loops = src[:k] == dst[:k]
        assert loops.sum() >= sam.cap_nodes
        # every sampled non-loop edge exists in the host graph
        nz = ~loops
        gs_, gd_ = ids[src[:k][nz]], ids[dst[:k][nz]]
        assert (gs_ >= 0).all() and (gd_ >= 0).all()
        for a, c in zip(gs_.tolist(), gd_.tolist()):
            assert (a, c) in edge_set


def test_native_epoch_sampler_deterministic(rng):
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.sampling import (
        NeighborSampler)

    s, r = small_graph(rng, n=200, e=3000)
    hg = gta.build_host_graph(s, r, 200)
    sam = NeighborSampler(hg, [3, 2], batch_size=16, seed=0)
    seeds = rng.choice(200, 64, replace=False).astype(np.int32)
    e_pad = sam.cap_edges + sam.cap_nodes
    a = native.sample_epoch_native(sam.row_ptr, sam.senders, seeds, [3, 2],
                                   16, sam.cap_nodes, e_pad, 5)
    b = native.sample_epoch_native(sam.row_ptr, sam.senders, seeds, [3, 2],
                                   16, sam.cap_nodes, e_pad, 5)
    for key in a:
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _planted(n, e, k, seed):
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets import (
        synthetic_coo)

    s, r, com = synthetic_coo(n, e, seed=seed, communities=k, p_in=0.7)
    return gta.build_host_graph(s, r, n), com


def _partition_match(found, truth, k):
    """Every found label maps to exactly one planted community and the
    mapping is a bijection (perfect recovery up to relabelling)."""
    if found.max() + 1 != k:
        return False
    for l in range(k):
        if np.count_nonzero(np.bincount(truth[found == l], minlength=k)) != 1:
            return False
    return True


def test_label_prop_recovers_planted_communities():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        cluster_labels)

    hg, com = _planted(2048, 80_000, 8, seed=11)
    lab = cluster_labels(hg)
    assert _partition_match(lab, com, 8)


def test_label_prop_numpy_fallback_recovers():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        _label_prop_numpy)

    hg, com = _planted(1024, 30_000, 8, seed=5)
    s = hg.senders[: hg.n_edge].astype(np.int64)
    r = hg.receivers[: hg.n_edge].astype(np.int64)
    keep = s != r
    u = np.concatenate([s[keep], r[keep]])
    v = np.concatenate([r[keep], s[keep]])
    order = np.argsort(u, kind="stable")
    rp = np.concatenate([[0], np.cumsum(np.bincount(u, minlength=1024))])
    lab = _label_prop_numpy(rp.astype(np.int64), v[order].astype(np.int32),
                            1024, 20)
    _, lab = np.unique(lab, return_inverse=True)
    assert _partition_match(lab, com, 8)


def test_cluster_reorder_matches_ground_truth_density():
    """The label-free 'cluster' reorder must earn (almost) the block
    density that ground-truth labels earn — the real-graph story: the
    share of edges in 256x256 adjacency blocks holding >= 3277 edges."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        reorder_nodes)

    hg, com = _planted(4096, 300_000, 4, seed=7)

    def dense_frac(method, **kw):
        g2, perm = reorder_nodes(hg, method, **kw)
        assert sorted(perm.tolist()) == list(range(hg.n_node))
        ne = g2.n_edge
        key = (g2.receivers[:ne] // 256).astype(np.int64) * 64 \
            + g2.senders[:ne] // 256
        cnt = np.bincount(key)
        return cnt[cnt >= 3277].sum() / max(ne, 1)

    truth = dense_frac("hubs+labels", labels=com)
    found = dense_frac("cluster")
    assert truth > 0.3, truth          # planted structure is discoverable
    assert found >= 0.9 * truth, (found, truth)
