"""Distributed layer tests on the virtual 8-device CPU mesh.

Correctness contract: the shard_mapped halo-partitioned forward must be
allclose to the single-device lowering for every model family, and the
distributed gradient must equal the single-device gradient (SURVEY §4
implication: multi-chip tests on CPU virtual devices)."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu import parallel
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import init_params, lower
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train import (
    TrainState, make_train_step, masked_cross_entropy)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.zoo import build_model

from conftest import small_graph


def _mesh(n=8):
    return Mesh(np.array(jax.devices()[:n]), ("graph",))


def _setup(rng, network, n=97, e=600, in_w=24, out_w=12, **kw):
    s, r = small_graph(rng, n=n, e=e)
    g = gta.build_graph(s, r, n, symmetric_norm=True, add_self_loops=True)
    og = gta.build_op_graph(network, in_w, out_w, **kw)
    params = init_params(og, jax.random.key(1))
    x = rng.normal(size=(n, in_w)).astype(np.float32)
    return g, og, params, x


@pytest.mark.parametrize("network,kw", [
    ("GCN", {}),
    ("GCN", {"reorder": True}),
    ("GAT", {"heads": 4}),
    ("GraphSAGE", {}),
    ("GIN", {}),
    ("PNA", {}),
])
def test_dist_forward_matches_single(rng, network, kw):
    mesh = _mesh()
    g, og, params, x = _setup(rng, network, **kw)
    ref = lower(og)(params, g, jnp.asarray(x))

    part = parallel.partition_graph(g, mesh.size)
    part = parallel.shard_part(part, mesh)
    xp = jax.device_put(
        jnp.asarray(parallel.pad_nodes(x, part)),
        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh))
    out = fwd(params, part, xp)
    np.testing.assert_allclose(
        np.asarray(out)[: g.n_node], np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_dist_grads_match_single(rng):
    mesh = _mesh()
    n, n_class = 80, 5
    s, r = small_graph(rng, n=n, e=500)
    g = gta.build_graph(s, r, n, symmetric_norm=True, add_self_loops=True)
    model = build_model("GCN", 16, n_class, hidden=8, n_layers=2)
    params = model.init(jax.random.key(0))
    x = rng.normal(size=(n, 16)).astype(np.float32)
    y = rng.integers(0, n_class, size=n).astype(np.int32)
    mask = np.zeros(n, bool); mask[: n // 2] = True

    # single-device grads
    apply = model.make_apply()
    def loss_single(p):
        return masked_cross_entropy(apply(p, g, jnp.asarray(x)), jnp.asarray(y),
                                    jnp.asarray(mask))
    g_ref = jax.grad(loss_single)(params)

    # distributed grads
    part = parallel.shard_part(parallel.partition_graph(g, mesh.size), mesh)
    sh = NamedSharding(mesh, P("graph"))
    xp = jax.device_put(jnp.asarray(parallel.pad_nodes(x, part)),
                        NamedSharding(mesh, P("graph", None)))
    yp = jax.device_put(jnp.asarray(parallel.pad_nodes(y, part)), sh)
    mp = jax.device_put(jnp.asarray(parallel.pad_nodes(mask, part)), sh)
    fwd = parallel.make_dist_apply(model.layers, mesh)
    def loss_dist(p):
        return masked_cross_entropy(fwd(p, part, xp), yp, mp)
    g_dist = jax.grad(loss_dist)(params)

    for k in g_ref:
        np.testing.assert_allclose(
            np.asarray(g_dist[k]), np.asarray(g_ref[k]), rtol=2e-4, atol=2e-5)


def test_sharded_train_step_loss_drops(rng):
    mesh = _mesh()
    n, n_class = 96, 4
    s, r = small_graph(rng, n=n, e=500)
    g = gta.build_graph(s, r, n, symmetric_norm=True, add_self_loops=True)
    model = build_model("GCN", 12, n_class, hidden=16, n_layers=2)
    params = model.init(jax.random.key(0))
    centers = rng.normal(size=(n_class, 12)).astype(np.float32)
    y = rng.integers(0, n_class, size=n).astype(np.int32)
    x = centers[y] + rng.normal(size=(n, 12)).astype(np.float32)
    mask = np.ones(n, bool)

    part = parallel.shard_part(parallel.partition_graph(g, mesh.size), mesh)
    sh = NamedSharding(mesh, P("graph"))
    xp = jax.device_put(jnp.asarray(parallel.pad_nodes(x, part)),
                        NamedSharding(mesh, P("graph", None)))
    yp = jax.device_put(jnp.asarray(parallel.pad_nodes(y, part)), sh)
    mp = jax.device_put(jnp.asarray(parallel.pad_nodes(mask, part)), sh)

    tx = optax.adam(1e-2)
    step = parallel.make_sharded_train_step(model.layers, mesh, tx)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    state, l0 = step(state, part, xp, yp, mp)
    for _ in range(30):
        state, loss = step(state, part, xp, yp, mp)
    assert float(loss) < float(l0)


def test_hub_replication_reduces_halo_width(rng):
    """Power-law hubs move into the all-gather bucket: per-pair halo width
    drops vs hub_frac=0, and outputs stay identical."""
    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import (
        init_params, lower)
    n = 96
    # star skew: 48 hubs SPREAD ACROSS SHARDS send to every node, plus a
    # sparse random tail (hub replication wins when hubs inflate the pair
    # width of many shards, i.e. they are not co-located)
    hubs = (np.arange(48) * 2) % n
    s1 = np.repeat(hubs, n)
    r1 = np.tile(np.arange(n), len(hubs))
    s2 = rng.integers(0, n, 100)
    r2 = rng.integers(0, n, 100)
    s = np.concatenate([s1, s2]).astype(np.int32)
    r = np.concatenate([r1, r2]).astype(np.int32)
    keep = s != r
    hg = gta.build_host_graph(s[keep], r[keep], n, symmetric_norm=True,
                              edge_pad_multiple=128)
    g = hg.to_device()
    mesh = _mesh()
    p0 = parallel.partition_graph(hg, mesh.size, hub_frac=0.0,
                                  halo_pad_multiple=1)
    p1 = parallel.partition_graph(hg, mesh.size, hub_frac=0.6,
                                  halo_pad_multiple=1)
    assert p1.halo < p0.halo, (p1.halo, p0.halo)
    F = 16
    b0 = p0.comm_report(F)
    b1 = p1.comm_report(F)
    assert (b1["halo_bytes"] + b1["hub_bytes"]
            < b0["halo_bytes"] + b0["hub_bytes"]), (b0, b1)
    rep = p1.comm_report(feat_width=16)
    assert rep["local_edges_frac"] > 0

    og = gta.build_op_graph("GCN", 8, 8)
    params = init_params(og, jax.random.key(0))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    ref = lower(og)(params, g, jnp.asarray(x))
    for part in (p0, p1):
        pd = parallel.shard_part(part, mesh)
        xp = jax.device_put(jnp.asarray(parallel.pad_nodes(x, part)),
                            NamedSharding(mesh, P("graph", None)))
        out = jax.jit(parallel.make_dist_apply([og], mesh))(params, pd, xp)
        np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                                   rtol=2e-5, atol=2e-5)


def test_dist_kernel_route_matches_xla(rng):
    """use_kernels=True (CSR local SpMM inside shard_map) == plain path,
    forward and gradients."""
    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import (
        init_params, lower)
    n = 96
    s, r = small_graph(rng, n=n, e=700)
    hg = gta.build_host_graph(s, r, n, symmetric_norm=True,
                              edge_pad_multiple=128)
    g = hg.to_device()
    mesh = _mesh()
    part = parallel.partition_graph(hg, mesh.size)
    tiles = parallel.shard_csr(part)
    og = gta.build_op_graph("GCN", 8, 8)
    params = init_params(og, jax.random.key(0))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    ref_fn = lower(og)
    ref = ref_fn(params, g, jnp.asarray(x))

    pd = parallel.shard_part(part, mesh)
    td = parallel.shard_part(tiles, mesh)
    xp = jax.device_put(jnp.asarray(parallel.pad_nodes(x, part)),
                        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh, use_kernels=True,
                                           csrs=td))
    out = fwd(params, pd, xp)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-5, atol=2e-5)

    g1 = jax.grad(lambda p: jnp.sum(fwd(p, pd, xp)[:n] ** 2))(params)
    g2 = jax.grad(lambda p: jnp.sum(ref_fn(p, g, jnp.asarray(x)) ** 2))(params)
    for k in g2:
        np.testing.assert_allclose(np.asarray(g1[k]), np.asarray(g2[k]),
                                   rtol=1e-4, atol=1e-4)


def test_shard_csr_heterogeneous_shards(rng):
    """Shards with very different edge and piece counts stack into one
    uniform per-device CSR, and the kernel route stays exact on such a
    partition."""
    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.lower import (
        init_params, lower)
    n = 96
    s = rng.integers(0, n, 900).astype(np.int32)
    r = (rng.zipf(1.5, 900) % n).astype(np.int32)   # heavy skew
    keep = s != r
    hg = gta.build_host_graph(s[keep], r[keep], n, symmetric_norm=True,
                              edge_pad_multiple=128)
    mesh = _mesh()
    part = parallel.partition_graph(hg, mesh.size)
    tiles = parallel.shard_csr(part)
    og = gta.build_op_graph("GCN", 8, 8)
    params = init_params(og, jax.random.key(0))
    x = rng.normal(size=(n, 8)).astype(np.float32)
    ref = lower(og)(params, hg.to_device(), jnp.asarray(x))
    pd = parallel.shard_part(part, mesh)
    td = parallel.shard_part(tiles, mesh)
    xp = jax.device_put(jnp.asarray(parallel.pad_nodes(x, part)),
                        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh, use_kernels=True,
                                           csrs=td))
    np.testing.assert_allclose(np.asarray(fwd(params, pd, xp))[:n],
                               np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_dist_gat_kernel_route_matches_xla(rng):
    """Multi-device attention through the CSR kernel: the GAT chain's
    local edges run the attention kernel as num/den partials under a
    mesh-global (pmax) shift; the remote partial adds exactly.  Forward AND
    grads vs the single-device XLA lowering."""
    mesh = _mesh()
    g, og, params, x = _setup(rng, "GAT", n=120, e=900, heads=4)
    ref = lower(og)(params, g, jnp.asarray(x))

    hg = gta.build_host_graph(
        np.asarray(g.senders[: g.n_edge]),
        np.asarray(g.receivers[: g.n_edge]), g.n_node,
        edge_weight=np.asarray(g.edge_weight[: g.n_edge]))
    part = parallel.partition_graph(hg, mesh.size)
    gat_tiles = parallel.shard_csr(part, unit_weight=True)
    part_d = parallel.shard_part(part, mesh)
    gat_tiles_d = parallel.shard_part(gat_tiles, mesh)
    xp = jax.device_put(
        jnp.asarray(parallel.pad_nodes(x, part)),
        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh, use_kernels=True,
                                           gat_csrs=gat_tiles_d))
    out = fwd(params, part_d, xp)
    np.testing.assert_allclose(
        np.asarray(out)[: g.n_node], np.asarray(ref), rtol=5e-5, atol=5e-5)

    # grads: distributed (replicated-param psum) vs single-device
    def loss_d(p):
        return jnp.sum(fwd(p, part_d, xp)[: g.n_node] ** 2)

    def loss_s(p):
        return jnp.sum(lower(og)(p, g, jnp.asarray(x)) ** 2)

    gd = jax.grad(loss_d)(params)
    gs = jax.grad(loss_s)(params)
    for k in gs:
        np.testing.assert_allclose(np.asarray(gd[k]), np.asarray(gs[k]),
                                   rtol=1e-3, atol=1e-3)


def test_shard_csr_padding_pieces(rng):
    """Skewed partitions: every shard's piece table is padded to the same
    length with EMPTY pieces on the dump row, so a light shard's program
    does no work for them; the kernel route stays exact."""
    # deliberately skewed: 90% of edges land on shard 0's nodes
    n, e = 160, 1200
    s = rng.integers(0, n, e).astype(np.int32)
    r = np.where(rng.random(e) < 0.9,
                 rng.integers(0, n // 8, e),
                 rng.integers(0, n, e)).astype(np.int32)
    hg = gta.build_host_graph(s, r, n, symmetric_norm=True)
    mesh = _mesh()
    part = parallel.partition_graph(hg, mesh.size)
    csrs = parallel.shard_csr(part)
    start = np.asarray(csrs.piece_start)
    end = np.asarray(csrs.piece_end)
    row = np.asarray(csrs.piece_row)
    assert csrs.split and start.shape[0] == mesh.size
    el_mask = np.asarray(part.el_mask)
    for d in range(mesh.size):
        # the real pieces cover exactly the shard's own local edges
        assert int((end[d] - start[d]).sum()) == int(el_mask[d].sum())
        pad = row[d] == part.n_local
        assert pad.any() and (start[d][pad] == end[d][pad]).all()
        assert (np.diff(row[d]) >= 0).all()

    og = gta.build_op_graph("GCN", 24, 12)
    params = init_params(og, jax.random.key(1))
    x = rng.normal(size=(n, 24)).astype(np.float32)
    g = hg.to_device()
    ref = lower(og)(params, g, jnp.asarray(x))
    part_d = parallel.shard_part(part, mesh)
    csrs_d = parallel.shard_part(csrs, mesh)
    xp = jax.device_put(
        jnp.asarray(parallel.pad_nodes(x, part)),
        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh, use_kernels=True,
                                           csrs=csrs_d))
    out = fwd(params, part_d, xp)
    np.testing.assert_allclose(
        np.asarray(out)[: g.n_node], np.asarray(ref), rtol=2e-5, atol=2e-5)


def _mesh2d(dh=2, dc=4):
    return Mesh(np.array(jax.devices()[: dh * dc]).reshape(dh, dc),
                ("host", "chip"))


@pytest.mark.parametrize("network,kw", [
    ("GCN", {}),
    ("GAT", {"heads": 4}),
])
def test_dist_2d_mesh_forward_and_grads(rng, network, kw):
    """Hierarchical (hosts x chips) plan on a (2, 4) virtual mesh: halo
    all_to_all on the inner chip axis, deduped host-axis exchange + chip
    all_gather for cross-host rows (VERDICT r2 next-4b).  Forward and
    grads vs single device."""
    mesh = _mesh2d()
    g, og, params, x = _setup(rng, network, n=130, e=900, **kw)
    ref = lower(og)(params, g, jnp.asarray(x))

    hg = gta.build_host_graph(
        np.asarray(g.senders[: g.n_edge]),
        np.asarray(g.receivers[: g.n_edge]), g.n_node,
        edge_weight=np.asarray(g.edge_weight[: g.n_edge]))
    part = parallel.partition_graph_2d(hg, 2, 4)
    axes = ("host", "chip")
    part_d = parallel.shard_part(part, mesh, axis=axes)
    xp = jax.device_put(
        jnp.asarray(parallel.pad_nodes(x, part)),
        NamedSharding(mesh, P(axes, None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh, axis=axes))
    out = fwd(params, part_d, xp)
    np.testing.assert_allclose(
        np.asarray(out)[: g.n_node], np.asarray(ref), rtol=5e-5, atol=5e-5)

    gd = jax.grad(lambda p: jnp.sum(fwd(p, part_d, xp)[: g.n_node] ** 2))(
        params)
    gs = jax.grad(lambda p: jnp.sum(
        lower(og)(p, g, jnp.asarray(x)) ** 2))(params)
    for k in gs:
        np.testing.assert_allclose(np.asarray(gd[k]), np.asarray(gs[k]),
                                   rtol=1e-3, atol=1e-3)


def test_2d_comm_report_dedups_dcn(rng):
    """The hierarchical plan's DCN volume must undercut the 1-D plan's
    cross-host share: rows needed by several chips of a host cross DCN
    once."""
    n, e = 512, 6000
    s = rng.integers(0, n, e).astype(np.int32)
    r = rng.integers(0, n, e).astype(np.int32)
    hg = gta.build_host_graph(s, r, n, symmetric_norm=True)
    p1 = parallel.partition_graph(hg, 8, hub_frac=0.0)
    p2 = parallel.partition_graph_2d(hg, 2, 4, hub_frac=0.0)
    F = 128
    r1 = p1.comm_report(F)
    r2 = p2.comm_report(F)
    # 1-D: 6/8 of halo pairs cross hosts on a (2,4) layout
    dcn_1d = r1["halo_bytes"] * (4 * 8) // (8 * 8 - 8) if False else \
        r1["halo_bytes"] * 4 // 8  # pairs into the other host's 4 shards
    assert r2["dcn_bytes"] < dcn_1d, (r2, r1)
    assert r2["local_edges_frac"] == r1["local_edges_frac"]


def test_community_partition_order(rng):
    """Round-4 community partition (VERDICT r3 missing #2): packing whole
    communities onto shards raises the local-edge fraction toward the
    generator ceiling (p_in + (1-p_in)/D), keeps shard node counts exactly
    range-aligned, stays a valid permutation, and the distributed forward
    on the relabelled graph still matches the single-device reference."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        reorder_nodes)

    n, e, D = 4000, 40000, 8
    s, r, labels = synthetic_coo(n, e, seed=5, communities=40, p_in=0.8)
    hg = gta.build_host_graph(s, r, n, add_self_loops=True,
                              symmetric_norm=True)

    perm, shard_of = parallel.community_partition_order(hg, labels, D)
    # valid permutation
    assert sorted(perm.tolist()) == list(range(n))
    hg_c, _ = reorder_nodes(hg, "perm", perm=perm)

    base = parallel.partition_graph(
        reorder_nodes(hg, "hubs+labels", labels=labels)[0], D)
    com = parallel.partition_graph(hg_c, D)
    f_base = base.comm_report(128)["local_edges_frac"]
    f_com = com.comm_report(128)["local_edges_frac"]
    ceiling = 0.8 + 0.2 / D
    assert f_com > f_base + 0.1, (f_base, f_com)
    assert f_com > ceiling - 0.12, (f_com, ceiling)

    # edge balance: widest shard within 40% of the mean
    el = np.asarray(com.el_mask).sum(1)
    er = np.asarray(com.er_mask).sum(1)
    bal = float(el.max() + er.max()) / float(el.mean() + er.mean())
    assert bal < 1.4, bal

    # distributed forward on the community-relabelled graph is exact
    mesh = _mesh()
    og = gta.build_op_graph("GCN", 24, 12)
    params = init_params(og, jax.random.key(1))
    x = rng.normal(size=(n, 24)).astype(np.float32)
    xc = x[perm]
    ref = lower(og)(params, hg_c.to_device(), jnp.asarray(xc))
    part = parallel.shard_part(com, mesh)
    xp = jax.device_put(jnp.asarray(parallel.pad_nodes(xc, part)),
                        NamedSharding(mesh, P("graph", None)))
    fwd = jax.jit(parallel.make_dist_apply([og], mesh))
    out = fwd(params, part, xp)
    np.testing.assert_allclose(np.asarray(out)[:n], np.asarray(ref),
                               rtol=2e-5, atol=2e-5)
