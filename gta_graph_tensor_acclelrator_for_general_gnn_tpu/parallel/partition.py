"""Spatial graph partitioning with a static halo-exchange plan.

The reference is strictly single-device (SURVEY §2 "Parallelism strategies:
none"); multi-device execution is new design.  The scheme here is the
standard 1-D vertex partition with halo (ghost) vertices: every shard gets
*identical static shapes*, so one shard_map-traced program serves all
devices, and the boundary feature exchange is a single ``lax.all_to_all``
over the mesh axis (NVLink inside a host, the network across hosts).

Partition invariants (D shards):
  * node space padded to D * n_local; shard d owns [d*n_local, (d+1)*n_local);
  * every edge lives on the shard that owns its *receiver* (so gather is a
    purely local segment reduction — aggregation never crosses the wire);
  * edges are SPLIT into a local set (sender owned by the same shard) and a
    remote set: all local-edge compute depends only on x_local, so XLA can
    overlap it with the in-flight halo collective (the round-1 layout mixed
    them, serialising everything behind the all_to_all);
  * HUB senders (global out-degree >= hub_threshold, at most hub_cap per
    shard) are replicated by one ``all_gather`` instead of occupying a slot
    in every destination shard's halo: a power-law hub is needed by nearly
    every shard, so per-pair halo slots for hubs inflate the uniform pair
    width H to O(hubs) — the hub bucket drops H to the tail width
    (per-pair-width bucketing; exchange volume falls from D*H_max*F to
    D*H_tail*F + D*hub_cap*F);
  * remaining per remote shard pair (p -> q) unique senders form the halo;
    pairs pad to one uniform width H so the exchange is one static
    all_to_all of shape [D, H, F];
  * remote sender ids index the combined table
    ``concat([halo (D*H rows), hubs (D*hub_cap rows), zero dump row])``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..graph import _as_host


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class PartitionedGraph:
    """Static per-shard graph arrays.  Leading axis D = mesh size; shard
    with ``P('graph')`` and each device sees its own [1, ...] block."""

    send_idx: jax.Array    # int32[D, D, H]   local rows p ships to q
    send_mask: jax.Array   # bool [D, D, H]
    hub_idx: jax.Array     # int32[D, Kh]     local rows p contributes to the
    hub_mask: jax.Array    # bool [D, Kh]     all-gathered hub table
    el_src: jax.Array      # int32[D, EL]  LOCAL edges: local sender row
    el_dst: jax.Array      # int32[D, EL]  local receiver (n_local = dump)
    el_w: jax.Array        # f32  [D, EL]
    el_mask: jax.Array     # bool [D, EL]
    er_src: jax.Array      # int32[D, ER]  REMOTE edges: combined-table row
    er_dst: jax.Array      # int32[D, ER]
    er_w: jax.Array        # f32  [D, ER]
    er_mask: jax.Array     # bool [D, ER]
    n_local: int = dataclasses.field(metadata=dict(static=True))
    halo: int = dataclasses.field(metadata=dict(static=True))
    hub_cap: int = dataclasses.field(metadata=dict(static=True))
    n_shards: int = dataclasses.field(metadata=dict(static=True))
    n_node: int = dataclasses.field(metadata=dict(static=True))
    n_edge: int = dataclasses.field(metadata=dict(static=True))
    n_local_edges: int = dataclasses.field(default=0,
                                           metadata=dict(static=True))

    @property
    def e_local(self) -> int:
        return int(self.el_src.shape[1])

    @property
    def e_remote(self) -> int:
        return int(self.er_src.shape[1])

    @property
    def n_pad(self) -> int:
        return self.n_local * self.n_shards

    def comm_report(self, feat_width: int, dtype_bytes: int = 2) -> dict:
        """Per-layer exchange volume of this plan (bytes on the wire)."""
        D, H, Kh = self.n_shards, self.halo, self.hub_cap
        return dict(
            halo_bytes=D * D * H * feat_width * dtype_bytes,
            hub_bytes=D * Kh * (D - 1) * feat_width * dtype_bytes,
            halo_width=H,
            hub_cap=Kh,
            local_edges_frac=(self.n_local_edges / self.n_edge
                              if self.n_edge else 0.0),
        )


def partition_graph(
    g,
    n_shards: int,
    *,
    edge_pad_multiple: int = 128,
    halo_pad_multiple: int = 8,
    hub_frac: float = 1 / 256,
) -> PartitionedGraph:
    """Host-side partition of a HostGraph (preferred — a device GraphTensor
    forces a device->host readback) into ``n_shards`` halo shards.

    ``hub_frac``: senders in the top ``hub_frac`` of remote out-degree are
    replicated through the all-gathered hub bucket (0 disables)."""
    g = _as_host(g)
    senders = g.senders[: g.n_edge]
    receivers = g.receivers[: g.n_edge]
    weight = g.edge_weight[: g.n_edge]
    D = n_shards
    n_local = _round_up(g.n_node, D * 8) // D

    owner_s = (senders // n_local).astype(np.int64)
    owner_r = (receivers // n_local).astype(np.int64)
    local = owner_s == owner_r

    # --- hub selection: senders needed by many remote shards --------------
    remote = ~local
    if hub_frac > 0 and remote.any():
        # number of distinct destination shards per remote sender
        pair = np.unique(senders[remote].astype(np.int64) * D
                         + owner_r[remote])
        spread = np.bincount((pair // D).astype(np.int64),
                             minlength=g.n_node)
        n_hub = max(int(g.n_node * hub_frac), 1)
        # hubs = senders with the largest shard-spread (>= 2 shards only)
        cand = np.argsort(-spread, kind="stable")[:n_hub]
        hubs = cand[spread[cand] >= 2]
    else:
        hubs = np.zeros(0, np.int64)
    is_hub = np.zeros(g.n_node, bool)
    is_hub[hubs] = True

    # --- hub bucket: rows each shard contributes to the all_gather --------
    hub_owner = (hubs // n_local).astype(np.int64)
    Kh = int(np.bincount(hub_owner, minlength=D).max()) if len(hubs) else 0
    Kh = _round_up(max(Kh, 1), halo_pad_multiple) if len(hubs) else 0
    hub_idx = np.zeros((D, max(Kh, 1)), np.int32)
    hub_mask = np.zeros((D, max(Kh, 1)), bool)
    hub_row = np.full(g.n_node, -1, np.int64)   # global sender -> table row
    if len(hubs):
        horder = np.argsort(hub_owner, kind="stable")
        hsort, hown = hubs[horder], hub_owner[horder]
        starts = np.searchsorted(hown, np.arange(D))
        slot = np.arange(len(hsort)) - starts[hown]
        hub_idx[hown, slot] = (hsort - hown * n_local).astype(np.int32)
        hub_mask[hown, slot] = True
        hub_row[hsort] = hown * Kh + slot

    # --- halo plan: unique non-hub remote senders per (p, q) pair ---------
    halo_e = remote & ~is_hub[senders]
    pair_key = owner_s[halo_e] * D + owner_r[halo_e]
    uniq = np.unique(pair_key * (n_local * D) + senders[halo_e])
    u_pair = uniq // (n_local * D)
    u_node = (uniq % (n_local * D)).astype(np.int64)
    if len(uniq):
        grp_starts = np.flatnonzero(
            np.concatenate([[True], u_pair[1:] != u_pair[:-1]]))
        grp_len = np.diff(np.concatenate([grp_starts, [len(uniq)]]))
        grp_of = np.searchsorted(grp_starts, np.arange(len(uniq)),
                                 side="right") - 1
        u_slot = np.arange(len(uniq)) - grp_starts[grp_of]
        H = int(grp_len.max())
    else:
        u_slot = np.zeros(0, np.int64)
        H = 1
    H = _round_up(H, halo_pad_multiple)

    send_idx = np.zeros((D, D, H), np.int32)
    send_mask = np.zeros((D, D, H), bool)
    u_p = (u_pair // D).astype(np.int64)
    u_q = (u_pair % D).astype(np.int64)
    send_idx[u_p, u_q, u_slot] = (u_node - u_p * n_local).astype(np.int32)
    send_mask[u_p, u_q, u_slot] = True

    # combined remote table: [halo (D*H) ‖ hubs (D*Kh) ‖ dump]
    dump_row = D * H + D * max(Kh, 1)
    halo_row = np.full((D, g.n_node), dump_row, np.int64)
    halo_row[u_q, u_node] = u_p * H + u_slot
    if len(hubs):
        hub_table = D * H + hub_row[hubs]
        halo_row[:, hubs] = hub_table[None, :]

    # --- per-shard split edge arrays --------------------------------------
    def build_edge_arrays(sel, src_rows, EL):
        so, ro, wo, oo = (senders[sel], receivers[sel], weight[sel],
                          owner_r[sel])
        eorder = np.argsort(oo, kind="stable")
        so, ro, wo, oo = so[eorder], ro[eorder], wo[eorder], oo[eorder]
        rows = src_rows[sel][eorder]        # src_rows is full-edge-length
        shard_start = np.searchsorted(oo, np.arange(D))
        slot = np.arange(len(oo)) - shard_start[oo]
        e_src = np.full((D, EL), dump_row if src_rows is not src_local_rows
                        else n_local, np.int32)
        e_dst = np.full((D, EL), n_local, np.int32)
        e_w = np.zeros((D, EL), np.float32)
        e_mask = np.zeros((D, EL), bool)
        e_src[oo, slot] = rows.astype(np.int32)
        e_dst[oo, slot] = (ro - oo * n_local).astype(np.int32)
        e_w[oo, slot] = wo
        e_mask[oo, slot] = True
        return e_src, e_dst, e_w, e_mask

    src_local_rows = (senders - owner_s * n_local).astype(np.int64)
    counts_l = np.bincount(owner_r[local], minlength=D)
    counts_r = np.bincount(owner_r[remote], minlength=D)
    EL = max(_round_up(int(counts_l.max()) if len(counts_l) else 1,
                       edge_pad_multiple), edge_pad_multiple)
    ER = max(_round_up(int(counts_r.max()) if len(counts_r) else 1,
                       edge_pad_multiple), edge_pad_multiple)

    el = build_edge_arrays(local, src_local_rows, EL)
    er = build_edge_arrays(remote, halo_row[owner_r, senders], ER)

    return PartitionedGraph(
        send_idx=jnp.asarray(send_idx),
        send_mask=jnp.asarray(send_mask),
        hub_idx=jnp.asarray(hub_idx),
        hub_mask=jnp.asarray(hub_mask),
        el_src=jnp.asarray(el[0]), el_dst=jnp.asarray(el[1]),
        el_w=jnp.asarray(el[2]), el_mask=jnp.asarray(el[3]),
        er_src=jnp.asarray(er[0]), er_dst=jnp.asarray(er[1]),
        er_w=jnp.asarray(er[2]), er_mask=jnp.asarray(er[3]),
        n_local=n_local,
        halo=H,
        hub_cap=max(Kh, 1),
        n_shards=D,
        n_node=g.n_node,
        n_edge=g.n_edge,
        n_local_edges=int(local.sum()),
    )


def community_partition_order(g, labels, n_shards: int, *,
                              balance: str = "edges"):
    """Node permutation that makes contiguous-range shards COMMUNITY shards.

    ``partition_graph`` owns nodes by contiguous range (owner = id //
    n_local) — the static-shape-friendly layout.  This computes a
    relabelling perm (perm[new_id] = old_id) such that each shard's range
    holds whole communities (``labels``, e.g. LPA/louvain/metis output),
    packed greedily largest-first onto the least-loaded shard under the
    hard n_local node capacity.  ``balance="edges"`` loads shards by
    receiver-side edge count (aggregation work and the EL/ER max-padding
    follow the receiver side); ``"nodes"`` balances node counts only.

    Within a shard, nodes order degree-descending inside each community
    with the shard's degree head first (the per-shard twin of
    graph.reorder_nodes 'hubs+labels') so LOCAL gathers stay close.

    Returns (perm, shard_of_community).  Apply with
    ``reorder_nodes(g, 'perm', perm=perm)`` or by relabelling edges with
    the inverse perm.  The round-3 plan kept only 51% of Reddit edges
    local because the single-chip 'hubs+labels' order puts ALL hubs in
    shard 0's range and splits communities at arbitrary range boundaries;
    packing whole communities (hubs staying with their community) is the
    round-4 fix (VERDICT r3 missing #2)."""
    g = _as_host(g)
    labels = np.asarray(labels)
    assert len(labels) == g.n_node, (len(labels), g.n_node)
    D = n_shards
    n_local = _round_up(g.n_node, D * 8) // D

    r = g.receivers[: g.n_edge]
    s = g.senders[: g.n_edge]
    deg_r = np.bincount(r, minlength=g.n_node)
    deg = deg_r + np.bincount(s, minlength=g.n_node)

    k = int(labels.max()) + 1
    com_nodes = np.bincount(labels, minlength=k)
    com_load = (np.bincount(labels[r], minlength=k).astype(np.float64)
                if balance == "edges" else com_nodes.astype(np.float64))

    # greedy: heaviest community -> least-loaded shard with capacity
    order = np.argsort(-com_load, kind="stable")
    shard_load = np.zeros(D, np.float64)
    shard_room = np.full(D, n_local, np.int64)
    shard_of = np.full(k, -1, np.int64)
    for c in order:
        if com_nodes[c] == 0:
            shard_of[c] = 0
            continue
        fits = shard_room >= com_nodes[c]
        if not fits.any():
            # capacity forces a split: put it on the roomiest shard; its
            # overflow nodes spill to the next roomiest in perm order
            d = int(np.argmax(shard_room))
        else:
            cand = np.where(fits, shard_load, np.inf)
            d = int(np.argmin(cand))
        shard_of[c] = d
        shard_room[d] -= com_nodes[c]       # may go negative on a split
        shard_load[d] += com_load[c]

    # node -> shard, then EXACT-FILL repair: contiguous-range ownership
    # (owner = new_id // n_local, no gaps in the dense 0..n-1 id space)
    # forces every shard except the last to hold exactly n_local nodes.
    # Shards over their target shed their LOWEST-degree nodes (fewest
    # edges, least locality damage) to the under-full shards.
    node_shard = shard_of[labels]
    target = np.full(D, n_local, np.int64)
    target[D - 1] = g.n_node - (D - 1) * n_local
    assert target[D - 1] >= 0, (g.n_node, D, n_local)
    counts = np.bincount(node_shard, minlength=D)
    pool = []
    for d in np.where(counts > target)[0]:
        excess = int(counts[d] - target[d])
        members = np.flatnonzero(node_shard == d)
        shed = members[np.argsort(deg[members], kind="stable")[:excess]]
        pool.append(shed)
        counts[d] = target[d]
    if pool:
        pool = np.concatenate(pool)
        fill_shards = np.repeat(np.arange(D), np.maximum(target - counts, 0))
        assert len(fill_shards) == len(pool), (len(fill_shards), len(pool))
        node_shard[pool] = fill_shards

    # within-shard order: degree head first, then label groups (the
    # per-shard 'hubs+labels'); shard-major overall
    kk = max(int(g.n_node * 0.02), 1)
    cut = np.sort(deg)[::-1][kk - 1]
    is_hub = deg >= max(cut, 1)
    group = np.where(is_hub, -1, labels)
    perm = np.lexsort((-deg, group, node_shard)).astype(np.int64)
    return perm, shard_of


def pad_nodes(arr: np.ndarray, part: PartitionedGraph) -> np.ndarray:
    """Pad a [n_node, ...] host array to the partitioned node space [D*n_local, ...]."""
    pad = part.n_pad - arr.shape[0]
    if pad < 0:
        raise ValueError("array longer than padded node space")
    widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, widths)
