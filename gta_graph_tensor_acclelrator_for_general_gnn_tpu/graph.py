"""Static-shape graph containers.

The reference framework (GTA) represents a graph as a dense adjacency matrix
split into T x node_num tiles with per-tile nnz histograms
(``FinalVersion For Paper/preprocessing.py:11-39`` in the reference).  That
representation exists to feed a cycle-accurate simulator.  Real execution
has different needs: XLA traces once, so *every* shape must be static, and
the aggregation kernels walk each destination row's in-edges.

This module provides:

* :class:`GraphTensor` — a pytree of statically padded COO arrays, edges
  sorted by destination (receiver).  This is the universal input to the
  XLA reference path.
* :class:`CsrGraph` — the same edges as compressed rows cut into bounded
  pieces, the input of the CSR kernels (ops/spmm.py, ops/gat.py).

All padding uses index ``n_node`` (one past the last real node) for node ids
and mask arrays for edges so that segment reductions on padded entries land in
a dump row that is sliced away.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class HostGraph:
    """Host-side (numpy) twin of :class:`GraphTensor`.

    All preprocessing (piece tables, partitioning, histograms) runs off this
    so it never reads device buffers back.  Build once on host,
    `.to_device()` exactly once.
    """

    senders: np.ndarray
    receivers: np.ndarray
    edge_mask: np.ndarray
    edge_weight: np.ndarray
    n_node: int
    n_edge: int

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])

    def to_device(self) -> "GraphTensor":
        return GraphTensor(
            senders=jnp.asarray(self.senders),
            receivers=jnp.asarray(self.receivers),
            edge_mask=jnp.asarray(self.edge_mask),
            edge_weight=jnp.asarray(self.edge_weight),
            n_node=self.n_node,
            n_edge=self.n_edge,
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GraphTensor:
    """A statically padded graph.

    Attributes:
      senders:    int32[E_pad]  source node of each edge (padded with n_node).
      receivers:  int32[E_pad]  destination node, **sorted ascending**.
      edge_mask:  bool[E_pad]   True for real edges.
      edge_weight: float32[E_pad] optional per-edge scalar (e.g. the symmetric
        GCN normalisation 1/sqrt(d_u d_v)); 0 on padding.
      n_node / n_edge: static python ints (real counts, pre-padding).
    """

    senders: jax.Array
    receivers: jax.Array
    edge_mask: jax.Array
    edge_weight: jax.Array
    n_node: int = dataclasses.field(metadata=dict(static=True))
    n_edge: int = dataclasses.field(metadata=dict(static=True))

    @property
    def e_pad(self) -> int:
        return int(self.senders.shape[0])

    @property
    def n_pad(self) -> int:
        # one dump row past the real nodes, rounded up to a multiple of 8
        return _round_up(self.n_node + 1, 8)


def build_host_graph(
    senders: np.ndarray,
    receivers: np.ndarray,
    n_node: int,
    edge_weight: Optional[np.ndarray] = None,
    *,
    add_self_loops: bool = False,
    symmetric_norm: bool = False,
    edge_pad_multiple: int = 512,
) -> HostGraph:
    """Build a sorted, padded :class:`HostGraph` from COO arrays (host side)."""
    senders = np.asarray(senders, np.int32)
    receivers = np.asarray(receivers, np.int32)
    if add_self_loops:
        loop = np.arange(n_node, dtype=np.int32)
        senders = np.concatenate([senders, loop])
        receivers = np.concatenate([receivers, loop])
        edge_weight = None if edge_weight is None else np.concatenate(
            [np.asarray(edge_weight, np.float32), np.ones(n_node, np.float32)]
        )
    n_edge = int(senders.shape[0])

    from . import native
    order = (native.sort_by_receiver_native(receivers, n_node)
             if native.HAVE_NATIVE else None)
    if order is None:
        order = np.argsort(receivers, kind="stable")
    senders, receivers = senders[order], receivers[order]
    if edge_weight is not None:
        edge_weight = np.asarray(edge_weight, np.float32)[order]

    if symmetric_norm:
        degs = (native.degrees_native(senders, receivers, n_node)
                if native.HAVE_NATIVE else None)
        if degs is not None:
            out_deg, deg = degs
        else:
            deg = np.zeros(n_node, np.float64)
            np.add.at(deg, receivers, 1.0)
            out_deg = np.zeros(n_node, np.float64)
            np.add.at(out_deg, senders, 1.0)
        inv = 1.0 / np.sqrt(np.maximum(deg[receivers] * out_deg[senders], 1.0))
        edge_weight = inv.astype(np.float32)
    if edge_weight is None:
        edge_weight = np.ones(n_edge, np.float32)

    e_pad = max(_round_up(n_edge, edge_pad_multiple), edge_pad_multiple)
    pad = e_pad - n_edge
    senders = np.concatenate([senders, np.full(pad, n_node, np.int32)])
    receivers = np.concatenate([receivers, np.full(pad, n_node, np.int32)])
    mask = np.concatenate([np.ones(n_edge, bool), np.zeros(pad, bool)])
    edge_weight = np.concatenate([edge_weight, np.zeros(pad, np.float32)])

    return HostGraph(
        senders=senders,
        receivers=receivers,
        edge_mask=mask,
        edge_weight=edge_weight,
        n_node=n_node,
        n_edge=n_edge,
    )


def build_graph(*args, **kwargs) -> GraphTensor:
    """Device variant of :func:`build_host_graph` (same signature)."""
    return build_host_graph(*args, **kwargs).to_device()


def _as_host(g) -> HostGraph:
    """HostGraph view of either graph type.  Readbacks from a device
    GraphTensor are allowed only as a CPU-platform convenience (tests)."""
    if isinstance(g, HostGraph):
        return g
    return HostGraph(
        senders=np.asarray(g.senders),
        receivers=np.asarray(g.receivers),
        edge_mask=np.asarray(g.edge_mask),
        edge_weight=np.asarray(g.edge_weight),
        n_node=g.n_node,
        n_edge=g.n_edge,
    )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class CsrGraph:
    """Receiver-sorted compressed rows for the CSR kernels (ops/spmm.py,
    ops/gat.py).

    The edge arrays are the :class:`GraphTensor` ones (sorted by receiver,
    padded with ``n_node``).  Each destination row's in-edges are cut into
    *pieces* of at most ``max_piece`` consecutive edges; one kernel program
    owns one piece, so a hub row of a power-law graph spreads over many
    programs instead of serialising one.  A row without in-edges still gets
    one (empty) piece, so the kernel writes every output row.

    Attributes (P = number of pieces):
      senders / receivers: int32[E_pad]  the edge arrays.
      weight:      float32[E_pad]  per-edge scalar (0 on padding).
      piece_start: int32[P]  first edge of each piece.
      piece_end:   int32[P]  one past its last edge.
      piece_row:   int32[P]  its destination row, non-decreasing;
                   ``n_node`` on pieces that only pad P to a fixed count.
      split: static; False when the pieces are exactly the rows (P ==
        n_node, piece_row == arange), so the kernels' per-piece rows are
        the output.  True when some row was cut or P was padded: the
        per-piece partials are then combined by one sorted segment sum.
    """

    senders: jax.Array
    receivers: jax.Array
    weight: jax.Array
    piece_start: jax.Array
    piece_end: jax.Array
    piece_row: jax.Array
    n_node: int = dataclasses.field(metadata=dict(static=True))
    split: bool = dataclasses.field(metadata=dict(static=True))

    @property
    def n_pieces(self) -> int:
        return int(self.piece_start.shape[0])


# Longest piece one kernel program walks.  Pieces bound the work of the
# slowest program (the GPU schedules programs in any order, so the run ends
# with its longest ones); shorter pieces split more rows and add partials
# to combine.
MAX_PIECE = 1024


def csr_pieces(g, max_piece: int = MAX_PIECE,
               n_pieces: Optional[int] = None):
    """Host-side piece table ``(start, end, row)`` of a receiver-sorted
    graph (see :class:`CsrGraph`).  ``n_pieces`` pads the table with empty
    pieces on the dump row ``n_node`` (one shape for every shard)."""
    g = _as_host(g)
    n, ne = g.n_node, g.n_edge
    row_ptr = np.searchsorted(g.receivers[:ne], np.arange(n + 1),
                              side="left").astype(np.int64)
    deg = np.diff(row_ptr)
    cnt = np.maximum(-(-deg // max_piece), 1)
    row = np.repeat(np.arange(n, dtype=np.int64), cnt)
    first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
    k = np.arange(len(row), dtype=np.int64) - np.repeat(first, cnt)
    start = row_ptr[row] + k * max_piece
    end = np.minimum(start + max_piece, row_ptr[row + 1])
    if n_pieces is not None:
        if n_pieces < len(row):
            raise ValueError(f"n_pieces={n_pieces} < {len(row)} pieces")
        pad = n_pieces - len(row)
        start = np.concatenate([start, np.zeros(pad, np.int64)])
        end = np.concatenate([end, np.zeros(pad, np.int64)])
        row = np.concatenate([row, np.full(pad, n, np.int64)])
    return (start.astype(np.int32), end.astype(np.int32),
            row.astype(np.int32))


def csr_graph(g, *, unit_weight: bool = False, max_piece: int = MAX_PIECE,
              n_pieces: Optional[int] = None) -> CsrGraph:
    """Build the :class:`CsrGraph` of a receiver-sorted graph (host side).

    ``unit_weight``: weights forced to 1 on real edges (attention and plain
    sum aggregation).  ``n_pieces``: pad the piece table to this length."""
    g = _as_host(g)
    start, end, row = csr_pieces(g, max_piece, n_pieces)
    w = (g.edge_mask.astype(np.float32) if unit_weight
         else g.edge_weight.astype(np.float32))
    split = not (len(row) == g.n_node
                 and np.array_equal(row, np.arange(g.n_node)))
    return CsrGraph(
        senders=jnp.asarray(g.senders), receivers=jnp.asarray(g.receivers),
        weight=jnp.asarray(w), piece_start=jnp.asarray(start),
        piece_end=jnp.asarray(end), piece_row=jnp.asarray(row),
        n_node=g.n_node, split=bool(split))


# share of the device's memory the full dense adjacency may take
DENSEFULL_MEMORY_SHARE = 0.125


def densefull_max_n(bytes_limit: Optional[int] = None) -> int:
    """Largest node count whose [N, N] bf16 adjacency fits in
    ``DENSEFULL_MEMORY_SHARE`` of the device's memory (``bytes_limit`` of
    ``jax.devices()[0].memory_stats()``, or the argument).  Above it the
    densefull path lowers to XLA instead."""
    if bytes_limit is None:
        dev = jax.devices()[0]
        stats = dev.memory_stats() or {}
        bytes_limit = int(stats.get("bytes_limit", 0))
        if not bytes_limit and dev.platform == "cpu":
            # the CPU backend reports no limit: its memory is the host's
            import os
            bytes_limit = (os.sysconf("SC_PAGE_SIZE")
                           * os.sysconf("SC_PHYS_PAGES"))
        if not bytes_limit:
            raise RuntimeError(
                "the device reports no bytes_limit; pass one explicitly")
    return int((DENSEFULL_MEMORY_SHARE * bytes_limit / 2) ** 0.5)


def batch_host_graph(g, batch: int, *, copy_stride: Optional[int] = None
                     ) -> "HostGraph":
    """Block-diagonal batching of ``batch`` copies of one graph (the
    serving shape), with each copy's node range padded to ``copy_stride``
    (default: next multiple of 1024).

    With an aligned stride every copy occupies the same node range
    pattern, so per-copy results slice out at fixed offsets.  Features are
    laid out [batch * copy_stride, F] with per-copy zero padding
    (:func:`pad_batch_features`)."""
    g = _as_host(g)
    stride = copy_stride or _round_up(g.n_node, 1024)
    ne = g.n_edge
    off = (np.arange(batch, dtype=np.int64)[:, None] * stride)
    s = (g.senders[:ne][None, :] + off).reshape(-1)
    r = (g.receivers[:ne][None, :] + off).reshape(-1)
    w = np.tile(g.edge_weight[:ne], batch)
    n_tot = batch * stride
    e_tot = batch * ne
    e_pad = _round_up(e_tot, 512)
    return HostGraph(
        senders=np.concatenate(
            [s, np.full(e_pad - e_tot, n_tot, np.int64)]).astype(np.int32),
        receivers=np.concatenate(
            [r, np.full(e_pad - e_tot, n_tot, np.int64)]).astype(np.int32),
        edge_mask=np.concatenate(
            [np.ones(e_tot, bool), np.zeros(e_pad - e_tot, bool)]),
        edge_weight=np.concatenate(
            [w, np.zeros(e_pad - e_tot, np.float32)]).astype(np.float32),
        n_node=n_tot,
        n_edge=e_tot,
    )


def pad_batch_features(x: np.ndarray, batch: int, n_node: int,
                       copy_stride: Optional[int] = None) -> np.ndarray:
    """[batch, n_node, F] (or [batch*n_node, F]) -> the padded
    [batch * stride, F] layout :func:`batch_host_graph` expects."""
    stride = copy_stride or _round_up(n_node, 1024)
    x = np.asarray(x).reshape(batch, n_node, -1)
    out = np.zeros((batch, stride, x.shape[-1]), x.dtype)
    out[:, :n_node] = x
    return out.reshape(batch * stride, -1)


def dense_adjacency(g, *, weighted: bool = True, pad_multiple: int = 256,
                    dtype=None) -> np.ndarray:
    """The FULL dense adjacency [N_pad, N_pad] (rows = receivers, cols =
    senders; summed edge weights, or multi-edge counts when unweighted) —
    the medium-density regime's aggregation operand: one ``A @ x`` matmul
    on the tensor cores.  bf16 by default (ml_dtypes); the sym-norm weights
    ride inside A.  Multi-edges are summed in float32 per distinct pair, so
    the host never holds a float32 [N_pad, N_pad] buffer."""
    import ml_dtypes
    g = _as_host(g)
    if dtype is None:
        dtype = ml_dtypes.bfloat16
    n_pad = _round_up(g.n_node, pad_multiple)
    ne = g.n_edge
    w = (g.edge_weight[:ne] if weighted else np.ones(ne, np.float32))
    key = (g.receivers[:ne].astype(np.int64) * n_pad
           + g.senders[:ne].astype(np.int64))
    uniq, inv = np.unique(key, return_inverse=True)
    vals = np.zeros(len(uniq), np.float32)
    np.add.at(vals, inv, w)
    a = np.zeros((n_pad, n_pad), dtype)
    a.reshape(-1)[uniq] = vals.astype(dtype)
    return a


def _label_prop_numpy(row_ptr: np.ndarray, nbrs: np.ndarray, n: int,
                      max_iter: int) -> np.ndarray:
    """Vectorised label propagation, numpy fallback for cluster_labels.

    Per sweep the winning neighbour label is computed for every node at
    once, but applied in two parity half-steps (even ids, then odd) — the
    two-colour schedule breaks the synchronous-update oscillations that
    plain parallel LPA is prone to (label-swapping node pairs)."""
    labels = np.arange(n, dtype=np.int64)
    owner = np.repeat(np.arange(n, dtype=np.int64), np.diff(row_ptr))

    def winners(lab):
        key = owner * n + lab[nbrs]
        uniq, cnt = np.unique(key, return_counts=True)
        own_u, lab_u = uniq // n, uniq % n
        # max count per owner, ties toward the smaller label id
        sel = np.lexsort((lab_u, -cnt, own_u))
        own_s = own_u[sel]
        first = np.concatenate([[True], own_s[1:] != own_s[:-1]])
        win = lab.copy()
        win[own_s[first]] = lab_u[sel][first]
        return win

    for _ in range(max_iter):
        changed = 0
        for parity in (0, 1):
            win = winners(labels)
            mask = (np.arange(n) % 2) == parity
            upd = mask & (win != labels)
            labels = np.where(upd, win, labels)
            changed += int(upd.sum())
        if changed * 1000 < n:
            break
    return labels


def transpose_host_graph(g) -> Tuple[HostGraph, np.ndarray]:
    """The transposed graph Aᵀ (senders <-> receivers, weights preserved)
    plus ``perm``: for edge i of the TRANSPOSED graph, ``perm[i]`` is its
    index in the original edge order (identity on weights; lets runtime
    per-edge values ride into the transposed CSR via one [E] take).

    This is the backbone of the kernel backward: the VJP of y = A x is
    dx = Aᵀ ȳ — the SAME CSR kernel over the transposed graph, instead of
    the [E, F]-materialising XLA recompute."""
    from . import native
    g = _as_host(g)
    ne = g.n_edge
    order = (native.sort_by_receiver_native(g.senders[:ne], g.n_node)
             if native.HAVE_NATIVE else None)
    if order is None:
        order = np.argsort(g.senders[:ne], kind="stable")
    gt = HostGraph(
        senders=np.concatenate(
            [g.receivers[:ne][order],
             np.full(g.e_pad - ne, g.n_node, np.int32)]),
        receivers=np.concatenate(
            [g.senders[:ne][order],
             np.full(g.e_pad - ne, g.n_node, np.int32)]),
        edge_mask=np.concatenate(
            [np.ones(ne, bool), np.zeros(g.e_pad - ne, bool)]),
        edge_weight=np.concatenate(
            [g.edge_weight[:ne][order],
             np.zeros(g.e_pad - ne, np.float32)]),
        n_node=g.n_node,
        n_edge=ne,
    )
    perm = np.concatenate(
        [order.astype(np.int64),
         np.full(g.e_pad - ne, max(g.e_pad - 1, 0), np.int64)])
    return gt, perm


def cluster_labels(g: HostGraph, max_iter: int = 20, seed: int = 0):
    """Community assignment by label propagation — NO ground-truth labels.

    This is the clustering pass a production pipeline runs on a real graph
    before locality-sensitive execution (partitioning, cache-friendly node
    order), and real data does not come with the planted labels the
    synthetic generator returns.  The reference likewise
    assumes a pre-clustered node order for its per-tile nnz statistics
    (``FinalVersion For Paper/preprocessing.py``, maxlist sizing
    ``vTCAD/code/compiler.py:504``).

    Native async-LPA (``native/cluster.cpp``, deterministic seeded sweeps)
    with a vectorised numpy fallback.  Returns compact int32 community ids
    in [0, k)."""
    from . import native

    s = g.senders[: g.n_edge].astype(np.int64)
    r = g.receivers[: g.n_edge].astype(np.int64)
    n = g.n_node
    keep = s != r  # self loops carry no community information
    u = np.concatenate([s[keep], r[keep]]).astype(np.int32)
    v = np.concatenate([r[keep], s[keep]]).astype(np.int32)
    lab = None
    if native.HAVE_NATIVE:
        order = native.sort_by_receiver_native(u, n)  # O(E) counting sort
    else:
        order = np.argsort(u, kind="stable")
    nbrs = v[order]
    deg = np.bincount(u, minlength=n)
    row_ptr = np.concatenate([[0], np.cumsum(deg)]).astype(np.int64)
    if native.HAVE_NATIVE:
        lab = native.label_prop_native(row_ptr, nbrs, n,
                                       max_iter=max_iter, seed=seed)
    if lab is None:
        lab = _label_prop_numpy(row_ptr, nbrs, n, max_iter)
    _, compact = np.unique(lab, return_inverse=True)
    return compact.astype(np.int32)


def reorder_nodes(g: HostGraph, method: str = "degree", labels=None,
                  perm=None):
    """Relabel nodes to densify adjacency blocks (returns (HostGraph, perm),
    where perm[new_id] = old_id; apply ``x[perm]`` to node features).

    Power-law graphs under arbitrary labelling spread edges uniformly over
    the adjacency, which is the worst case for gather locality.  Degree-descending relabelling concentrates edges in
    the low-index blocks — the classic densification the reference's own
    per-tile nnz statistics exist to exploit (preprocessing.py).

    ``method="labels"`` groups nodes by a cluster assignment (``labels``,
    e.g. metis/louvain communities), degree-descending within each cluster
    — intra-cluster edges land in dense diagonal blocks.
    """
    s = g.senders[: g.n_edge]
    r = g.receivers[: g.n_edge]
    if method == "degree":
        deg = np.bincount(r, minlength=g.n_node) + np.bincount(
            s, minlength=g.n_node)
        perm = np.argsort(-deg, kind="stable").astype(np.int64)
    elif method == "labels":
        assert labels is not None and len(labels) == g.n_node
        deg = np.bincount(r, minlength=g.n_node) + np.bincount(
            s, minlength=g.n_node)
        perm = np.lexsort((-deg, np.asarray(labels))).astype(np.int64)
    elif method == "hubs+labels":
        # global hubs first (one dense row region catches the power-law
        # head of CROSS-community edges), then label-grouped: the two-level
        # ordering that densifies both the degree head and the community
        # diagonal.  hub cut = top 2% by degree.
        assert labels is not None and len(labels) == g.n_node
        deg = np.bincount(r, minlength=g.n_node) + np.bincount(
            s, minlength=g.n_node)
        k = max(int(g.n_node * 0.02), 1)
        cut = np.sort(deg)[::-1][k - 1]
        is_hub = deg >= max(cut, 1)
        key_group = np.where(is_hub, -1, np.asarray(labels))
        perm = np.lexsort((-deg, key_group)).astype(np.int64)
    elif method == "cluster":
        # label-free: discover communities by label propagation, then apply
        # the hubs+labels two-level ordering — the path real graphs take
        # (planted labels only exist for synthetic data)
        found = cluster_labels(g)
        return reorder_nodes(g, "hubs+labels", labels=found)
    elif method == "none":
        perm = np.arange(g.n_node, dtype=np.int64)
    elif method == "perm":
        # caller-supplied relabelling (e.g. parallel.community_partition_order)
        assert perm is not None and len(perm) == g.n_node
        perm = np.asarray(perm, np.int64)
    else:
        raise ValueError(f"unknown reorder method {method!r}")
    inv = np.empty_like(perm)
    inv[perm] = np.arange(g.n_node)
    out = build_host_graph(
        inv[s].astype(np.int32), inv[r].astype(np.int32), g.n_node,
        edge_weight=g.edge_weight[: g.n_edge],
        edge_pad_multiple=g.e_pad,   # preserve the static edge padding
    )
    return out, perm


def nnz_histogram(g, tile_rows: int) -> np.ndarray:
    """nnz count per tile_rows-row stripe of the adjacency — the autotuner
    feature retained from the reference's preprocessing (SURVEY §7 layer 1)."""
    receivers = _as_host(g).receivers[: g.n_edge]
    n_stripes = _round_up(g.n_node, tile_rows) // tile_rows
    hist = np.zeros(n_stripes, np.int64)
    np.add.at(hist, receivers // tile_rows, 1)
    return hist
