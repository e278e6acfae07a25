"""Dataset layer: loaders + synthetic generators with the reference's stats.

The reference hard-codes five dataset profiles (Cora, Citeseer, Pubmed,
Flickr, Reddit — ``vTCAD/GraphOP/genGraphOP.py:183-199``,
``vTCAD/code/simulator.py:434-445``) and preprocesses dense adjacency ``.npy``
dumps into per-tile nnz histograms.  This environment has no network access,
so this module provides:

* :func:`load_dataset` — reads real data from ``<root>/<name>.npz`` when such
  a file exists (keys: ``senders, receivers, x, y, train_mask, val_mask,
  test_mask``), else falls back to a *synthetic* graph with exactly the
  published node/edge/feature/class counts and a power-law degree profile
  (labelled ``synthetic=True`` so results are never mistaken for real-data
  accuracy numbers);
* :func:`synthetic_coo` — the power-law edge generator (Reddit-scale graphs
  are generated in O(E) numpy).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from ..graph import GraphTensor, HostGraph, build_host_graph

# name: (n_node, n_edge, n_feat, n_class)  — genGraphOP.py:183-199
DATASET_STATS = {
    "cora": (2708, 10556, 1433, 7),
    "citeseer": (3327, 9104, 3703, 6),
    "pubmed": (19717, 88648, 500, 3),
    "flickr": (89250, 899756, 500, 7),
    "reddit": (232965, 114615892, 602, 41),
    # small synthetic profile for fast tests
    "tiny": (200, 900, 32, 4),
}


@dataclasses.dataclass
class Dataset:
    name: str
    host_graph: HostGraph    # host twin — preprocessing reads this, never the device arrays
    x: np.ndarray            # [N, F] float32 node features
    y: np.ndarray            # [N] int32 labels
    train_mask: np.ndarray
    val_mask: np.ndarray
    test_mask: np.ndarray
    n_class: int
    synthetic: bool = True
    _device_graph: Optional[GraphTensor] = None

    @property
    def graph(self) -> GraphTensor:
        """Device GraphTensor (built lazily, exactly once)."""
        if self._device_graph is None:
            object.__setattr__(self, "_device_graph", self.host_graph.to_device())
        return self._device_graph


def synthetic_coo(n_node: int, n_edge: int, seed: int = 0, alpha: float = 0.8,
                  communities: int = 0, p_in: float = 0.7,
                  sender_alpha: float = 0.0):
    """Power-law-ish COO edge list (no self loops, possibly multi-edges for
    very large E).  Degree skew mimics real social/citation graphs so load
    balance behaviour is representative.

    ``communities`` > 0 plants a partition of that many communities and
    draws ``p_in`` of the edges *within* a community (sender uniform over
    the receiver's community) — the clustering regime of real social graphs
    (Reddit: subreddit-level assortativity).  ``communities=0`` keeps the
    round-1 behaviour: uniform senders, the adversarial no-locality case.
    With communities the return is (senders, receivers, com_of) — the
    labels stand in for the metis/louvain clustering pass a production
    pipeline runs on real data before block-sparse execution.

    ``sender_alpha`` > 0 draws CROSS-community senders from a zipf-like
    popularity of that exponent instead of uniformly.  Real social graphs
    have power-law OUT-degree too (a few prolific posters produce most
    cross-subreddit edges); the uniform default is the adversarial
    no-sender-locality case, under which every shard pair's halo saturates
    at full-batch density (PartitionedGraph.comm_report)."""
    rng = np.random.default_rng(seed)
    # Zipf-like node popularity for destinations, milder for sources
    p = (np.arange(1, n_node + 1, dtype=np.float64)) ** (-alpha)
    p /= p.sum()
    perm = rng.permutation(n_node)
    receivers = perm[rng.choice(n_node, size=n_edge, p=p)]
    if communities > 0:
        com_of = rng.integers(0, communities, size=n_node)
        # community member lists for intra-community sender draws
        order = np.argsort(com_of, kind="stable")
        starts = np.searchsorted(com_of[order], np.arange(communities + 1))
        sizes = np.diff(starts)
        intra = rng.random(n_edge) < p_in
        rc = com_of[receivers]
        # pick a uniform member of the receiver's community
        off = (rng.random(n_edge) * np.maximum(sizes[rc], 1)).astype(np.int64)
        if sender_alpha > 0:
            ps = (np.arange(1, n_node + 1, dtype=np.float64)
                  ) ** (-sender_alpha)
            ps /= ps.sum()
            perm_s = rng.permutation(n_node)
            cross = perm_s[rng.choice(n_node, size=n_edge, p=ps)]
        else:
            cross = rng.integers(0, n_node, size=n_edge)
        senders = np.where(intra, order[starts[rc] + off], cross)
    else:
        senders = rng.integers(0, n_node, size=n_edge)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    if communities > 0:
        return senders.astype(np.int32), receivers.astype(np.int32), com_of
    return senders.astype(np.int32), receivers.astype(np.int32)


def _planted_labels(x_seed_rng, n_node, n_class, senders, receivers, n_feat):
    """Features correlated with a planted community structure so that
    training on synthetic data is a meaningful convergence test."""
    y = x_seed_rng.integers(0, n_class, size=n_node).astype(np.int32)
    centers = x_seed_rng.normal(0, 1.0, size=(n_class, n_feat)).astype(np.float32)
    x = centers[y] + x_seed_rng.normal(0, 2.0, size=(n_node, n_feat)).astype(np.float32)
    return x.astype(np.float32), y


def load_dataset(
    name: str,
    root: Optional[str] = None,
    *,
    seed: int = 0,
    add_self_loops: bool = True,
    symmetric_norm: bool = True,
    edge_pad_multiple: int = 512,
) -> Dataset:
    name = name.lower()
    path = os.path.join(root, f"{name}.npz") if root else None
    if not (path and os.path.exists(path)):
        # checked-in REAL-graph fixtures (karate, digits — built by
        # scripts/make_real_fixtures.py from in-image package data) and
        # any real dataset imported via scripts/import_dataset.py into
        # the fixtures dir resolve by bare name
        fpath = os.path.join(os.path.dirname(__file__), "fixtures",
                             f"{name}.npz")
        if os.path.exists(fpath):
            path = fpath
    if path and os.path.exists(path):
        z = np.load(path)
        senders, receivers = z["senders"], z["receivers"]
        x, y = z["x"].astype(np.float32), z["y"].astype(np.int32)
        n_node, n_feat = x.shape
        n_class = int(y.max()) + 1
        train_mask, val_mask, test_mask = z["train_mask"], z["val_mask"], z["test_mask"]
        synthetic = False
    else:
        if name not in DATASET_STATS:
            raise ValueError(f"unknown dataset {name}")
        n_node, n_edge, n_feat, n_class = DATASET_STATS[name]
        senders, receivers = synthetic_coo(n_node, n_edge, seed)
        rng = np.random.default_rng(seed + 1)
        x, y = _planted_labels(rng, n_node, n_class, senders, receivers, n_feat)
        idx = rng.permutation(n_node)
        n_tr = max(n_class * 20, n_node // 10)
        n_va = max(n_node // 10, 1)
        train_mask = np.zeros(n_node, bool); train_mask[idx[:n_tr]] = True
        val_mask = np.zeros(n_node, bool); val_mask[idx[n_tr:n_tr + n_va]] = True
        test_mask = np.zeros(n_node, bool); test_mask[idx[n_tr + n_va:]] = True
        synthetic = True

    g = build_host_graph(
        senders, receivers, n_node,
        add_self_loops=add_self_loops,
        symmetric_norm=symmetric_norm,
        edge_pad_multiple=edge_pad_multiple,
    )
    return Dataset(
        name=name, host_graph=g, x=x, y=y,
        train_mask=train_mask, val_mask=val_mask, test_mask=test_mask,
        n_class=n_class, synthetic=synthetic,
    )


def community_dataset(name: str, *, n_edge: Optional[int] = None,
                      seed: int = 1, communities: int = 1000,
                      p_in: float = 0.7) -> Dataset:
    """A synthetic dataset at the published dimensions of ``name``
    (:data:`DATASET_STATS`) drawn by :func:`synthetic_coo` with planted
    communities — the benchmark graph of full-batch training at Reddit
    scale (``communities=1000, p_in=0.7``, seed 1).  ``n_edge`` cuts the
    edge count (the node, feature and class counts stay published).
    Self loops and the symmetric normalisation are added as in
    :func:`load_dataset`."""
    n_node, e_pub, n_feat, n_class = DATASET_STATS[name]
    s, r, _ = synthetic_coo(n_node, n_edge or e_pub, seed,
                            communities=communities, p_in=p_in)
    rng = np.random.default_rng(seed + 1)
    x, y = _planted_labels(rng, n_node, n_class, s, r, n_feat)
    idx = rng.permutation(n_node)
    n_tr = max(n_class * 20, n_node // 10)
    n_va = max(n_node // 10, 1)
    masks = [np.zeros(n_node, bool) for _ in range(3)]
    masks[0][idx[:n_tr]] = True
    masks[1][idx[n_tr:n_tr + n_va]] = True
    masks[2][idx[n_tr + n_va:]] = True
    g = build_host_graph(s, r, n_node, add_self_loops=True,
                         symmetric_norm=True)
    return Dataset(name=name, host_graph=g, x=x, y=y, train_mask=masks[0],
                   val_mask=masks[1], test_mask=masks[2], n_class=n_class,
                   synthetic=True)
