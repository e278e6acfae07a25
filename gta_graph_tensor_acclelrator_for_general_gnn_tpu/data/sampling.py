"""Host-side neighbour sampling for GraphSAGE-style minibatch training.

The reference scales to Reddit only by slicing the graph to 25% of rows in
preprocessing (preprocessing_forReditFlickr.py:10-13) — it never executes,
so it never needs minibatches.  Real training at Reddit scale wants sampled
subgraphs; jit additionally wants them at **static shapes**, so every batch
is padded to a fixed node/edge capacity and the same jitted train step serves
every batch.

CSR trick: GraphTensor/HostGraph edges are already receiver-sorted, so the
in-neighbour list of node v is the contiguous range row_ptr[v]:row_ptr[v+1]
— no extra index build beyond one searchsorted.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from ..graph import GraphTensor, HostGraph, build_host_graph


@dataclasses.dataclass
class SampledBatch:
    """A fixed-shape sampled subgraph.

    node_ids: int32[cap_nodes] global ids (padded with -1);
    graph: the relabelled subgraph (static e_pad);
    seed_mask: bool[cap_nodes] True on the first n_seed slots (loss nodes).
    """
    graph: HostGraph
    node_ids: np.ndarray
    seed_mask: np.ndarray
    n_seed: int

    @property
    def cap_nodes(self) -> int:
        return len(self.node_ids)

    def device_graph(self) -> GraphTensor:
        """GraphTensor with ``n_edge`` pinned to the static capacity.

        ``n_edge`` is a static pytree field, and each sampled batch has a
        different real edge count — shipping it verbatim would retrace the
        jitted train step on nearly every batch (a compile each).  Device-side the real count is irrelevant: padded edges
        point at the dump row and carry mask/weight 0, so pinning
        n_edge = e_pad keeps ONE compiled step for the whole run."""
        gt = self.graph.to_device()
        return dataclasses.replace(gt, n_edge=self.graph.e_pad)


class NeighborSampler:
    """Uniform with-replacement k-hop in-neighbour sampler (GraphSAGE)."""

    def __init__(self, hg: HostGraph, fanouts: Sequence[int],
                 batch_size: int, seed: int = 0):
        self.hg = hg
        self.fanouts = list(fanouts)
        self.batch = batch_size
        self.rng = np.random.default_rng(seed)
        r = hg.receivers[: hg.n_edge]
        self.senders = hg.senders[: hg.n_edge]
        self.weights = hg.edge_weight[: hg.n_edge]
        self.row_ptr = np.searchsorted(r, np.arange(hg.n_node + 1))
        self.deg = np.diff(self.row_ptr)
        # static capacities: seeds + fanout closure
        cap = batch_size
        layer = batch_size
        self.cap_edges_per_hop = []
        for f in self.fanouts:
            self.cap_edges_per_hop.append(layer * f)
            layer = layer * f
            cap += layer
        self.cap_nodes = cap
        self.cap_edges = sum(self.cap_edges_per_hop)

    def sample(self, seeds: np.ndarray) -> SampledBatch:
        """Sample the fanout closure of ``seeds`` (len <= batch_size)."""
        seeds = np.asarray(seeds, np.int64)
        n_seed = len(seeds)
        frontier = seeds
        e_src: List[np.ndarray] = []
        e_dst: List[np.ndarray] = []
        for f in self.fanouts:
            deg = self.deg[frontier]
            has = deg > 0
            # with-replacement uniform picks per frontier node
            pick = self.rng.integers(0, np.maximum(deg, 1)[:, None],
                                     size=(len(frontier), f))
            idx = self.row_ptr[frontier][:, None] + pick
            nbrs = self.senders[idx]                       # [|F|, f]
            dsts = np.broadcast_to(frontier[:, None], nbrs.shape)
            keep = np.broadcast_to(has[:, None], nbrs.shape)
            e_src.append(nbrs[keep])
            e_dst.append(dsts[keep])
            frontier = np.unique(nbrs[keep])
        src = np.concatenate(e_src) if e_src else np.zeros(0, np.int64)
        dst = np.concatenate(e_dst) if e_dst else np.zeros(0, np.int64)

        # relabel: seeds first (so loss masks are the leading slots)
        others = np.setdiff1d(np.unique(np.concatenate([src, dst])), seeds)
        node_ids = np.concatenate([seeds, others])[: self.cap_nodes]
        local = np.full(self.hg.n_node, -1, np.int64)
        local[node_ids] = np.arange(len(node_ids))
        keep = (local[src] >= 0) & (local[dst] >= 0)
        ls, ld = local[src[keep]], local[dst[keep]]

        pad_nodes = self.cap_nodes - len(node_ids)
        ids = np.concatenate(
            [node_ids, np.full(pad_nodes, -1, np.int64)]).astype(np.int64)
        sub = build_host_graph(
            ls.astype(np.int32), ld.astype(np.int32), self.cap_nodes,
            add_self_loops=True, symmetric_norm=False,
            edge_pad_multiple=self.cap_edges + self.cap_nodes)
        seed_mask = np.zeros(self.cap_nodes, bool)
        seed_mask[:n_seed] = True
        return SampledBatch(graph=sub, node_ids=ids, seed_mask=seed_mask,
                            n_seed=n_seed)

    def epoch(self, train_nodes: np.ndarray):
        """Shuffled minibatch iterator over ``train_nodes`` (drops the last
        ragged batch to keep shapes static)."""
        perm = self.rng.permutation(train_nodes)
        for i in range(0, len(perm) - self.batch + 1, self.batch):
            yield self.sample(perm[i : i + self.batch])


def gather_features(x: np.ndarray, batch: SampledBatch) -> np.ndarray:
    """Features for a batch's nodes (padding rows get zeros)."""
    out = np.zeros((batch.cap_nodes, x.shape[1]), x.dtype)
    valid = batch.node_ids >= 0
    out[valid] = x[batch.node_ids[valid]]
    return out
