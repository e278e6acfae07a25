"""Schedules: fusion partitions + tile sizes, with an analytic cost model.

This is the re-design of the reference compiler (vTCAD/code/compiler.py):

* the *fusion pattern* (one bit per op-DAG edge, ``generate_all_binaries``
  :394-454) becomes a partition of the op graph into blocks; blocks matching
  a kernel pattern execute fused, everything else lowers to XLA ops (which
  XLA further fuses);
* the *tile size search* (``binary_search`` under the 2MB buffer,
  :67-131) survives as the reference's buffer model: :func:`buffer_bytes`
  / :func:`tile_is_feasible` bound a tile by a configured on-chip buffer
  (``configs/reference_gta.json`` reproduces the reference's 2 MB);
* the *DRAM traffic model* (``cal_size`` :153-270) becomes
  :func:`traffic_bytes` — HBM bytes per schedule, used to prune candidates
  before measuring real latency (the reference pruned with
  ``mem_access/BW > 1.1 x best`` — genetic_algorithm.py:108-111).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from .. import ir

BYTES = 4  # f32; bf16 halves traffic (tracked via dtype_bytes arg)


PATH_XLA = "xla"         # per-op XLA primitives (materialised edge tensors)
PATH_CSR = "csr"         # CSR Pallas kernels (ops/spmm.py, ops/gat.py):
                         # one fused gather-reduce per SpMM / GAT block
PATH_STREAM = "stream"   # lax.scan edge streaming (memory-bounded regime)
PATH_DENSEFULL = "densefull"  # FULL dense adjacency matmul: y = A @ x with
                         # A materialised [N_pad, N_pad] bf16 — one big
                         # tensor-core op for medium N.  SpMM blocks only;
                         # guarded by graph.densefull_max_n.
PATHS = (PATH_XLA, PATH_CSR, PATH_STREAM, PATH_DENSEFULL)


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """Per-block execution config (the reference's per-block
    ``[tile_rows, tile_cols]`` plus the kernel-vs-XLA dispatch choice,
    simulator.py:541-545):

    * ``xla``       — per-op XLA lowering ([E, F] edge tensors in HBM);
    * ``csr``       — the CSR kernels (SpMM and GAT blocks);
    * ``stream``    — chunked lax.scan streaming; ``tile_edges`` x 2048
      edges per chunk;
    * ``densefull`` — dense adjacency matmul (SpMM blocks).

    ``block_rows`` / ``block_cols`` / ``tile_edges`` are the reference's
    tile: the buffer model (:func:`tile_is_feasible`) bounds them, and the
    stream path takes its chunk from ``tile_edges``.  The CSR kernels take
    their launch parameters from ops/spmm.LAUNCH, not from the tile."""
    block_rows: int = 256
    block_cols: int = 256
    tile_edges: int = 512
    path: str = PATH_CSR

    def key(self) -> Tuple:
        return (self.block_rows, self.block_cols, self.tile_edges, self.path)

    def exec_key(self) -> Tuple:
        """What the lowering distinguishes: the path, plus the chunk on
        the stream path."""
        if self.path == PATH_STREAM:
            return (self.path, self.tile_edges)
        return (self.path,)

    @property
    def kernel(self) -> bool:
        return self.path != PATH_XLA


@dataclasses.dataclass(frozen=True)
class Schedule:
    """A fusion partition plus per-block tile configs.

    ``blocks`` lists op-ids per fused block in topological order of the
    quotient DAG; ``tiles[i]`` configures block i (only used when the block
    lowers to a Pallas kernel)."""
    blocks: Tuple[Tuple[int, ...], ...]
    tiles: Tuple[TileConfig, ...]

    def key(self) -> str:
        bs = ";".join(",".join(map(str, b)) for b in self.blocks)
        ts = ";".join("x".join(map(str, t.key())) for t in self.tiles)
        return f"{bs}|{ts}"

    @classmethod
    def from_key(cls, key: str) -> "Schedule":
        """Inverse of :meth:`key` (memo CSV entries -> Schedule)."""
        bs, ts = key.split("|")
        blocks = tuple(tuple(int(o) for o in b.split(","))
                       for b in bs.split(";"))
        tiles = []
        for t in ts.split(";"):
            # maxsplit: the path name may itself contain 'x' ("xla")
            br, bc, te, path = t.split("x", 3)
            tiles.append(TileConfig(int(br), int(bc), int(te), path))
        return cls(blocks=blocks, tiles=tuple(tiles))


# ---------------------------------------------------------------------------
# partition enumeration (the reference's fusion bitstrings)
# ---------------------------------------------------------------------------


def _components(n_ops: Sequence[int], fused_edges: Iterable[Tuple[int, int]]) -> List[List[int]]:
    parent = {o: o for o in n_ops}

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in fused_edges:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    comps: Dict[int, List[int]] = {}
    for o in n_ops:
        comps.setdefault(find(o), []).append(o)
    return [sorted(c) for c in comps.values()]


def _order_blocks(graph: ir.OpGraph, blocks: List[List[int]]) -> List[List[int]]:
    """Topologically order blocks by the quotient DAG (deterministic)."""
    block_of = {o: i for i, b in enumerate(blocks) for o in b}
    indeg = [0] * len(blocks)
    succ: List[set] = [set() for _ in blocks]
    for u, v in graph.edges():
        a, b = block_of[u], block_of[v]
        if a != b and b not in succ[a]:
            succ[a].add(b)
            indeg[b] += 1
    ready = sorted(i for i, d in enumerate(indeg) if d == 0)
    out = []
    while ready:
        a = ready.pop(0)
        out.append(blocks[a])
        for b in sorted(succ[a]):
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
        ready.sort(key=lambda i: blocks[i])
    return out


def enumerate_partitions(
    graph: ir.OpGraph,
    max_edges: int = 20,
    limit: Optional[int] = None,
) -> List[Tuple[Tuple[int, ...], ...]]:
    """All legal fusion partitions of the op DAG (reference
    ``generate_all_binaries``, compiler.py:394-454): one bit per DAG edge,
    breakpoint edges forced to 0 (the reference's skip_bits), candidates with
    an illegal block (internal breakpoint / quotient cycle) rejected."""
    edges = graph.edges()
    ids = [op.op_id for op in graph.ops]
    free, forced_zero = [], []
    for (u, v) in edges:
        if ir.is_breakpoint(graph.by_id[u], graph.by_id[v]):
            forced_zero.append((u, v))
        else:
            free.append((u, v))
    if len(free) > max_edges:
        raise ValueError(
            f"{len(free)} free fusion edges > {max_edges}; use the GA search")
    seen = set()
    out: List[Tuple[Tuple[int, ...], ...]] = []
    for bits in itertools.product((0, 1), repeat=len(free)):
        fused = [e for e, b in zip(free, bits) if b]
        blocks = _components(ids, fused)
        key = tuple(tuple(b) for b in sorted(blocks))
        if key in seen:
            continue
        seen.add(key)
        if not ir.partition_is_legal(graph, blocks):
            continue
        ordered = _order_blocks(graph, blocks)
        out.append(tuple(tuple(b) for b in ordered))
        if limit and len(out) >= limit:
            break
    return out


def singleton_partition(graph: ir.OpGraph) -> Tuple[Tuple[int, ...], ...]:
    return tuple((o,) for o in graph.topo_order())


def aggregation_partition(
        graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Partition isolating every SpMM-matchable aggregation chain
    (scatter(C) [-> apply_edge MUL edge_weight] -> gather(ADD|MEAN)) as its
    own block, everything else singleton.

    The enumerator cannot reach this shape for wider graphs (2^E blows past
    the partition limit before any partition isolates the chain), yet
    SAGE/GIN-style families need exactly this block for the kernel
    dispatch — the reference interpreter fuses the same scatter+gather
    pair via its pattern table (vTCAD/code/hardware_info.yaml:11-69)."""
    from .fusion import match_spmm
    consumers: dict = {op.op_id: set() for op in graph.ops}
    for op in graph.ops:
        for i in op.inputs:
            if i in consumers:
                consumers[i].add(op.op_id)
    blocks: List[List[int]] = []
    used: set = set()
    for ga in graph.ops:
        if ga.kind != ir.GATHER or len(ga.inputs) != 1 or ga.inputs[0] < 0:
            continue
        mid = graph.by_id[ga.inputs[0]]
        chain = None
        if mid.kind == ir.SCATTER:
            chain = [mid.op_id, ga.op_id]
        elif mid.kind == ir.APPLY_EDGE and ir.EDGE_WEIGHT in mid.inputs:
            sc = next((i for i in mid.inputs if i >= 0), None)
            if sc is not None and graph.by_id[sc].kind == ir.SCATTER:
                chain = [sc, mid.op_id, ga.op_id]
        if chain is None or used & set(chain):
            continue
        # internal values must not escape the block (lowering only
        # materialises the gather output) — neither to other consumers nor
        # as graph outputs
        if any(consumers[o] - set(chain) for o in chain[:-1]):
            continue
        if set(chain[:-1]) & set(graph.outputs):
            continue
        if match_spmm(graph, chain) is None:
            continue
        blocks.append(sorted(chain))
        used.update(chain)
    if not blocks:
        return None
    rest = [[o] for o in graph.topo_order() if o not in used]
    part = _order_blocks(graph, blocks + rest)
    return tuple(tuple(b) for b in part)


def max_fusion_partition(graph: ir.OpGraph) -> Tuple[Tuple[int, ...], ...]:
    """Greedy max fusion: fuse every non-breakpoint edge whose fusion keeps
    the partition legal (the reference's 'fuse all' GA seed,
    genetic_algorithm.py:87-99)."""
    ids = [op.op_id for op in graph.ops]
    fused: List[Tuple[int, int]] = []
    for (u, v) in graph.edges():
        if ir.is_breakpoint(graph.by_id[u], graph.by_id[v]):
            continue
        cand = fused + [(u, v)]
        blocks = _components(ids, cand)
        if ir.partition_is_legal(graph, blocks):
            fused = cand
    blocks = _components(ids, fused)
    return tuple(tuple(b) for b in _order_blocks(graph, blocks))


# ---------------------------------------------------------------------------
# analytic cost model (the reference's cal_size / rw)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """Static per-graph quantities the cost model needs (host-side)."""
    n_node: int
    n_edge: int
    e_pad: int


def traffic_bytes(
    graph: ir.OpGraph,
    blocks: Sequence[Sequence[int]],
    stats: GraphStats,
    dtype_bytes: int = 4,
) -> int:
    """HBM bytes for one forward under the partition: every cross-block value
    is written by its producer and read by each consuming block; intra-block
    values stay on chip.  Mirrors the reference's rw accounting
    (compiler.py:153-270) with edge-domain rows = e_pad, node rows = n_node.
    Weights count once per MM op (streamed from HBM)."""
    block_of = {o: i for i, b in enumerate(blocks) for o in b}

    def rows(domain: str) -> int:
        return stats.n_node if domain == ir.NODE else stats.e_pad

    total = 0
    for op in graph.ops:
        w = op.extra.get("weight")
        if w is not None:
            _, iw, ow = w
            total += iw * ow * dtype_bytes
        # reads of graph inputs (X / edge_weight) by each block touching them
        for i in op.inputs:
            if i == ir.X_INPUT:
                total += stats.n_node * graph.in_width * dtype_bytes
            elif i == ir.EDGE_WEIGHT:
                total += stats.e_pad * dtype_bytes
    consumers: Dict[int, set] = {}
    for u, v in graph.edges():
        if block_of[u] != block_of[v]:
            consumers.setdefault(u, set()).add(block_of[v])
    for op in graph.ops:
        nbytes = rows(op.out_domain) * max(op.out_width, 1) * dtype_bytes
        outside = consumers.get(op.op_id, set())
        if outside or op.op_id in graph.outputs:
            total += nbytes                       # producer writes once
        total += nbytes * len(outside)            # each consumer block reads
    return total


def buffer_bytes(tile: TileConfig, feat_width: int,
                 dtype_bytes: int = 4) -> int:
    """Double-buffered on-chip footprint of one aggregation tile in the
    reference's buffer model: the x column block, the output row block,
    and the edge arrays (the reference's constraint W + (N+E)*2 < 2MB,
    compiler.py:67-131)."""
    x_blk = tile.block_cols * feat_width * dtype_bytes
    o_blk = tile.block_rows * feat_width * 4          # f32 accumulator
    edges = tile.tile_edges * (3 * 4 + dtype_bytes)   # src/dst/eid + weight
    return 2 * (x_blk + edges) + o_blk


def tile_is_feasible(
    tile: TileConfig,
    feat_width: int,
    buffer_budget: Optional[int] = None,
    dtype_bytes: int = 4,
) -> bool:
    """Buffer feasibility under the hardware config: total budget plus the
    per-region caps (node / edge buffer fractions — the reference's
    flexible-buffer W/N/E split, compiler.py:73-75,95-99).  With no budget
    configured (the default) every tile is feasible."""
    from ..hwconfig import load_hw_config
    cfg = load_hw_config()
    budget = (buffer_budget if buffer_budget is not None
              else cfg.buffer_budget_bytes)
    if budget is None:
        return True
    if buffer_bytes(tile, feat_width, dtype_bytes) > budget:
        return False
    _, node_frac, edge_frac = cfg.buffer_regions
    x_blk = tile.block_cols * feat_width * dtype_bytes
    o_blk = tile.block_rows * feat_width * 4
    edges = tile.tile_edges * (3 * 4 + dtype_bytes)
    if 2 * x_blk + o_blk > max(node_frac, 0.01) * budget * 2:
        return False
    if 2 * edges > max(edge_frac, 0.01) * budget * 2:
        return False
    return True


def pattern_partition(graph: ir.OpGraph) -> Optional[Tuple[Tuple[int, ...], ...]]:
    """Super-fused partition: the whole GAT attention chain as ONE block.

    The chain crosses two gather->scatter breakpoint edges, which the
    reference can never fuse (compiler.py:472-473 — its buffer model needs
    the node-aligned intermediates materialised).  The CSR attention kernel
    CAN cross them: under the shift bound, each row's num/den stay in
    registers for the whole walk of its in-edges, so the 'materialise +
    re-scatter' the breakpoint rule guards against never happens.  This is
    the fusion the simulated hardware could not express."""
    from ..ops.gat import find_gat_chain
    plan = find_gat_chain(graph)
    if plan is None:
        return None
    # internal chain values must not be graph outputs (the fused kernel
    # materialises only plan.out_op)
    if (set(plan.ops) - {plan.out_op}) & set(graph.outputs):
        return None
    rest = [o for o in graph.topo_order() if o not in plan.ops]
    blocks = [[o] for o in rest] + [sorted(plan.ops)]
    return tuple(tuple(b) for b in _order_blocks(graph, blocks))


def partition_is_legal_with_patterns(
    graph: ir.OpGraph, blocks: Sequence[Sequence[int]]
) -> bool:
    """Partition legality with the kernel-pattern exemption: a block that
    exactly matches a fused-kernel pattern may contain breakpoint edges."""
    from ..ops.gat import match_gat_block
    if ir.partition_is_legal(graph, blocks):
        return True
    exempt = [b for b in blocks if match_gat_block(graph, b) is not None]
    if not exempt:
        return False
    # re-check with exempt blocks collapsed to opaque nodes: internal edges
    # of exempt blocks are ignored; quotient must still be a DAG and the
    # remaining blocks must be breakpoint-free.
    exempt_ids = {id(tuple(b)) for b in exempt}
    block_of = {}
    for i, b in enumerate(blocks):
        for o in b:
            if o in block_of:
                return False
            block_of[o] = i
    if set(block_of) != set(graph.by_id):
        return False
    exempt_idx = {i for i, b in enumerate(blocks)
                  if any(tuple(b) == tuple(e) for e in exempt)}
    for u, v in graph.edges():
        if block_of[u] == block_of[v] and block_of[u] not in exempt_idx \
                and ir.is_breakpoint(graph.by_id[u], graph.by_id[v]):
            return False
    qedges = {(block_of[u], block_of[v]) for u, v in graph.edges()
              if block_of[u] != block_of[v]}
    indeg = {i: 0 for i in range(len(blocks))}
    succ = {i: [] for i in range(len(blocks))}
    for a, b in qedges:
        indeg[b] += 1
        succ[a].append(b)
    ready = [i for i, d in indeg.items() if d == 0]
    seen = 0
    while ready:
        a = ready.pop()
        seen += 1
        for b in succ[a]:
            indeg[b] -= 1
            if indeg[b] == 0:
                ready.append(b)
    return seen == len(blocks)


def default_schedule(graph: ir.OpGraph) -> Schedule:
    """Best static schedule: pattern super-fusion when available, else max
    legal fusion."""
    blocks = pattern_partition(graph) or max_fusion_partition(graph)
    return Schedule(blocks=blocks, tiles=tuple(TileConfig() for _ in blocks))
