"""Analytic *latency* model for compile-only schedule choice.

The reference's compiler+simulator pair predicts the fastest schedule
without measuring: the compiler sorts candidates by DRAM traffic
(vTCAD/code/compiler.py:452) and the simulator converts the instruction
stream to cycles (vTCAD/code/simulator.py:281-355, 423-650) — unit
occupancy, per-tile nnz, bytes/BW.  Traffic-min is not latency-min on a
real device, so this module plays the simulator's *role* with a linear
model: every schedule is reduced to a handful of counts (edge rows gathered
or reduced by XLA, bytes moved by elementwise ops, matmul FLOPs, edges
walked by each CSR kernel and the kernel programs that walk them, ops
launched, stream chunks), and its latency is
the dot product of those counts with per-unit costs fitted on the device by
``scripts/latency_fit.py`` from the tuner's measured memo.

``min_latency_schedule`` always ranks the all-XLA candidate alongside the
kernel candidates, so the compile-only pick can never *model itself* into
a regression: when no kernel block is predicted to beat XLA, the pick IS
per-op XLA (the reference equivalently keeps the unfused schedule in its
GA seed population, genetic_algorithm.py:68).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from .. import ir
from . import schedule as S

# The device the constants below were fitted on (jax device_kind); the memo
# rows of this device are what tests/test_latency_model.py ranks against.
CALIBRATED_DEVICE = "NVIDIA H100 80GB HBM3"

# names of the model's counts, in the order of LatencyConstants' fields
FEATURES = ("program", "xla_take_row", "xla_segment_row", "xla_byte",
            "mm_flop", "xla_op", "csr_spmm_edge", "csr_gat_edge",
            "csr_row_block", "kernel_call", "stream_edge", "stream_chunk")


@dataclasses.dataclass(frozen=True)
class LatencyConstants:
    """Nanoseconds per unit of each count in :data:`FEATURES`, fitted on
    :data:`CALIBRATED_DEVICE` by scripts/latency_fit.py (non-negative least
    squares over the measured memo rows)."""

    # fitted on the 31 rows of results/memo_{GCN,GAT}_{cora,flickr,reddit}.csv
    # (NVIDIA H100 80GB HBM3 at a 700 W power limit); a zero means the
    # memo does not resolve that unit's cost apart from the others
    program: float = 151353.0         # per call of the lowered program
    xla_take_row: float = 0.0         # per edge row per 128-lane group
    xla_segment_row: float = 0.0645196  # per edge row per 128-lane group
    xla_byte: float = 7.69484e-05     # per byte of elementwise traffic
    mm_flop: float = 2.71601e-05      # per matmul FLOP
    xla_op: float = 2660.79           # per XLA op (launch + fusion boundary)
    csr_spmm_edge: float = 0.0381022  # per edge per 128-lane group
    csr_gat_edge: float = 0.0442196   # per edge per 128-lane group
    csr_row_block: float = 2.17169    # per (row, column block) program
    kernel_call: float = 83090.8      # per CSR kernel call
    stream_edge: float = 0.530033     # per streamed edge per 128-lane group
    stream_chunk: float = 11646.5     # per lax.scan chunk

    def vector(self) -> np.ndarray:
        return np.array([getattr(self, f) for f in FEATURES], float)


DEFAULT = LatencyConstants()


def _lane_groups(width: int) -> int:
    return max(-(-max(width, 1) // 128), 1)


def _add(acc: Dict[str, float], **kw) -> Dict[str, float]:
    for k, v in kw.items():
        acc[k] = acc.get(k, 0.0) + float(v)
    return acc


def xla_op_counts(op: ir.Op, stats: S.GraphStats,
                  dtype_bytes: int = 2) -> Dict[str, float]:
    """Counts of one op under per-op XLA lowering."""
    n, e = stats.n_node, stats.e_pad
    w = max(op.out_width, 1)
    c = _add({}, xla_op=1)
    if op.kind == ir.SCATTER:
        return _add(c, xla_take_row=e * _lane_groups(w))
    if op.kind == ir.GATHER:
        return _add(c, xla_segment_row=e * _lane_groups(w))
    reads = max(len(op.inputs), 1)
    if op.kind == ir.APPLY_EDGE:
        return _add(c, xla_byte=(reads + 1) * e * w * dtype_bytes)
    wt = op.extra.get("weight")
    if op.compute == ir.MM and wt is not None:
        _, iw, ow = wt
        return _add(c, mm_flop=2.0 * n * iw * ow,
                    xla_byte=(n * iw + n * ow + iw * ow) * dtype_bytes)
    return _add(c, xla_byte=(reads + 1) * n * w * dtype_bytes)


def block_counts(graph: ir.OpGraph, block: Sequence[int], tc: S.TileConfig,
                 stats: S.GraphStats, dtype_bytes: int = 2
                 ) -> Dict[str, float]:
    """Counts of one fused block under its TileConfig.  Dispatch mirrors
    the lowering exactly (fusion.classify_block), so the model prices what
    actually runs."""
    from .fusion import classify_block
    kind, plan = classify_block(graph, block, tc)
    e = stats.e_pad
    # a CSR kernel runs one program per (destination row, column block):
    # on low-degree graphs most of a program's edge lanes are masked, so
    # its cost follows the rows, not the edges
    if kind == "spmm":
        groups = _lane_groups(graph.width_of(plan.in_op))
        return _add({}, kernel_call=1, csr_spmm_edge=e * groups,
                    csr_row_block=stats.n_node * groups)
    if kind == "gat":
        return _add({}, kernel_call=1, csr_gat_edge=e * _lane_groups(
            graph.width_of(plan.h_op)), csr_row_block=stats.n_node
            * plan.heads)
    if kind == "spmm_densefull":
        n_pad = -(-stats.n_node // 256) * 256
        f = max(graph.width_of(plan.in_op), 1)
        return _add({}, xla_op=1, mm_flop=2.0 * n_pad * n_pad * f,
                    xla_byte=n_pad * n_pad * 2.0 + 2.0 * n_pad * f
                    * dtype_bytes)
    if kind in ("spmm_stream", "gat_stream"):
        chunk = tc.tile_edges * 2048
        chunks = max(-(-e // chunk), 1)
        width = graph.width_of(plan.in_op if kind == "spmm_stream"
                               else plan.h_op)
        passes = 1 if kind == "spmm_stream" else 2
        return _add({}, stream_chunk=passes * chunks,
                    stream_edge=passes * e * _lane_groups(width))
    acc: Dict[str, float] = {}
    for o in block:
        _add(acc, **xla_op_counts(graph.by_id[o], stats, dtype_bytes))
    return acc


def schedule_counts(graph: ir.OpGraph, sched: S.Schedule,
                    stats: S.GraphStats, dtype_bytes: int = 2) -> np.ndarray:
    """The schedule's count vector (order: :data:`FEATURES`)."""
    acc: Dict[str, float] = {"program": 1.0}
    for b, tc in zip(sched.blocks, sched.tiles):
        _add(acc, **block_counts(graph, b, tc, stats, dtype_bytes))
    return np.array([acc.get(f, 0.0) for f in FEATURES], float)


def graph_stats(host_graph) -> S.GraphStats:
    return S.GraphStats(n_node=host_graph.n_node, n_edge=host_graph.n_edge,
                        e_pad=host_graph.e_pad)


# Sizes of the memo graphs too large to rebuild for a fit or a test: the
# full-batch Reddit-scale graph of ``cli tune --dataset reddit
# --communities 1000 --seed 1`` (data.datasets.community_dataset), as that
# command reports them
LARGE_MEMO_GRAPHS = {
    "reddit": S.GraphStats(n_node=232965, n_edge=114505698,
                           e_pad=114505728),
}


def memo_graph_stats(dataset: str) -> S.GraphStats:
    """GraphStats of the graph the tuner memo of ``dataset`` measured."""
    if dataset in LARGE_MEMO_GRAPHS:
        return LARGE_MEMO_GRAPHS[dataset]
    from ..data.datasets import load_dataset
    return graph_stats(load_dataset(dataset).host_graph)


def schedule_ns(graph: ir.OpGraph, sched: S.Schedule, stats: S.GraphStats,
                dtype_bytes: int = 2,
                c: LatencyConstants = DEFAULT) -> float:
    """Modelled end-to-end latency of a schedule."""
    return float(schedule_counts(graph, sched, stats, dtype_bytes)
                 @ c.vector())


def spearman_rank(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman's rho, 1 - 6 sum d^2 / (n (n^2 - 1)), over the argsort
    ranks (distinct by construction)."""
    n = len(a)
    if n < 2:
        return 0.0
    ra = np.argsort(np.argsort(a))
    rb = np.argsort(np.argsort(b))
    d2 = int(((ra - rb) ** 2).sum())
    return 1.0 - 6.0 * d2 / (n * (n * n - 1))


def memo_rows(memo_csv: str, graph_name: str,
              device_kind: str = CALIBRATED_DEVICE,
              version: Optional[int] = None):
    """(schedule, measured seconds) of the memo rows written by the tuner
    for ``graph_name`` on ``device_kind`` at the current KERNEL_VERSION."""
    import csv
    import os

    if version is None:
        from .fusion import KERNEL_VERSION
        version = KERNEL_VERSION
    if not os.path.exists(memo_csv):
        return []
    out = []
    with open(memo_csv) as f:
        for rec in csv.reader(f):
            if len(rec) != 2:
                continue
            parts = rec[0].split("|", 3)
            if len(parts) != 4 or parts[0] != f"v{version}":
                continue
            if parts[1] != device_kind or parts[2] != graph_name:
                continue
            out.append((S.Schedule.from_key(parts[3]), float(rec[1])))
    return out


def rank_check(memo_csv: str, graph_name: str, graph: ir.OpGraph,
               host_graph, dtype_bytes: int = 2,
               device_kind: str = CALIBRATED_DEVICE,
               constants: LatencyConstants = DEFAULT) -> Optional[dict]:
    """Validate the model's ranking against the memoised measured
    latencies (tune.search CSV memo — the reference's C15 regression log).
    ``host_graph`` may be the graph's GraphStats (:func:`memo_graph_stats`).
    Returns {rows, spearman, argmin_regret} or None when the memo has no
    matching entries.  CI floor: tests/test_latency_model.py."""
    stats = graph_stats(host_graph)
    rows = []
    for sched, secs in memo_rows(memo_csv, graph_name, device_kind):
        modelled = schedule_ns(graph, sched, stats, dtype_bytes,
                               constants) / 1e3
        rows.append((secs * 1e6, modelled, sched.key()))
    if not rows:
        return None
    rows.sort()
    meas = [r[0] for r in rows]
    mod = [r[1] for r in rows]
    pick = int(np.argmin(mod))
    return {
        "rows": rows,
        "spearman": spearman_rank(meas, mod),
        # measured latency of the modelled pick over the measured best:
        # the quantity that decides whether compile-only picking regresses
        "argmin_regret": meas[pick] / meas[0],
    }


def min_latency_schedule(
    graph: ir.OpGraph,
    host_graph,
    *,
    feat_width: Optional[int] = None,
    tile_palette: Optional[Sequence[S.TileConfig]] = None,
    max_partitions: int = 64,
    dtype_bytes: int = 2,
    constants: LatencyConstants = DEFAULT,
) -> Tuple[S.Schedule, float]:
    """Compile-only pick: argmin modelled latency over the candidate pool
    (the reference's compiler+simulator sort, simulator.py:423-650) —
    including the all-XLA schedule, so the pick never *models* a
    regression vs per-op XLA.  Candidates that would not run as named
    (tune.search.runnable) are skipped.  ``host_graph`` may be the graph's
    :class:`~.schedule.GraphStats`: the pick reads only its sizes.
    Returns (schedule, modelled_ns)."""
    from ..tune.search import _candidate_schedules, runnable
    if tile_palette is None:
        from ..hwconfig import load_hw_config
        tile_palette = load_hw_config().palette()
    fw = feat_width or graph.in_width
    stats = graph_stats(host_graph)
    best, best_t = None, float("inf")
    for cand in _candidate_schedules(graph, max_partitions, tile_palette):
        if not runnable(cand, fw, stats.n_node):
            continue
        t = schedule_ns(graph, cand, stats, dtype_bytes, constants)
        if t < best_t:
            best, best_t = cand, t
    return best, best_t


def pick_model_schedules(layers: Sequence[ir.OpGraph], host_graph,
                         in_width: int, training: bool = False
                         ) -> Tuple[list, float]:
    """The compile-only pick of every layer of a model stack, each at its
    own input width: ``([schedule per layer], modelled ns of the stack)``
    (what ``cli run|train --compiled`` executes).

    ``training`` leaves out the stream path: the model prices forwards
    (the tuner times forwards), and the stream path's ``lax.scan``
    backward costs far more than its forward — on an H100, Cora GAT
    trained at 5.3 ms a step on it against 0.9 ms on XLA (PERF.md)."""
    from ..hwconfig import load_hw_config
    palette = tuple(tc for tc in load_hw_config().palette()
                    if not (training and tc.path == S.PATH_STREAM))
    scheds, total, w = [], 0.0, in_width
    for g in layers:
        sc, t_ns = min_latency_schedule(g, host_graph, feat_width=w,
                                        tile_palette=palette)
        scheds.append(sc)
        total += t_ns
        w = max(op.out_width for op in g.ops if op.op_id in g.outputs)
    return scheds, total
