"""Schedule autotuning with measured fitness.

The reference searches its schedule space two ways — exhaustive enumeration
with tile-scale sweeps (code/enumeration.py:87-101) and a genetic algorithm
(vTCAD/code/genetic_algorithm.py) — with *simulated* latency as fitness and a
CSV memo doubling as crash-resume (:550-608).  Here the space is the same in
spirit (fusion partition x per-block path x kernel-vs-XLA dispatch), but
fitness is **measured wall time on the device** and the analytic HBM
traffic model prunes before paying for a compile+measure.  Memo keys carry
the kernel version and the device kind, so a measurement on one device
never steers a pick on another.
"""
from __future__ import annotations

import csv
import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import jax

from .. import ir
from ..compiler import schedule as S
from ..compiler.fusion import KERNEL_VERSION, lower_schedule
from ..graph import HostGraph
from ..utils.benchmark import time_apply

# paths swept per pattern block: the CSR kernels, edge streaming at three
# chunk sizes (tile_edges x 2048 edges per chunk) and the dense adjacency
TILE_PALETTE = (
    S.TileConfig(path=S.PATH_CSR),
    S.TileConfig(tile_edges=1, path=S.PATH_STREAM),     # 2k-edge chunks
    S.TileConfig(tile_edges=8, path=S.PATH_STREAM),     # 16k-edge chunks
    S.TileConfig(tile_edges=128, path=S.PATH_STREAM),   # 256k-edge chunks
    S.TileConfig(path=S.PATH_DENSEFULL),                # full dense A
)


def memo_key(graph: ir.OpGraph, sched: S.Schedule,
             device_kind: Optional[str] = None) -> str:
    """``v{KERNEL_VERSION}|{device kind}|{graph name}|{schedule key}``."""
    if device_kind is None:
        device_kind = jax.devices()[0].device_kind
    return f"v{KERNEL_VERSION}|{device_kind}|{graph.name}|{sched.key()}"


@dataclasses.dataclass
class Measurement:
    schedule: S.Schedule
    latency_s: float
    traffic: int


@dataclasses.dataclass
class TuneResult:
    best: S.Schedule
    latency_s: float
    trials: List[Measurement]

    @property
    def pareto(self) -> List[Measurement]:
        """Measured (latency, modelled-HBM-traffic) Pareto frontier.

        A deployment picks from this set, not just ``best``: on a
        bandwidth-shared device (serving several models, or a multi-device
        step where HBM feeds collectives too) the lowest-latency schedule is not
        necessarily the lowest-pressure one.  Sorted by latency; every entry
        strictly trades latency for traffic."""
        front: List[Measurement] = []
        for m in sorted(self.trials, key=lambda m: (m.latency_s, m.traffic)):
            if not any(f.traffic <= m.traffic for f in front):
                front.append(m)
        return front

    def report(self) -> str:
        lines = [f"{len(self.trials)} schedules measured; best "
                 f"{self.latency_s*1e6:.1f}us"]
        for m in sorted(self.trials, key=lambda m: m.latency_s)[:10]:
            lines.append(f"  {m.latency_s*1e6:9.1f}us  traffic={m.traffic:>12}  "
                         f"{m.schedule.key()}")
        front = self.pareto
        if len(front) > 1:
            lines.append(f"pareto (latency vs HBM traffic), {len(front)} points:")
            for m in front:
                lines.append(f"  {m.latency_s*1e6:9.1f}us  "
                             f"traffic={m.traffic:>12}  {m.schedule.key()}")
        return "\n".join(lines)


class Memo:
    """(schedule key) -> latency CSV memo; the reference's
    check_csv_for_sample / save_sample_to_csv (genetic_algorithm.py:550-608),
    which doubles as search-resume state."""

    def __init__(self, path: Optional[str]):
        self.path = path
        self.data: Dict[str, float] = {}
        if path and os.path.exists(path):
            with open(path) as f:
                for row in csv.reader(f):
                    if len(row) == 2:
                        self.data[row[0]] = float(row[1])

    def get(self, key: str) -> Optional[float]:
        return self.data.get(key)

    def put(self, key: str, latency: float):
        self.data[key] = latency
        if self.path:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            with open(self.path, "a", newline="") as f:
                csv.writer(f).writerow([key, latency])


def runnable(sched: S.Schedule, feat_width: int, n_node: int) -> bool:
    """Whether every tile of ``sched`` runs as its path names it: CSR tiles
    within the buffer budget, and ``densefull`` only up to
    :func:`graph.densefull_max_n` nodes.  Above that cap lower_schedule runs
    the block on XLA, so measuring or pricing the candidate would credit
    XLA's time to the dense path."""
    if any(tc.path == S.PATH_CSR and not S.tile_is_feasible(tc, feat_width)
           for tc in sched.tiles):
        return False
    if any(tc.path == S.PATH_DENSEFULL for tc in sched.tiles):
        from ..graph import densefull_max_n
        return n_node <= densefull_max_n()
    return True


def _exec_signature(graph: ir.OpGraph, sched: S.Schedule) -> tuple:
    """Signature of what actually executes.  All-XLA schedules lower to the
    same jitted program regardless of partition (jit re-fuses everything), so
    only kernel-dispatched blocks differentiate candidates — measuring two
    schedules with the same signature is paying a compile for nothing.
    """
    from ..compiler.fusion import classify_block
    sig = []
    for b, tc in zip(sched.blocks, sched.tiles):
        if not tc.kernel:
            continue
        kind, _ = classify_block(graph, b, tc)
        if kind != "xla":
            sig.append((kind, tuple(b), tc.exec_key()))
    return tuple(sorted(sig))


def _candidate_schedules(
    graph: ir.OpGraph,
    max_partitions: int,
    tile_palette: Sequence[S.TileConfig],
) -> List[S.Schedule]:
    """Candidate pool, deduplicated by execution signature: one all-XLA
    schedule plus each distinct set of kernel-dispatched pattern blocks
    swept over the tile palette."""
    # order matters: the first partition with a given execution signature is
    # the representative that gets measured, and XLA fuses aggressively on
    # its own — so lead with the max-fused partitions (their modelled traffic
    # reflects what the all-XLA executable actually moves).
    parts: List[Tuple[Tuple[int, ...], ...]] = []
    pp = S.pattern_partition(graph)
    if pp is not None and pp not in parts:
        parts.append(pp)
    ap = S.aggregation_partition(graph)
    if ap is not None and ap not in parts:
        parts.append(ap)
    mf = S.max_fusion_partition(graph)
    if mf not in parts:
        parts.append(mf)
    try:
        for part in S.enumerate_partitions(graph, limit=max_partitions):
            if part not in parts:
                parts.append(part)
    except ValueError:
        if S.singleton_partition(graph) not in parts:
            parts.append(S.singleton_partition(graph))

    from ..compiler.fusion import classify_block

    out: List[S.Schedule] = []
    seen = set()

    def add(sched: S.Schedule):
        sig = _exec_signature(graph, sched)
        if sig not in seen:
            seen.add(sig)
            out.append(sched)

    probe = S.TileConfig(path=S.PATH_CSR)
    for part in parts:
        pattern_idx = [i for i, b in enumerate(part)
                       if classify_block(graph, b, probe)[0] != "xla"]
        base = tuple(S.TileConfig(path=S.PATH_XLA) for _ in part)
        add(S.Schedule(blocks=part, tiles=base))
        if pattern_idx:
            for tc in tile_palette:
                tiles = list(base)
                for i in pattern_idx:
                    tiles[i] = tc
                add(S.Schedule(blocks=part, tiles=tuple(tiles)))
    return out


def autotune(
    graph: ir.OpGraph,
    host_graph: HostGraph,
    params,
    g_dev,
    x,
    *,
    compute_dtype=None,
    memo_path: Optional[str] = None,
    max_partitions: int = 64,
    tile_palette: Optional[Sequence[S.TileConfig]] = None,
    traffic_prune: float = 4.0,
    iters: int = 30,
    feat_width: Optional[int] = None,
    verbose: bool = False,
    seed_schedules: Sequence[S.Schedule] = (),
) -> TuneResult:
    """Measure candidate schedules, return the fastest.

    ``traffic_prune``: skip candidates whose modelled HBM traffic exceeds
    ``traffic_prune x`` the best modelled traffic (reference prunes at 1.5x
    traffic / 1.1x latency-bound; we are looser because kernel dispatch can
    beat lower-traffic schedules).

    ``seed_schedules`` are measured unconditionally (never traffic-pruned)
    — use to carry a schedule tuned at another operating point into this
    tune (e.g. the B=1 winner into a batched serving-shape tune).

    ``iters``: timed calls per candidate (median reported).
    """
    if tile_palette is None:
        from ..hwconfig import load_hw_config
        tile_palette = load_hw_config().palette()
    stats = S.GraphStats(
        n_node=host_graph.n_node,
        n_edge=host_graph.n_edge,
        e_pad=host_graph.e_pad,
    )
    fw = feat_width or graph.in_width
    memo = Memo(memo_path)
    cands = _candidate_schedules(graph, max_partitions, tile_palette)
    cands = [c for c in cands if c not in seed_schedules]
    n_seed = len(list(seed_schedules))
    cands = list(seed_schedules) + cands
    traffics = [S.traffic_bytes(graph, c.blocks, stats) for c in cands]
    t_min = min(traffics)

    trials: List[Measurement] = []
    for i, (sched, traffic) in enumerate(zip(cands, traffics)):
        if i > n_seed and traffic > traffic_prune * t_min:
            continue  # seeds + the all-XLA baseline never prune
        if not runnable(sched, fw, host_graph.n_node):
            continue
        key = memo_key(graph, sched)
        lat = memo.get(key)
        if lat is None:
            fn = lower_schedule(graph, sched, host_graph, compute_dtype)
            lat = time_apply(fn, params, g_dev, x, iters=iters)
            memo.put(key, lat)
        trials.append(Measurement(sched, lat, traffic))
        if verbose:
            print(f"  {lat*1e6:9.1f}us  {sched.key()}")

    best = min(trials, key=lambda m: m.latency_s)
    return TuneResult(best=best.schedule, latency_s=best.latency_s,
                      trials=trials)
