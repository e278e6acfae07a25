"""Schedule lowering: fused blocks -> CSR kernels, the rest -> XLA.

The reference interpreter turns fused blocks into simulated fused
instructions according to the ``hardware_info.yaml`` pattern table
(vTCAD/code/interpreter.py:540-719: scatter+applyedge, applyedge+gather,
x3 chains...).  Here a fused block that matches a kernel pattern executes as
one kernel; unmatched blocks run op-by-op through the XLA primitives (and
XLA fuses the elementwise chains on its own).

Patterns implemented:
  * SPMM  — scatter(C) [-> apply_edge MUL edge_weight] -> gather(ADD|MEAN):
    the neighbourhood aggregation of GCN/SGC/SAGE/GIN/DGN, one CSR SpMM
    (ops/spmm.py).
  * GAT   — the full edge-softmax attention block (scatters, logits,
    stable softmax, weighted aggregation) as one CSR attention kernel
    (ops/gat.py), when the block covers the canonical GAT op chain.
Every other block — and every block on the ``xla`` path — lowers to XLA.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence

import jax
import jax.numpy as jnp

from .. import ir
from ..graph import GraphTensor, HostGraph, csr_graph
from ..ops import gat as gat_mod
from ..ops import spmm as spmm_mod
from .lower import _eval_op
from . import schedule as S
from .schedule import Schedule, TileConfig

# bump when kernel implementations change: memoised tuner latencies are
# keyed on (KERNEL_VERSION, device kind, schedule) so stale measurements
# never resurface
KERNEL_VERSION = 10  # v10: CSR kernels (Triton route) replace the tiled family


@dataclasses.dataclass
class _SpmmPlan:
    in_op: int              # external producer (or X_INPUT) feeding the scatter
    out_op: int             # the gather op id (block output)
    weighted: bool          # True if the apply_edge MUL edge_weight is inside
    mean: bool = False      # gather MEAN: segment-sum kernel + 1/in-degree
                            # post-scale (SAGE-mean aggregation)


def match_spmm(graph: ir.OpGraph, block: Sequence[int]) -> Optional[_SpmmPlan]:
    ops = [graph.by_id[o] for o in block]
    kinds = sorted(op.kind for op in ops)
    if len(ops) == 3:
        if kinds != sorted([ir.SCATTER, ir.APPLY_EDGE, ir.GATHER]):
            return None
        sc = next(o for o in ops if o.kind == ir.SCATTER)
        ae = next(o for o in ops if o.kind == ir.APPLY_EDGE)
        ga = next(o for o in ops if o.kind == ir.GATHER)
        if ae.compute != ir.MUL or set(ae.inputs) != {sc.op_id, ir.EDGE_WEIGHT}:
            return None
        if ga.inputs != [ae.op_id]:
            return None
        weighted = True
    elif len(ops) == 2:
        if kinds != sorted([ir.SCATTER, ir.GATHER]):
            return None
        sc = next(o for o in ops if o.kind == ir.SCATTER)
        ga = next(o for o in ops if o.kind == ir.GATHER)
        if ga.inputs != [sc.op_id]:
            return None
        weighted = False
    else:
        return None
    if sc.order != "C" or sc.compute != ir.NONE:
        return None
    if ga.compute not in (ir.ADD, ir.MEAN) or ga.order != "R":
        return None
    if len(sc.inputs) != 1:
        return None
    return _SpmmPlan(in_op=sc.inputs[0], out_op=ga.op_id, weighted=weighted,
                     mean=ga.compute == ir.MEAN)


def classify_block(graph: ir.OpGraph, block, tc: TileConfig):
    """Which execution path a (block, TileConfig) pair lowers to:
    ``(kind, plan)`` with kind in {spmm, spmm_stream, spmm_densefull, gat,
    gat_stream, xla}.  Single source of truth shared by
    :func:`lower_schedule` and the latency model (compiler/latency.py) —
    the model must price what actually runs."""
    if not tc.kernel:
        return "xla", None
    spmm_plan = match_spmm(graph, block)
    gat_plan = (gat_mod.match_gat_block(graph, block)
                if spmm_plan is None else None)
    if tc.path == S.PATH_DENSEFULL:
        # full dense adjacency matmul — plain SpMM only
        return ("spmm_densefull", spmm_plan) if spmm_plan is not None \
            else ("xla", None)
    if tc.path == S.PATH_STREAM and (spmm_plan or gat_plan):
        return ("spmm_stream" if spmm_plan else "gat_stream",
                spmm_plan or gat_plan)
    if tc.path == S.PATH_CSR and spmm_plan is not None:
        return "spmm", spmm_plan
    if tc.path == S.PATH_CSR and gat_plan is not None:
        return "gat", gat_plan
    return "xla", None


def lower_schedule(
    graph: ir.OpGraph,
    schedule: Schedule,
    host_graph: HostGraph,
    compute_dtype=None,
    build_transpose: bool = False,
    graph_cache: Optional[Dict] = None,
) -> Callable[[Dict[str, jax.Array], GraphTensor, jax.Array], jax.Array]:
    """Lower ``graph`` under ``schedule`` to ``apply(params, g, x)``.

    Host-side: builds the CSR graphs the matched blocks need (one per
    weighting; static data, put on the device once).

    ``build_transpose``: also build the CSR of the TRANSPOSED graph so
    x-gradients run the same kernels (dx = Aᵀ ȳ).  Doubles the graph
    preprocessing and index memory; enable for training at scales where
    the XLA [E, F] backward would not fit.

    ``graph_cache``: share the CSR graphs across the layers of one model.
    """
    cache = graph_cache if graph_cache is not None else {}
    hg_t = perm_t = None
    if build_transpose:
        if "transpose" not in cache:
            from ..graph import transpose_host_graph
            hg_t_, perm_np = transpose_host_graph(host_graph)
            cache["transpose"] = (hg_t_, jnp.asarray(perm_np, jnp.int32))
        hg_t, perm_t = cache["transpose"]

    def get_csr(unit_weight: bool, transposed: bool = False):
        key = ("csr", unit_weight, transposed)
        if key not in cache:
            cache[key] = csr_graph(hg_t if transposed else host_graph,
                                   unit_weight=unit_weight)
        return cache[key]

    # --- match blocks at build time (dispatch: classify_block) -----------
    # plan tuples: (kind, block, tc, plan, graph_data)
    plans: List[tuple] = []
    for block, tc in zip(schedule.blocks, schedule.tiles):
        kind, plan = classify_block(graph, block, tc)
        data = None
        if kind == "spmm":
            uw = not plan.weighted
            data = (get_csr(uw),
                    get_csr(uw, True) if build_transpose else None)
        elif kind == "gat":
            data = (get_csr(True), get_csr(True, True)
                    if build_transpose else None,
                    perm_t if build_transpose else None)
        elif kind == "spmm_densefull":
            from ..graph import dense_adjacency, densefull_max_n
            if host_graph.n_node > densefull_max_n():
                kind, plan = "xla", None
            else:
                key = ("densefull", plan.weighted)
                if key not in cache:
                    cache[key] = jnp.asarray(dense_adjacency(
                        host_graph, weighted=plan.weighted))
                # jnp.dot is natively differentiable (dx = A^T ybar as a
                # second dense matmul) — no transposed build needed
                data = cache[key]
        plans.append((kind, block, tc, plan, data))

    outputs = list(graph.outputs)

    # gather MEAN blocks: the kernels compute the segment SUM; mean is a
    # 1/in-degree post-scale (matches primitives.gather_to_nodes MEAN, which
    # divides by the real incident-edge count)
    inv_deg = None
    if any(p[0] in ("spmm", "spmm_stream", "spmm_densefull")
           and getattr(p[3], "mean", False) for p in plans):
        import numpy as _np
        deg = _np.bincount(_np.asarray(host_graph.receivers),
                           minlength=host_graph.n_node + 1)[
                               : host_graph.n_node]
        inv_deg = jnp.asarray(
            1.0 / _np.maximum(deg, 1), jnp.float32)[:, None]

    # the per-plan graph data (CSR / dense arrays) can reach GBs on large
    # graphs: callers that jit the returned ``apply`` directly embed them as
    # HLO constants (fine at small scale, fatal past ~100 MB).
    # ``apply.captures`` + ``apply.inner`` expose them so harnesses
    # (utils/benchmark.time_apply, models/train) pass them as jit ARGUMENTS.
    captures = jax.device_put((tuple(p[4] for p in plans), inv_deg))

    def inner(params: Dict[str, jax.Array], g: GraphTensor, x: jax.Array,
              captures):
        datas, inv_deg = captures
        vals: Dict[int, jax.Array] = {}

        def seg_out(plan, y: jax.Array) -> jax.Array:
            if getattr(plan, "mean", False):
                return y * inv_deg.astype(y.dtype)
            return y

        def ref(i: int) -> jax.Array:
            if i == ir.X_INPUT:
                return x
            if i == ir.EDGE_WEIGHT:
                return g.edge_weight[:, None]
            return vals[i]

        def kin(v: jax.Array) -> jax.Array:
            # kernel inputs follow the compute dtype (bf16 halves the bytes
            # each gathered row moves)
            return v.astype(compute_dtype) if compute_dtype is not None else v

        for (kind, block, tc, plan, _), data in zip(plans, datas):
            if kind == "spmm":
                cg, cg_t = data
                vals[plan.out_op] = seg_out(
                    plan, spmm_mod.spmm(cg, kin(ref(plan.in_op)), cg_t))
            elif kind == "spmm_densefull":
                # data IS the dense [N_pad, N_pad] adjacency here
                v = kin(ref(plan.in_op))
                n = v.shape[0]
                vp = jnp.zeros((data.shape[1], v.shape[1]), v.dtype
                               ).at[:n].set(v)
                y = jnp.dot(data.astype(v.dtype), vp,
                            preferred_element_type=jnp.float32)[:n]
                vals[plan.out_op] = seg_out(plan, y)
            elif kind == "spmm_stream":
                from ..ops import chunked
                gw = g if plan.weighted else dataclasses.replace(
                    g, edge_weight=g.edge_mask.astype(jnp.float32))
                vals[plan.out_op] = seg_out(plan, chunked.spmm_chunked(
                    gw, kin(ref(plan.in_op)), chunk=tc.tile_edges * 2048))
            elif kind == "gat_stream":
                from ..ops import chunked
                vals[plan.out_op] = chunked.gat_chunked(
                    g,
                    kin(ref(plan.h_op)),
                    kin(ref(plan.asrc_op)),
                    kin(ref(plan.adst_op)),
                    negative_slope=plan.negative_slope,
                    chunk=tc.tile_edges * 2048,
                )
            elif kind == "gat":
                cg, cg_t, perm = data
                vals[plan.out_op] = gat_mod.gat_attention(
                    cg, kin(ref(plan.h_op)), ref(plan.asrc_op),
                    ref(plan.adst_op), negative_slope=plan.negative_slope,
                    cg_t=cg_t, perm_t=perm)
            else:
                for oid in block:
                    vals[oid] = _eval_op(graph.by_id[oid], vals, params, g,
                                         x, compute_dtype)
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    def apply(params: Dict[str, jax.Array], g: GraphTensor, x: jax.Array):
        return inner(params, g, x, captures)

    apply.inner = inner
    apply.captures = captures
    return apply
