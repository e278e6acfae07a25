"""GAT attention: the whole edge-softmax aggregation as one Pallas kernel,
compiled for the GPU through Pallas' Triton route.

The reference expresses GAT attention as 14 ops (scatters, add, LeakyReLU,
segment-max, sub, exp, segment-sum, div, mul, segment-sum —
vTCAD/GraphOP/genGraphOP.py:47-77).  XLA's plain version materialises
several [E, H] and [E, HD] edge tensors.  The kernel walks each
destination row's in-edges once, with the same CSR traversal as the SpMM
(ops/spmm.py), and keeps every per-edge quantity in registers:

    grid (piece p of row r, head k):
        num[DB] = 0; den = 0                          (float32)
        for each chunk of K edges of piece p (the last one masked):
            ids = senders[chunk]
            z   = leaky(a_src[ids, k] + a_dst[r, k])
            pz  = exp(z - b[r, k])                    (<= 1)
            num += sum_e pz_e * h[ids_e, head k columns]
            den += sum_e pz_e
        out[p] = num; den_out[p, k] = den

Shift bound: b[r] = leaky(max_s a_src + a_dst[r]) dominates every logit of
row r (softmax is shift-invariant and leaky_relu monotone), so one pass
needs no running-max rescale, and partials of one row taken in several
pieces — or on several devices (parallel/dist.py) — add exactly.  The
per-row normalisation num / den is one XLA elementwise pass.

Bound domain: the shift is the GLOBAL per-head max of a_src, so a row whose
incident sources all sit more than ~85 below that max (f32 exp underflow)
collapses to zero attention.  The gap equals the spread of a_src across the
graph — O(1..10) for trained GATs; :func:`gat_shift_gap` measures it, and
inputs needing more should use the XLA path (exact per-row segment max, the
reference's gather-MAX op).

Both reference GAT variants (normalise-on-edges, genGraphOP.py:47-62, and
the aggregate-num/den 'trans' variant :64-77) compute this result, so one
kernel serves both op-graph shapes.

Gradient: a custom VJP in XLA at [E, H] width (never [E, HD]):

    α_e     = pz_e / den[dst]           (the forward's own weights)
    t_e     = <ḡ[dst], h[src]> per head (chunked over edges)
    dz_e    = α_e (t_e − <ḡ[dst], out[dst]>) · leaky'(a_s[src] + a_d[dst])
    da_dst  = Σ_{dst} dz ; da_src = Σ_{src} dz
    dh[s]   = Σ_{src = s} α_e ḡ[dst]    (the CSR SpMM kernel on the
                                         transposed graph, per-head α)
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import ir
from ..graph import CsrGraph
from .backend import interpret_mode, pad_rows, pow2_at_least, zero_cotangent
from .spmm import Launch, combine_pieces, pad_heads, spmm_raw, unpad_heads

NEG = -1e30

# Chosen by scripts/kernel_timing.py --sweep at the Reddit shapes (H=4,
# width 128) on an H100 (400 W limit), over the same K x warps pairs as the
# SpMM (PERF.md): 128 edges per chunk with 2 warps, within 9% of the
# fastest pair (K=64, one warp) and clear of one warp's collapse in the
# SpMM.  One program covers one head's 32 columns, so it takes longer
# chunks than the SpMM.
GAT_LAUNCH = Launch(edge_chunk=128, num_warps=2)


def _leaky(v, slope: float):
    return jnp.where(v >= 0, v, slope * v)


def _gat_kernel(ps_ref, pe_ref, pr_ref, snd_ref, as_ref, ad_ref, b_ref,
                h_ref, num_ref, den_ref, *, K: int, DB: int, slope: float,
                n_edges: int):
    p = pl.program_id(0)
    k = pl.program_id(1)
    start = ps_ref[p]
    end = pe_ref[p]
    r = pr_ref[p]
    a_d = ad_ref[r, k]
    bound = b_ref[r, k]
    cols = k * DB + jnp.arange(DB)

    def body(i, carry):
        num, den = carry
        off = start + i * K + jnp.arange(K)
        m = off < end
        off = jnp.minimum(off, n_edges - 1)
        ids = plgpu.load(snd_ref.at[off], mask=m, other=0)
        a_s = plgpu.load(as_ref.at[ids, k], mask=m, other=0.0)
        z = _leaky(a_s + a_d, slope)
        pz = jnp.where(m, jnp.exp(z - bound), 0.0)
        hs = plgpu.load(h_ref.at[ids[:, None], cols[None, :]],
                        mask=m[:, None], other=0).astype(jnp.float32)
        return num + jnp.sum(hs * pz[:, None], axis=0), den + jnp.sum(pz)

    n_chunks = (end - start + K - 1) // K
    num, den = lax.fori_loop(
        0, n_chunks, body,
        (jnp.zeros((DB,), jnp.float32), jnp.zeros((), jnp.float32)))
    num_ref[p, pl.ds(k * DB, DB)] = num
    den_ref[p, k] = den


def gat_partials(cg: CsrGraph, h: jax.Array, a_src: jax.Array,
                 a_dst: jax.Array, msrc: jax.Array, *,
                 negative_slope: float = 0.2,
                 launch: Launch = GAT_LAUNCH):
    """Unnormalised attention partials of every row under the shift bound
    b = leaky(msrc + a_dst): ``(num [n_node, HD], den [n_node, H])``, both
    float32.  ``msrc`` [1, H] must dominate a_src over every sender
    (the global max; a mesh-wide max when partials of several devices add).
    h / a_src need every real sender row; a_dst has n_node rows."""
    H = a_src.shape[1]
    HD = h.shape[1]
    D = HD // H
    DB = pow2_at_least(D)
    f32 = jnp.float32
    hp = pad_heads(h, H, DB)
    bound = _leaky(msrc.astype(f32) + a_dst.astype(f32), negative_slope)
    kernel = functools.partial(
        _gat_kernel, K=launch.edge_chunk, DB=DB,
        slope=float(negative_slope), n_edges=int(cg.senders.shape[0]))
    num, den = pl.pallas_call(
        kernel,
        grid=(cg.n_pieces, H),
        out_shape=(jax.ShapeDtypeStruct((cg.n_pieces, H * DB), f32),
                   jax.ShapeDtypeStruct((cg.n_pieces, H), f32)),
        compiler_params=plgpu.CompilerParams(
            num_warps=launch.num_warps, num_stages=launch.num_stages),
        backend="triton",
        interpret=interpret_mode(),
        name="gta_csr_gat",
    )(cg.piece_start, cg.piece_end, cg.piece_row, cg.senders,
      a_src.astype(f32), pad_rows(a_dst.astype(f32)), pad_rows(bound), hp)
    num = combine_pieces(cg, num)
    den = combine_pieces(cg, den)
    return unpad_heads(num, H, D), den


def _normalise(num, den, D):
    return num / jnp.repeat(jnp.maximum(den, 1e-20), D, axis=1)


def _global_msrc(a_src):
    return jnp.max(lax.stop_gradient(a_src).astype(jnp.float32), axis=0,
                   keepdims=True)


def _edge_dots(h, gbar, src, dst, heads: int,
               chunk: int = 1 << 22) -> jax.Array:
    """t[e, k] = <gbar[dst_e], h[src_e]> over head k's columns, float32
    [E, H]; edge chunks bound the gathered rows XLA may hold at once."""
    f32 = jnp.float32
    e = src.shape[0]
    d = h.shape[1] // heads
    chunk = min(chunk, e)
    n_chunks = -(-e // chunk)
    pad = n_chunks * chunk - e
    hp = pad_rows(h)
    gp = pad_rows(gbar.astype(h.dtype))
    dump = hp.shape[0] - 1
    src_c = jnp.pad(src, (0, pad), constant_values=dump).reshape(n_chunks, -1)
    dst_c = jnp.pad(dst, (0, pad), constant_values=dump).reshape(n_chunks, -1)

    def one(sd):
        s, t = sd
        prod = (jnp.take(hp, s, axis=0).astype(f32)
                * jnp.take(gp, t, axis=0).astype(f32))
        return jnp.sum(prod.reshape(-1, heads, d), axis=-1)

    return lax.map(one, (src_c, dst_c)).reshape(-1, heads)[:e]


def _gat_bwd(cg, cg_t, perm_t, h, a_s, a_d, msrc, out, den, gbar, slope):
    n = cg.n_node
    H = a_s.shape[1]
    HD = h.shape[1]
    D = HD // H
    f32 = jnp.float32
    src, dst = cg.senders, cg.receivers
    real = (dst < n)[:, None]
    lraw = (jnp.take(pad_rows(a_s.astype(f32)), src, axis=0, mode="clip")
            + jnp.take(pad_rows(a_d.astype(f32)), dst, axis=0, mode="clip"))
    bound = _leaky(msrc + a_d.astype(f32), slope)
    pz = jnp.exp(_leaky(lraw, slope)
                 - jnp.take(pad_rows(bound), dst, axis=0, mode="clip"))
    inv_den = 1.0 / jnp.maximum(den, 1e-20)
    alpha = jnp.where(
        real, pz * jnp.take(pad_rows(inv_den), dst, axis=0, mode="clip"),
        0.0)
    gb = gbar.astype(f32)
    t = _edge_dots(h, gb, src, dst, H)
    s2 = jnp.sum((gb * out).reshape(n, H, D), axis=-1)
    dl = alpha * (t - jnp.take(pad_rows(s2), dst, axis=0, mode="clip"))
    dz = dl * jnp.where(lraw >= 0, 1.0, slope)
    dad = jax.ops.segment_sum(dz, dst, n + 1, indices_are_sorted=True)[:n]
    das = jax.ops.segment_sum(dz, src, n + 1)[:n]
    if cg_t is not None:
        dh = spmm_raw(cg_t, gbar.astype(h.dtype),
                      jnp.take(alpha, perm_t, axis=0), heads=H)
    else:
        msg = (jnp.repeat(alpha, D, axis=1)
               * jnp.take(pad_rows(gb), dst, axis=0, mode="clip"))
        dh = jax.ops.segment_sum(msg, src, n + 1)[:n]
    return dh.astype(h.dtype), das.astype(a_s.dtype), dad.astype(a_d.dtype)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _gat(slope, cg, cg_t, perm_t, h, a_s, a_d):
    num, den = gat_partials(cg, h, a_s, a_d, _global_msrc(a_s),
                            negative_slope=slope)
    return _normalise(num, den, h.shape[1] // a_s.shape[1])


def _gat_fwd(slope, cg, cg_t, perm_t, h, a_s, a_d):
    msrc = _global_msrc(a_s)
    num, den = gat_partials(cg, h, a_s, a_d, msrc, negative_slope=slope)
    out = _normalise(num, den, h.shape[1] // a_s.shape[1])
    return out, (cg, cg_t, perm_t, h, a_s, a_d, msrc, out, den)


def _gat_bwd_rule(slope, res, gbar):
    cg, cg_t, perm_t, h, a_s, a_d, msrc, out, den = res
    dh, das, dad = _gat_bwd(cg, cg_t, perm_t, h, a_s, a_d, msrc, out, den,
                            gbar, slope)
    return (zero_cotangent(cg),
            None if cg_t is None else zero_cotangent(cg_t),
            None if perm_t is None else zero_cotangent(perm_t),
            dh, das, dad)


_gat.defvjp(_gat_fwd, _gat_bwd_rule)


def gat_attention(cg: CsrGraph, h: jax.Array, a_src: jax.Array,
                  a_dst: jax.Array, *, negative_slope: float = 0.2,
                  cg_t: Optional[CsrGraph] = None,
                  perm_t: Optional[jax.Array] = None) -> jax.Array:
    """Multi-head GAT edge-softmax + aggregation through the CSR kernel:
    h [N, HD], a_src [N, H], a_dst [N, H] -> float32 [N, HD].

    Differentiable.  With ``cg_t`` (unit-weight CSR of the transposed
    graph) and ``perm_t`` (``transpose_host_graph``'s edge permutation) dh
    runs the CSR SpMM kernel; without them it is an XLA segment sum that
    materialises [E, HD]."""
    if (cg_t is None) != (perm_t is None):
        raise ValueError("cg_t and perm_t go together")
    return _gat(float(negative_slope), cg, cg_t, perm_t, h, a_src, a_dst)


def gat_reference(cg: CsrGraph, h, a_src, a_dst,
                  negative_slope: float = 0.2) -> jax.Array:
    """Plain XLA edge softmax with the exact per-row segment max (the
    reference's gather-MAX formulation): the oracle of the kernel tests."""
    n = cg.n_node
    H = a_src.shape[1]
    D = h.shape[1] // H
    f32 = jnp.float32
    src, dst = cg.senders, cg.receivers
    real = (dst < n)[:, None]
    e = _leaky(jnp.take(pad_rows(a_src.astype(f32)), src, axis=0, mode="clip")
               + jnp.take(pad_rows(a_dst.astype(f32)), dst, axis=0,
                          mode="clip"), negative_slope)
    e = jnp.where(real, e, NEG)
    m = jax.ops.segment_max(e, dst, n + 1, indices_are_sorted=True)
    m = jnp.where(jnp.isfinite(m), m, 0.0)
    p = jnp.where(real, jnp.exp(e - jnp.take(m, dst, axis=0)), 0.0)
    den = jax.ops.segment_sum(p, dst, n + 1, indices_are_sorted=True)
    hs = jnp.take(pad_rows(h.astype(f32)), src, axis=0, mode="clip")
    num = jax.ops.segment_sum(jnp.repeat(p, D, axis=1) * hs, dst, n + 1,
                              indices_are_sorted=True)
    return _normalise(num, den, D)[:n]


# Shift-bound safety margin: rows whose incident a_src all sit further than
# this below the global per-head max would lose f32-exp precision under the
# shift-bound softmax (full underflow at ~88; we guard well before)
SHIFT_GAP_SAFE = 60.0


def gat_shift_gap(g, a_src: jax.Array) -> jax.Array:
    """Worst-case shift-bound gap of the GAT kernel: scalar ``max over
    rows/heads of (global max a_src − per-row max incident a_src)``.  Rows
    with gap > ~85 collapse to zero attention under the kernel's global
    shift (module docstring 'Bound domain').  Rows with no in-edges are
    excluded (their output is 0 either way)."""
    n = g.n_node
    src = jnp.where(g.edge_mask, g.senders, n)
    dst = jnp.where(g.edge_mask, g.receivers, n)
    a = a_src.astype(jnp.float32)
    a_se = jnp.take(pad_rows(a, NEG), src, axis=0)
    a_se = jnp.where(g.edge_mask[:, None], a_se, NEG)
    rowmax = jax.ops.segment_max(a_se, dst, n + 1,
                                 indices_are_sorted=True)[:n]
    msrc = jnp.max(a, axis=0)
    gap = jnp.where(rowmax > NEG / 2, msrc[None, :] - rowmax, 0.0)
    return jnp.max(gap)


@dataclasses.dataclass
class GatPlan:
    h_op: int
    asrc_op: int
    adst_op: int
    out_op: int
    heads: int
    negative_slope: float
    ops: frozenset           # exact op ids covered by the fused kernel


def match_gat_block(graph: ir.OpGraph, block: Sequence[int]) -> Optional[GatPlan]:
    """Match the canonical GAT attention chain (either reference variant)
    within ``block``.  Returns a plan only if the matched chain covers the
    block exactly (no stray ops that the kernel would silently drop).

    Chain: scatter(C) h / scatter(C) a_src / scatter(R) a_dst ->
    ADD -> SF(leaky_relu) -> gather MAX -> scatter R -> SUB -> SF(exp) ->
    then either {gather ADD den, scatter R, DIV, MUL h, gather ADD} (the
    normalise-on-edges variant, genGraphOP.py:47-62) or
    {MUL h, gather ADD num, gather ADD den, apply_node DIV} ('trans')."""
    plan = find_gat_chain(graph, block)
    if plan is None or plan.ops != frozenset(block):
        return None
    return plan


def find_gat_chain(
    graph: ir.OpGraph,
    within: Optional[Sequence[int]] = None,
) -> Optional[GatPlan]:
    """Find a GAT attention chain among ``within`` (default: all ops)."""
    ids = list(within) if within is not None else [op.op_id for op in graph.ops]
    B = {o: graph.by_id[o] for o in ids}

    def find(pred):
        return [o for o, op in B.items() if pred(op)]

    adds = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.ADD
                and len(op.inputs) == 2
                and all(i in B and B[i].kind == ir.SCATTER for i in op.inputs))
    for add in adds:
        s1, s2 = (B[i] for i in B[add].inputs)
        if {s1.order, s2.order} != {"R", "C"}:
            continue
        asrc_sc = s1 if s1.order == "C" else s2
        adst_sc = s1 if s1.order == "R" else s2
        sfs = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SF
                   and op.inputs == [add])
        if not sfs or B[sfs[0]].extra.get("sf") != "leaky_relu":
            continue
        lrelu = sfs[0]
        gmax = find(lambda op: op.kind == ir.GATHER and op.compute == ir.MAX
                    and op.inputs == [lrelu])
        if not gmax:
            continue
        mscat = find(lambda op: op.kind == ir.SCATTER and op.order == "R"
                     and op.inputs == gmax)
        if not mscat:
            continue
        subs = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SUB
                    and op.inputs == [lrelu, mscat[0]])
        if not subs:
            continue
        exps = find(lambda op: op.kind == ir.APPLY_EDGE and op.compute == ir.SF
                    and op.inputs == subs and op.extra.get("sf") == "exp")
        if not exps:
            continue
        expo = exps[0]
        h_cands = find(lambda op: op.kind == ir.SCATTER and op.order == "C"
                       and op.op_id != asrc_sc.op_id)
        for h_id in h_cands:
            h_sc = B[h_id]
            core = [asrc_sc.op_id, adst_sc.op_id, add, lrelu, gmax[0],
                    mscat[0], subs[0], expo, h_id]
            # variant A: den -> scatter -> DIV -> MUL h -> gather
            dens = find(lambda op: op.kind == ir.GATHER
                        and op.compute == ir.ADD and op.inputs == [expo])
            for den in dens:
                dscat = find(lambda op: op.kind == ir.SCATTER
                             and op.order == "R" and op.inputs == [den])
                if not dscat:
                    continue
                divs = find(lambda op: op.kind == ir.APPLY_EDGE
                            and op.compute == ir.DIV
                            and op.inputs == [expo, dscat[0]])
                if not divs:
                    continue
                muls = find(lambda op: op.kind == ir.APPLY_EDGE
                            and op.compute == ir.MUL
                            and sorted(op.inputs) == sorted([divs[0], h_id]))
                if not muls:
                    continue
                gsum = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == muls)
                if gsum:
                    return GatPlan(
                        h_op=h_sc.inputs[0],
                        asrc_op=asrc_sc.inputs[0],
                        adst_op=adst_sc.inputs[0],
                        out_op=gsum[0],
                        heads=asrc_sc.out_width,
                        negative_slope=B[lrelu].extra.get(
                            "negative_slope", 0.2),
                        ops=frozenset(core + [den, dscat[0], divs[0],
                                              muls[0], gsum[0]]),
                    )
            # variant B: MUL h -> gather num; gather den; node DIV
            muls = find(lambda op: op.kind == ir.APPLY_EDGE
                        and op.compute == ir.MUL
                        and sorted(op.inputs) == sorted([expo, h_id]))
            if muls:
                gnum = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == muls)
                gden = find(lambda op: op.kind == ir.GATHER
                            and op.compute == ir.ADD and op.inputs == [expo])
                if gnum and gden:
                    divs = find(lambda op: op.kind == ir.APPLY_NODE
                                and op.compute == ir.DIV
                                and op.inputs == [gnum[0], gden[0]])
                    if divs:
                        return GatPlan(
                            h_op=h_sc.inputs[0],
                            asrc_op=asrc_sc.inputs[0],
                            adst_op=adst_sc.inputs[0],
                            out_op=divs[0],
                            heads=asrc_sc.out_width,
                            negative_slope=B[lrelu].extra.get(
                                "negative_slope", 0.2),
                            ops=frozenset(core + [muls[0], gnum[0],
                                                  gden[0], divs[0]]),
                        )
    return None
