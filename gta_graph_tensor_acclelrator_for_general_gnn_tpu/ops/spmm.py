"""CSR SpMM: weighted neighbourhood aggregation as one Pallas kernel,
compiled for the GPU through Pallas' Triton route.

    y[r] = sum over edges e with dst_e = r of  w_e * x[src_e]

This is the aggregation of GCN/SGC/GraphSAGE/GIN/DGN and, on the transposed
graph, the input gradient of every one of them (dx = Aᵀ ȳ).  XLA's plain
version (``take`` + ``segment_sum``, ops/primitives.py) writes an [E, F]
tensor of gathered rows and reads it back — 29 GB per tensor in bf16 at
Reddit's 114.6M edges and F=128.  The kernel reads each gathered row once
and writes each output row once:

    grid (piece p, feature block c):
        acc[FB] = 0                                  (float32, registers)
        for each chunk of K edges of piece p (the last one masked):
            ids = senders[chunk]; w = weight[chunk]
            acc += sum_k w_k * x[ids_k, c*FB : (c+1)*FB]
        out[p, c*FB : (c+1)*FB] = acc

A piece is a run of at most ``graph.MAX_PIECE`` in-edges of one row
(:class:`~..graph.CsrGraph`), so a power-law hub spreads over many programs
instead of serialising one.  Rows cut into several pieces are combined by
one sorted segment sum over ``piece_row`` — a second, deterministic pass
instead of atomics, whose cost is a read of the [P, F] partials.

Head-blocked weights: ``w`` may be [E, H] with x laid out per head; feature
block c then reads weight column c // (blocks per head).  The GAT backward
uses this for dh = Aᵀ(α ⊙ ḡ) with per-head α.

Gradient (:func:`spmm`): a custom VJP whose dx runs the same kernel on the
transposed CSR (``graph.transpose_host_graph``) when one is given; without
it, the XLA segment-op transpose (which materialises [E, F], so only for
graphs where that fits).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..graph import CsrGraph
from .backend import interpret_mode, pad_rows, pow2_at_least, zero_cotangent


@dataclasses.dataclass(frozen=True)
class Launch:
    """Launch parameters of the CSR kernels: edges per chunk (K), the
    widest feature block (FB), Triton warps and pipeline stages."""
    edge_chunk: int = 64
    feat_block: int = 128
    num_warps: int = 2
    num_stages: int = 2


# Chosen by scripts/kernel_timing.py --sweep at the Reddit shapes on an
# H100 (400 W limit), over K in {16..256} x warps in {1, 2, 4, 8} (the
# pairs PERF.md lists): 64 edges per chunk with 2 warps.  One warp ran K=64
# 8% faster but collapses at K >= 128; two warps hold across K.
LAUNCH = Launch()


def _spmm_kernel(ps_ref, pe_ref, snd_ref, w_ref, x_ref, o_ref, *,
                 K: int, FB: int, blocks_per_head: int, n_edges: int):
    p = pl.program_id(0)
    c = pl.program_id(1)
    start = ps_ref[p]
    end = pe_ref[p]
    cols = c * FB + jnp.arange(FB)
    head = c // blocks_per_head

    def body(i, acc):
        off = start + i * K + jnp.arange(K)
        m = off < end
        off = jnp.minimum(off, n_edges - 1)
        ids = plgpu.load(snd_ref.at[off], mask=m, other=0)
        xs = plgpu.load(x_ref.at[ids[:, None], cols[None, :]],
                        mask=m[:, None], other=0).astype(jnp.float32)
        w = plgpu.load(w_ref.at[off, head], mask=m, other=0.0)
        return acc + jnp.sum(xs * w[:, None], axis=0)

    n_chunks = (end - start + K - 1) // K
    acc = lax.fori_loop(0, n_chunks, body, jnp.zeros((FB,), jnp.float32))
    o_ref[p, pl.ds(c * FB, FB)] = acc


def _head_layout(F: int, heads: int, feat_block: int):
    """(per-head padded width DB, feature block FB) of an [N, F] operand
    split into ``heads`` equal column groups."""
    if F % heads:
        raise ValueError(f"width {F} is not a multiple of {heads} heads")
    db = pow2_at_least(F // heads)
    fb = min(db, feat_block)
    return db, fb


def pad_heads(x: jax.Array, heads: int, db: int) -> jax.Array:
    """[N, H*D] -> [N, H*DB]: each head's columns zero-padded to DB."""
    n, f = x.shape
    d = f // heads
    if d == db:
        return x
    x3 = x.reshape(n, heads, d)
    return jnp.pad(x3, ((0, 0), (0, 0), (0, db - d))).reshape(n, heads * db)


def unpad_heads(y: jax.Array, heads: int, d: int) -> jax.Array:
    """Inverse of :func:`pad_heads`."""
    n, f = y.shape
    db = f // heads
    if d == db:
        return y
    return y.reshape(n, heads, db)[:, :, :d].reshape(n, heads * d)


def combine_pieces(cg: CsrGraph, parts: jax.Array) -> jax.Array:
    """Per-piece partial rows [P, ...] -> per-row [n_node, ...]."""
    if not cg.split:
        return parts
    return jax.ops.segment_sum(parts, cg.piece_row, cg.n_node + 1,
                               indices_are_sorted=True)[: cg.n_node]


def spmm_raw(cg: CsrGraph, x: jax.Array, w: Optional[jax.Array] = None, *,
             heads: int = 1, launch: Launch = LAUNCH) -> jax.Array:
    """The CSR kernel: float32 [n_node, F] aggregation of ``x`` [N, F].

    ``w``: per-edge weights [E_pad] or, with ``heads`` > 1, [E_pad, heads]
    (one column per head of x's columns); None uses ``cg.weight``.  x must
    hold every real sender row (padded edges are never visited)."""
    F = x.shape[1]
    if heads > 1:
        db, fb = _head_layout(F, heads, launch.feat_block)
        xp = pad_heads(x, heads, db)
        blocks_per_head = db // fb
    else:
        fb = min(pow2_at_least(F), launch.feat_block)
        fp = -(-F // fb) * fb
        xp = x if fp == F else jnp.pad(x, ((0, 0), (0, fp - F)))
        blocks_per_head = fp // fb
    n_blocks = xp.shape[1] // fb
    if w is None:
        w = cg.weight
    w2 = w.reshape(w.shape[0], -1).astype(jnp.float32)
    kernel = functools.partial(
        _spmm_kernel, K=launch.edge_chunk, FB=fb,
        blocks_per_head=blocks_per_head, n_edges=int(cg.senders.shape[0]))
    parts = pl.pallas_call(
        kernel,
        grid=(cg.n_pieces, n_blocks),
        out_shape=jax.ShapeDtypeStruct((cg.n_pieces, xp.shape[1]),
                                       jnp.float32),
        compiler_params=plgpu.CompilerParams(
            num_warps=launch.num_warps, num_stages=launch.num_stages),
        backend="triton",
        interpret=interpret_mode(),
        name="gta_csr_spmm",
    )(cg.piece_start, cg.piece_end, cg.senders, w2, xp)
    y = combine_pieces(cg, parts)
    if heads > 1:
        return unpad_heads(y, heads, F // heads)
    return y[:, :F]


def spmm_reference(cg: CsrGraph, x: jax.Array,
                   w: Optional[jax.Array] = None) -> jax.Array:
    """Plain XLA formulation of :func:`spmm_raw` (heads = 1): gather,
    scale, sorted segment sum — the oracle of the kernel tests."""
    w = cg.weight if w is None else w
    msg = jnp.take(pad_rows(x.astype(jnp.float32)), cg.senders, axis=0,
                   mode="clip")
    msg = msg * w.astype(jnp.float32)[:, None]
    return jax.ops.segment_sum(msg, cg.receivers, cg.n_node + 1,
                               indices_are_sorted=True)[: cg.n_node]


@jax.custom_vjp
def _spmm(cg: CsrGraph, cg_t: Optional[CsrGraph], x: jax.Array):
    return spmm_raw(cg, x)


def _spmm_fwd(cg, cg_t, x):
    # the zero-size array carries x's dtype into the backward
    return spmm_raw(cg, x), (cg, cg_t, jnp.zeros((0,), x.dtype))


def _spmm_bwd(res, ybar):
    cg, cg_t, xdt = res
    if cg_t is not None:
        dx = spmm_raw(cg_t, ybar.astype(xdt.dtype))
    else:
        msg = jnp.take(pad_rows(ybar.astype(jnp.float32)), cg.receivers,
                       axis=0) * cg.weight[:, None]
        dx = jax.ops.segment_sum(msg, cg.senders,
                                 cg.n_node + 1)[: cg.n_node]
    return (zero_cotangent(cg),
            None if cg_t is None else zero_cotangent(cg_t),
            dx.astype(xdt.dtype))


_spmm.defvjp(_spmm_fwd, _spmm_bwd)


def spmm(cg: CsrGraph, x: jax.Array,
         cg_t: Optional[CsrGraph] = None) -> jax.Array:
    """Differentiable CSR aggregation, float32 [n_node, F].  ``cg_t`` (the
    CSR of the transposed graph, same weights) lets dx run the kernel too."""
    return _spmm(cg, cg_t, x)
