"""Chunked (edge-streaming) aggregation: the memory-bounded full-batch path.

At Reddit scale (114.6M edges — genGraphOP.py:196-199) a materialised
[E, F] edge tensor is ~58 GB at F=128: impossible on one chip.  The
reference never faces this because it only *simulates* execution; real
execution streams edges.  These ops lax.scan over fixed-size edge chunks —
per-chunk gather (take), transform, and sorted segment-sum into the [N, F]
accumulator — so peak memory is O(N*F + chunk*F) while XLA overlaps the
chunk gathers with compute.

GAT attention uses the same shift-bound softmax as the Pallas kernel
(ops/gat.py): subtract b[r] = leaky(max_s a_src + a_dst[r]) >= every logit
(per-row constant, softmax shift-invariant), so one den pass + one num pass
suffice — no materialised per-edge alpha, no third max pass.
"""
from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..graph import GraphTensor


def _pad_to_chunks(chunk: int, n_node: int, *arrays):
    """Pad 1-D edge arrays to a chunk multiple (indices -> dump row n_node,
    weights/masks -> 0) and reshape to [n_chunks, chunk]."""
    e_pad = int(arrays[0].shape[0])
    chunk = min(chunk, e_pad)
    total = -(-e_pad // chunk) * chunk
    out = []
    for a in arrays:
        fill = n_node if jnp.issubdtype(a.dtype, jnp.integer) else 0
        if total != e_pad:
            a = jnp.concatenate(
                [a, jnp.full((total - e_pad,), fill, a.dtype)])
        out.append(a.reshape(total // chunk, chunk))
    return out


def spmm_chunked(
    g: GraphTensor,
    x: jax.Array,
    *,
    chunk: int = 1 << 20,
    edge_vals: Optional[jax.Array] = None,
) -> jax.Array:
    """y[r] = sum over edges (s->r) of w_e * x[s], streaming edge chunks.

    x may be bf16 (accumulation is f32).  ``edge_vals`` [e_pad] multiplies
    the static edge weight (e.g. attention alphas).
    """
    f = x.shape[1]
    dump = jnp.zeros((1, f), x.dtype)
    xt = jnp.concatenate([x, dump], axis=0)

    w = g.edge_weight if edge_vals is None else g.edge_weight * edge_vals
    send, recv, w = _pad_to_chunks(chunk, g.n_node, g.senders, g.receivers, w)

    def body(acc, inputs):
        s, r, wc = inputs
        msg = jnp.take(xt, s, axis=0).astype(jnp.float32) * wc[:, None]
        acc = acc + jax.ops.segment_sum(
            msg, r, g.n_node + 1, indices_are_sorted=True)
        return acc, None

    acc0 = jnp.zeros((g.n_node + 1, f), jnp.float32)
    acc, _ = jax.lax.scan(body, acc0, (send, recv, w))
    return acc[: g.n_node]


@jax.custom_jvp
def _normalise(num: jax.Array, den: jax.Array) -> jax.Array:
    """num / den with the derivative (dnum - out * dden) / den.  Autodiff of
    the plain quotient forms 1 / den**2, which overflows float32 for the
    tiny den of rows whose logits all sit far below the shift bound (den
    < ~1e-19), and inf times their underflowed p then gives NaN."""
    return num / den


@_normalise.defjvp
def _normalise_jvp(primals, tangents):
    num, den = primals
    dnum, dden = tangents
    out = num / den
    return out, (dnum - out * dden) / den


def gat_chunked(
    g: GraphTensor,
    h_src: jax.Array,
    a_src: jax.Array,
    a_dst: jax.Array,
    *,
    negative_slope: float = 0.2,
    chunk: int = 1 << 20,
) -> jax.Array:
    """Full-batch GAT attention without materialising per-edge tensors.

    [N,HD],[N,H],[N,H] -> [N,HD]; two streaming passes (den, num) using the
    shift-bound softmax.  Exactly the math of ops/gat.py's kernel, scaled to
    graphs whose edge set exceeds HBM.
    """
    H = a_src.shape[1]
    HD = h_src.shape[1]
    D = HD // H

    dumpH = jnp.zeros((1, H), a_src.dtype)
    dumpHD = jnp.zeros((1, HD), h_src.dtype)
    asr = jnp.concatenate([a_src, dumpH], axis=0)
    ads = jnp.concatenate([a_dst, dumpH], axis=0)
    hs = jnp.concatenate([h_src, dumpHD], axis=0)
    msrc = jnp.max(a_src.astype(jnp.float32), axis=0)        # [H]

    send, recv, mask = _pad_to_chunks(
        chunk, g.n_node, g.senders, g.receivers, g.edge_mask)

    def leaky(v):
        return jnp.where(v >= 0, v, negative_slope * v)

    def p_of(s, r, m):
        a_s = jnp.take(asr, s, axis=0).astype(jnp.float32)
        a_d = jnp.take(ads, r, axis=0).astype(jnp.float32)
        e = leaky(a_s + a_d)
        bound = leaky(msrc[None, :] + a_d)
        return jnp.where(m[:, None], jnp.exp(e - bound), 0.0)  # [chunk, H]

    def den_body(acc, inputs):
        s, r, m = inputs
        acc = acc + jax.ops.segment_sum(
            p_of(s, r, m), r, g.n_node + 1, indices_are_sorted=True)
        return acc, None

    den, _ = jax.lax.scan(
        den_body, jnp.zeros((g.n_node + 1, H), jnp.float32),
        (send, recv, mask))

    def num_body(acc, inputs):
        s, r, m = inputs
        p = p_of(s, r, m)
        hsv = jnp.take(hs, s, axis=0).astype(jnp.float32)
        contrib = jnp.repeat(p, D, axis=1) * hsv
        acc = acc + jax.ops.segment_sum(
            contrib, r, g.n_node + 1, indices_are_sorted=True)
        return acc, None

    num, _ = jax.lax.scan(
        num_body, jnp.zeros((g.n_node + 1, HD), jnp.float32),
        (send, recv, mask))
    out = _normalise(num, jnp.repeat(jnp.maximum(den, 1e-20), D, axis=1))
    return out[: g.n_node]
