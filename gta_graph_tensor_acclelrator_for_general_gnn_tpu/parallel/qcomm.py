"""Quantized boundary-feature exchange: int8 payloads on the wire.

The halo of a 1-D partition of the Reddit-scale graph is saturated:
every shard pair's boundary covers nearly all of n_local
(PartitionedGraph.comm_report), and community packing does not shrink
it — the remaining lever on exchange bytes is the per-element width.  These wrappers transmit the halo as
symmetric per-row int8 (one f32 scale per boundary row, F/2 + 4 bytes
per bf16 row ≈ a 2x cut; 4x from f32), dequantizing on arrival.

Gradient semantics: straight-through.  ``all_to_all`` (equal splits on
one axis) is its own adjoint — a block permutation — so the backward
pass runs the SAME quantized exchange on the cotangents (the gradient
halo also rides int8; both directions of the link traffic halve).  The
round() itself uses the straight-through estimator, standard for
quantized training: the quantization noise (<= 0.8% of the per-row max
per element) is treated as additive noise, not differentiated through.
``all_gather``'s adjoint is a reduce-scatter SUM, which cannot sum
payloads carrying different scales in-network, so the hub path
quantizes the forward only and keeps the (small next to the halo)
cotangent reduction in the compute dtype.

The reference has no distributed execution at all (SURVEY §2); the
design follows standard quantized-allreduce practice from distributed
training systems, applied to the halo-exchange pattern.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def _quantize(v):
    """Per-row symmetric int8: (q, scale) with v ≈ q * scale / 127."""
    s = jnp.max(jnp.abs(v.astype(jnp.float32)), axis=-1, keepdims=True)
    q = jnp.round(v.astype(jnp.float32) / jnp.maximum(s, 1e-30) * 127.0)
    return q.astype(jnp.int8), s


def _dequantize(q, s, dtype):
    return (q.astype(jnp.float32) * (s / 127.0)).astype(dtype)


@functools.lru_cache(maxsize=None)
def _q8_all_to_all_fn(axis):
    def roundtrip(v):
        q, s = _quantize(v)
        qx = jax.lax.all_to_all(q, axis, split_axis=0, concat_axis=0)
        sx = jax.lax.all_to_all(s, axis, split_axis=0, concat_axis=0)
        return _dequantize(qx, sx, v.dtype)

    @jax.custom_vjp
    def f(v):
        return roundtrip(v)

    def fwd(v):
        return roundtrip(v), ()

    def bwd(_, g):
        # all_to_all with equal splits is a block permutation == its own
        # adjoint: the cotangent exchange is the same quantized collective
        return (roundtrip(g),)

    f.defvjp(fwd, bwd)
    return f


def q8_all_to_all(v, axis):
    """int8-quantized ``all_to_all(v, axis, 0, 0)`` with a quantized
    cotangent exchange (straight-through)."""
    return _q8_all_to_all_fn(axis)(v)


@functools.lru_cache(maxsize=None)
def _q8_all_gather_fn(axis):
    def fwd_val(v):
        q, s = _quantize(v)
        qx = jax.lax.all_gather(q, axis)
        sx = jax.lax.all_gather(s, axis)
        return _dequantize(qx, sx, v.dtype)

    @jax.custom_vjp
    def f(v):
        return fwd_val(v)

    def fwd(v):
        return fwd_val(v), ()

    def bwd(_, g):
        # adjoint of all_gather = reduce-scatter sum: summing differently
        # scaled int8 payloads in-network is ill-defined, so the (hub-
        # sized, small) cotangent reduction stays unquantized
        return (jax.lax.psum_scatter(g, axis, scatter_dimension=0,
                                     tiled=False),)

    f.defvjp(fwd, bwd)
    return f


def q8_all_gather(v, axis):
    """int8-quantized ``all_gather(v, axis)`` (forward payload only; the
    cotangent reduce-scatter stays full precision — see module doc)."""
    return _q8_all_gather_fn(axis)(v)
