"""CSR GAT attention kernel (ops/gat.py) in interpret mode against the
plain XLA edge softmax (exact per-row max): heads 1/4/8, head widths that
are not a power of two, bf16 and float32, hub rows split into pieces,
empty rows and multi-edges; the [E, H]-width gradient rule against
autodiff of the reference; the shift-bound domain check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
    csr_graph, transpose_host_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import gat as A

from test_csr_spmm import KINDS, N, make_graph


def _inputs(heads, d, dtype, seed=0):
    k = jax.random.split(jax.random.key(seed), 3)
    h = jax.random.normal(k[0], (N, heads * d), dtype)
    a_s = jax.random.normal(k[1], (N, heads))
    a_d = jax.random.normal(k[2], (N, heads))
    return h, a_s, a_d


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("heads,d", [(1, 7), (4, 8), (8, 3)])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_gat_matches_reference(kind, heads, d, dtype):
    cg = csr_graph(make_graph(kind), unit_weight=True, max_piece=16)
    h, a_s, a_d = _inputs(heads, d, dtype)
    y = A.gat_attention(cg, h, a_s, a_d)
    assert y.shape == (N, heads * d) and y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y),
                               np.asarray(A.gat_reference(cg, h, a_s, a_d)),
                               rtol=1e-5, atol=1e-5)


def test_gat_empty_rows_are_zero():
    cg = csr_graph(make_graph("empty_rows"), unit_weight=True)
    h, a_s, a_d = _inputs(4, 8, jnp.float32)
    y = np.asarray(A.gat_attention(cg, h, a_s, a_d))
    assert (y[1::3] == 0).all() and np.abs(y[::3]).sum() > 0


def test_gat_pieces_add_exactly():
    """The shift bound makes per-piece partials additive: a graph cut into
    one-edge pieces gives the row-at-once result."""
    hg = make_graph("hub")
    h, a_s, a_d = _inputs(4, 8, jnp.float32)
    one = A.gat_attention(csr_graph(hg, unit_weight=True, max_piece=1),
                          h, a_s, a_d)
    whole = A.gat_attention(csr_graph(hg, unit_weight=True), h, a_s, a_d)
    np.testing.assert_allclose(np.asarray(one), np.asarray(whole),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["hub", "multi"])
@pytest.mark.parametrize("heads", [1, 4])
@pytest.mark.parametrize("transposed", [True, False],
                         ids=["kernel_dh", "xla_dh"])
def test_gat_vjp_matches_autodiff(kind, heads, transposed):
    hg = make_graph(kind)
    cg = csr_graph(hg, unit_weight=True, max_piece=16)
    kw = {}
    if transposed:
        hg_t, perm = transpose_host_graph(hg)
        kw = dict(cg_t=csr_graph(hg_t, unit_weight=True),
                  perm_t=jnp.asarray(perm, jnp.int32))
    h, a_s, a_d = _inputs(heads, 6, jnp.float32, seed=2)
    f = lambda *v: jnp.sum(jnp.sin(A.gat_attention(cg, *v, **kw)))
    r = lambda *v: jnp.sum(jnp.sin(A.gat_reference(cg, *v)))
    for got, want in zip(jax.grad(f, (0, 1, 2))(h, a_s, a_d),
                         jax.grad(r, (0, 1, 2))(h, a_s, a_d)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("heads", [1, 4])
def test_gat_vjp_under_checkpoint(heads):
    hg = make_graph("hub")
    cg = csr_graph(hg, unit_weight=True, max_piece=16)
    hg_t, perm = transpose_host_graph(hg)
    cg_t = csr_graph(hg_t, unit_weight=True)
    perm = jnp.asarray(perm, jnp.int32)
    h, a_s, a_d = _inputs(heads, 5, jnp.float32, seed=3)
    f = jax.checkpoint(lambda *v: A.gat_attention(cg, *v, cg_t=cg_t,
                                                  perm_t=perm))
    got = jax.grad(lambda *v: jnp.sum(f(*v) ** 2), (0, 1, 2))(h, a_s, a_d)
    want = jax.grad(lambda *v: jnp.sum(A.gat_reference(cg, *v) ** 2),
                    (0, 1, 2))(h, a_s, a_d)
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)


def test_gat_transpose_arguments_go_together():
    cg = csr_graph(make_graph("random"), unit_weight=True)
    h, a_s, a_d = _inputs(1, 4, jnp.float32)
    with pytest.raises(ValueError):
        A.gat_attention(cg, h, a_s, a_d, cg_t=cg)


def test_gat_shift_gap_detects_adversarial():
    g = make_graph("random").to_device()
    a_s = jnp.zeros((N, 2)).at[7, 0].set(200.0)     # one huge source logit
    assert float(A.gat_shift_gap(g, a_s)) > A.SHIFT_GAP_SAFE
    benign = jax.random.normal(jax.random.key(0), (N, 2))
    assert float(A.gat_shift_gap(g, benign)) < A.SHIFT_GAP_SAFE


def test_gat_partials_share_a_mesh_bound():
    """Partials under a larger (mesh-wide) bound normalise to the same
    output: the bound only has to dominate."""
    cg = csr_graph(make_graph("random"), unit_weight=True)
    h, a_s, a_d = _inputs(4, 4, jnp.float32)
    base = A.gat_attention(cg, h, a_s, a_d)
    num, den = A.gat_partials(cg, h, a_s, a_d,
                              jnp.max(a_s, 0, keepdims=True) + 3.0)
    out = num / jnp.repeat(jnp.maximum(den, 1e-20), 4, axis=1)
    np.testing.assert_allclose(np.asarray(out), np.asarray(base),
                               rtol=1e-5, atol=1e-6)
