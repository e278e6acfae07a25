"""CSR SpMM kernel (ops/spmm.py) in interpret mode against the plain XLA
reference: weighted and unweighted sums, widths that are not a power of
two, bf16 and float32, hub rows split into pieces, empty rows, multi-edges
and padded edges; the head-blocked weights; the gradient rule against
autodiff of the reference, with and without the transposed CSR and under
jax.checkpoint."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
    csr_graph, csr_pieces, transpose_host_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import spmm as S

N = 64


def make_graph(kind: str, seed: int = 0):
    """Host graphs of the shapes the kernel must get right."""
    rng = np.random.default_rng(seed)
    e = 400
    s = rng.integers(0, N, e)
    r = rng.integers(0, N, e)
    if kind == "hub":            # one row far longer than a piece
        r[:250] = 5
    elif kind == "empty_rows":   # a third of the rows have no in-edges
        r = rng.integers(0, N // 3, e) * 3
    elif kind == "multi":        # every edge three times
        s, r = np.tile(s[:130], 3), np.tile(r[:130], 3)
    return gta.build_host_graph(s, r, N, symmetric_norm=True,
                                edge_pad_multiple=512)


KINDS = ("random", "hub", "empty_rows", "multi")


def _tol(dtype):
    # same inputs on both sides, float32 accumulation, another order
    return dict(rtol=1e-5, atol=1e-5) if dtype == jnp.float32 else dict(
        rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("width", [7, 128, 200])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("unit", [False, True], ids=["weighted", "unit"])
def test_spmm_matches_reference(kind, width, dtype, unit):
    hg = make_graph(kind)
    cg = csr_graph(hg, unit_weight=unit, max_piece=16)
    x = jax.random.normal(jax.random.key(width), (N, width), dtype)
    y = S.spmm_raw(cg, x)
    assert y.shape == (N, width) and y.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(y),
                               np.asarray(S.spmm_reference(cg, x)),
                               **_tol(dtype))


@pytest.mark.parametrize("max_piece", [1, 3, 16, 1024])
def test_piece_table_covers_every_edge_once(max_piece):
    hg = make_graph("hub")
    start, end, row = csr_pieces(hg, max_piece)
    assert (end - start <= max_piece).all() and (end >= start).all()
    # every real edge in exactly one piece of its own receiver row
    owner = np.full(hg.e_pad, -1)
    for a, b, rr in zip(start, end, row):
        assert (owner[a:b] == -1).all()
        owner[a:b] = rr
    np.testing.assert_array_equal(owner[: hg.n_edge],
                                  hg.receivers[: hg.n_edge])
    assert (owner[hg.n_edge:] == -1).all()      # padded edges: no piece
    assert set(row) == set(range(N))           # empty rows get a piece
    assert (np.diff(row) >= 0).all()


def test_piece_table_padding_goes_to_dump_row():
    hg = make_graph("random")
    start, end, row = csr_pieces(hg, 1024, n_pieces=N + 5)
    assert (row[N:] == N).all() and (start[N:] == end[N:]).all()
    cg = csr_graph(hg, n_pieces=N + 5)
    assert cg.split
    x = jnp.ones((N, 4))
    np.testing.assert_allclose(np.asarray(S.spmm_raw(cg, x)),
                               np.asarray(S.spmm_reference(cg, x)),
                               rtol=1e-5, atol=1e-5)


def test_unsplit_graph_needs_no_combine():
    hg = make_graph("random")
    cg = csr_graph(hg)                      # degrees below MAX_PIECE
    assert not cg.split and cg.n_pieces == N


@pytest.mark.parametrize("heads,d", [(2, 3), (4, 16), (8, 5)])
def test_spmm_head_blocked_weights(heads, d):
    hg = make_graph("hub")
    cg = csr_graph(hg, max_piece=16)
    x = jax.random.normal(jax.random.key(0), (N, heads * d))
    w = jax.random.normal(jax.random.key(1), (hg.e_pad, heads))
    y = S.spmm_raw(cg, x, w, heads=heads)
    ref = jnp.concatenate(
        [S.spmm_reference(cg, x[:, k * d:(k + 1) * d], w[:, k])
         for k in range(heads)], axis=1)
    np.testing.assert_allclose(np.asarray(y), np.asarray(ref),
                               rtol=1e-5, atol=1e-5)


def test_pad_heads_roundtrip():
    x = jnp.arange(2 * 12, dtype=jnp.float32).reshape(2, 12)
    p = S.pad_heads(x, 4, 4)
    assert p.shape == (2, 16)
    np.testing.assert_array_equal(np.asarray(S.unpad_heads(p, 4, 3)),
                                  np.asarray(x))


def _grads(cg, cg_t, x, remat=False):
    f = lambda v: S.spmm(cg, v, cg_t)
    if remat:
        f = jax.checkpoint(f)
    loss = lambda v: jnp.sum(jnp.sin(f(v)))
    ref = lambda v: jnp.sum(jnp.sin(S.spmm_reference(cg, v)))
    return jax.grad(loss)(x), jax.grad(ref)(x)


@pytest.mark.parametrize("kind", ["hub", "multi"])
@pytest.mark.parametrize("transposed", [True, False],
                         ids=["kernel_bwd", "xla_bwd"])
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_spmm_vjp_matches_autodiff(kind, transposed, remat):
    hg = make_graph(kind)
    cg = csr_graph(hg, max_piece=16)
    cg_t = csr_graph(transpose_host_graph(hg)[0]) if transposed else None
    x = jax.random.normal(jax.random.key(3), (N, 24))
    got, want = _grads(cg, cg_t, x, remat)
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_spmm_vjp_bf16_input():
    hg = make_graph("hub")
    cg = csr_graph(hg, max_piece=16)
    cg_t = csr_graph(transpose_host_graph(hg)[0])
    x = jax.random.normal(jax.random.key(4), (N, 16), jnp.bfloat16)
    got, want = _grads(cg, cg_t, x)
    assert got.dtype == jnp.bfloat16
    # the kernel rounds the cotangent to bf16 before gathering it
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               rtol=2e-2, atol=2e-2)
