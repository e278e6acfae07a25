"""The CSR kernels compiled for the GPU (Triton route), against the plain
references.  Marked ``gpu``: they skip on the CPU test backend and run on
the card (``GTA_TEST_GPU=1 python -m pytest tests -m gpu``; chip_smoke.py
runs them)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
    csr_graph, transpose_host_graph)
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import (
    backend, gat as A, spmm as S)

from test_csr_spmm import make_graph

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (GTA_TEST_GPU=1 on the card)")
    assert not backend.interpret_mode()


@pytest.mark.parametrize("width", [7, 128, 200])
def test_spmm_compiled(gpu, width):
    cg = csr_graph(make_graph("hub"), max_piece=16)
    x = jax.random.normal(jax.random.key(0), (64, width), jnp.bfloat16)
    np.testing.assert_allclose(np.asarray(jax.jit(S.spmm_raw)(cg, x)),
                               np.asarray(S.spmm_reference(cg, x)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("heads,d", [(1, 41), (4, 32)])
def test_gat_compiled_fwd_and_vjp(gpu, heads, d):
    hg = make_graph("hub")
    cg = csr_graph(hg, unit_weight=True, max_piece=16)
    hg_t, perm = transpose_host_graph(hg)
    kw = dict(cg_t=csr_graph(hg_t, unit_weight=True),
              perm_t=jnp.asarray(perm, jnp.int32))
    k = jax.random.split(jax.random.key(1), 3)
    h = jax.random.normal(k[0], (64, heads * d))
    a_s = jax.random.normal(k[1], (64, heads))
    a_d = jax.random.normal(k[2], (64, heads))
    f = lambda *v: jnp.sum(jnp.sin(A.gat_attention(cg, *v, **kw)))
    r = lambda *v: jnp.sum(jnp.sin(A.gat_reference(cg, *v)))
    with jax.default_matmul_precision("highest"):
        for got, want in zip(jax.jit(jax.grad(f, (0, 1, 2)))(h, a_s, a_d),
                             jax.jit(jax.grad(r, (0, 1, 2)))(h, a_s, a_d)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       rtol=1e-4, atol=1e-5)
