"""Benchmark lines on one GPU.

Three JSON lines, each naming the device it ran on (``platform``,
``device_kind``, device ``count``) and the card's name and power limit:

  gat_cora_layer3_latency  one GAT layer at the reference's layer-3 shape
                           (Cora, 64 -> 16, 16 heads; genGraphOP.py
                           weight_size) through ``lower_schedule`` on the
                           compile-only pick (compiler/latency.py), bf16.
  reddit_spmm_throughput   y = A x on the full-batch Reddit-scale graph
                           (232,965 nodes, 114.6M edges, F=128 bf16)
                           through the CSR SpMM kernel.
  reddit_gat_throughput    GAT attention (H=4, width 128) on the same graph
                           through the CSR attention kernel.

Times are medians of host-clock timings around ``block_until_ready``,
compilation excluded.  The script fails when JAX finds no GPU.
"""
import json
import sys
import time

REDDIT_EDGES = 114_615_892


def main():
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        sys.exit(f"bench: JAX found no GPU (backend {jax.default_backend()!r})")

    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.latency \
        import min_latency_schedule
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import community_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        csr_graph)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import (
        gat as gat_mod, spmm as spmm_mod)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.benchmark \
        import card_info, time_apply, time_fn

    dev = jax.devices()[0]
    common = dict(platform=dev.platform, device_kind=dev.device_kind,
                  count=len(jax.devices()), **card_info())

    def line(metric, value, unit, **kw):
        print(json.dumps(dict(metric=metric, value=value, unit=unit,
                              **common, **kw)), flush=True)

    ds = gta.load_dataset("cora")
    f = 64
    og = gta.build_op_graph("GAT", f, 16, heads=16, layer_tag="l3bench")
    params = gta.init_params(og, jax.random.key(0))
    x = jax.random.normal(jax.random.key(1), (ds.host_graph.n_node, f))
    sched, _ = min_latency_schedule(og, ds.host_graph, feat_width=f)
    fn = gta.lower_schedule(og, sched, ds.host_graph,
                            compute_dtype=jnp.bfloat16)
    t = time_apply(fn, params, ds.graph, x, iters=50)
    line("gat_cora_layer3_latency", t * 1e6, "us", schedule=sched.key())

    t0 = time.perf_counter()
    rd = community_dataset("reddit", seed=1)
    hg = rd.host_graph
    cg = csr_graph(hg)
    cu = csr_graph(hg, unit_weight=True)
    setup_s = time.perf_counter() - t0
    n = hg.n_node
    k = jax.random.split(jax.random.key(2), 3)
    xr = jax.random.normal(k[0], (n, 128), jnp.bfloat16)
    med, _ = time_fn(jax.jit(spmm_mod.spmm_raw), cg, xr, iters=10)
    line("reddit_spmm_throughput", hg.n_edge / med / 1e9, "Gedge/s",
         ms=med * 1e3, n_edge=hg.n_edge, setup_s=setup_s)
    a_s = jax.random.normal(k[1], (n, 4), jnp.float32)
    a_d = jax.random.normal(k[2], (n, 4), jnp.float32)
    med, _ = time_fn(jax.jit(gat_mod.gat_attention), cu, xr, a_s, a_d,
                     iters=10)
    line("reddit_gat_throughput", hg.n_edge / med / 1e9, "Gedge/s",
         ms=med * 1e3, n_edge=hg.n_edge, heads=4, width=128)


if __name__ == "__main__":
    main()
