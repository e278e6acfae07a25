"""Keep-or-go timings of the CSR kernels against what XLA makes of the
plain version, at the full-batch Reddit shapes, on one GPU.

    python scripts/kernel_timing.py [--n-edge 114615892] [--sweep]
        [--out chiprun_out/kernel_timing.jsonl]

Prints one JSON line per measurement, each with the card's name and power
limit.  Times are medians of host-clock timings around
``block_until_ready`` (utils/benchmark.time_fn), compilation excluded.
A plain version that does not fit in the device's memory is reported as
``"oom"``.

Measurements:
  spmm      y = A x at F=128 bf16: CSR kernel, XLA take + segment_sum, and
            the library route (jax.experimental.sparse BCSR, float32).
  gat       H=4, total width 128: CSR kernel vs the XLA edge softmax
            written the kernel's way (bf16 rows gathered, float32
            weights, the same shift bound, no per-row max pass).
  *_vjp     forward + backward of each (the training direction).
  train     one full-batch training step of GCN (transform-first) and GAT
            through the CSR schedule and through the per-op XLA schedule.
  --sweep   the kernels' launch parameters (edges per chunk, warps).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-edge", type=int, default=114_615_892)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--out", default="chiprun_out/kernel_timing.jsonl")
    args = ap.parse_args()

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    import jax.numpy as jnp
    if jax.default_backend() != "gpu":
        sys.exit("kernel_timing: JAX found no GPU")

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import community_dataset
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        csr_graph, transpose_host_graph)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import (
        gat as gat_mod, spmm as spmm_mod)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.benchmark \
        import card_info, time_fn

    card = card_info()
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    sink = open(args.out, "a")

    def emit(**kw):
        line = json.dumps({**card, "n_edge_requested": args.n_edge, **kw})
        print(line, flush=True)
        sink.write(line + "\n")
        sink.flush()

    def timed(name, f, *a, iters=10):
        try:
            med, best = time_fn(jax.jit(f), *a, iters=iters)
            emit(what=name, median_ms=med * 1e3, best_ms=best * 1e3)
            return med
        except Exception as ex:  # noqa: BLE001 — an OOM is a result here
            msg = str(ex)
            emit(what=name, result=("oom" if "RESOURCE_EXHAUSTED" in msg
                                    else f"error: {msg[:300]}"))
            return None

    t0 = time.perf_counter()
    ds = community_dataset("reddit", n_edge=args.n_edge, seed=1)
    hg = ds.host_graph
    hg_t, perm = transpose_host_graph(hg)
    cg, cg_t = csr_graph(hg), csr_graph(hg_t)
    cu, cu_t = csr_graph(hg, unit_weight=True), csr_graph(
        hg_t, unit_weight=True)
    perm = jnp.asarray(perm, jnp.int32)
    emit(what="setup", seconds=time.perf_counter() - t0, n_node=hg.n_node,
         n_edge=hg.n_edge, pieces=cg.n_pieces, pieces_t=cg_t.n_pieces)

    n = hg.n_node
    k = jax.random.split(jax.random.key(0), 4)
    x = jax.random.normal(k[0], (n, 128), jnp.bfloat16)
    a_s = jax.random.normal(k[1], (n, 4), jnp.float32)
    a_d = jax.random.normal(k[2], (n, 4), jnp.float32)
    gbar = jax.random.normal(k[3], (n, 128), jnp.float32)

    def spmm_xla(c, v):
        msg = jnp.take(v, c.senders, axis=0, mode="clip") * c.weight[:, None]
        return jax.ops.segment_sum(msg, c.receivers, c.n_node + 1,
                                   indices_are_sorted=True)[: c.n_node]

    def gat_xla(c, hh, aa, bb, slope=0.2):
        f32 = jnp.float32
        heads = aa.shape[1]
        src, dst = c.senders, c.receivers
        real = (dst < n)[:, None]
        a_s = jnp.take(aa, src, axis=0, mode="clip")
        a_d = jnp.take(bb, dst, axis=0, mode="clip")
        bound = jnp.take(gat_mod._leaky(jnp.max(aa, 0) + bb, slope), dst,
                         axis=0, mode="clip")
        p = jnp.where(real, jnp.exp(gat_mod._leaky(a_s + a_d, slope) - bound),
                      0.0)
        hs = jnp.take(hh, src, axis=0, mode="clip").reshape(
            -1, heads, hh.shape[1] // heads)
        num = jax.ops.segment_sum((hs * p[:, :, None]).reshape(src.shape[0],
                                                               -1),
                                  dst, n + 1, indices_are_sorted=True)[:n]
        den = jax.ops.segment_sum(p, dst, n + 1, indices_are_sorted=True)[:n]
        return num.astype(f32) / jnp.repeat(jnp.maximum(den, 1e-20),
                                            hh.shape[1] // heads, axis=1)

    timed("spmm_csr", spmm_mod.spmm_raw, cg, x)
    timed("spmm_xla", spmm_xla, cg, x)
    try:
        from jax.experimental import sparse
        ne = hg.n_edge
        row_ptr = jnp.asarray(
            __import__("numpy").searchsorted(
                hg.receivers[:ne], __import__("numpy").arange(n + 1)),
            jnp.int32)
        bcsr = sparse.BCSR((jnp.asarray(hg.edge_weight[:ne]),
                            jnp.asarray(hg.senders[:ne]), row_ptr),
                           shape=(n, n))
        timed("spmm_bcsr_f32", lambda m, v: m @ v, bcsr,
              x.astype(jnp.float32))
    except Exception as ex:  # noqa: BLE001
        emit(what="spmm_bcsr_f32", result=f"error: {str(ex)[:300]}")

    def vjp_of(f):
        # graphs ride as jit arguments: closed over, they would be embedded
        # in the executable as constants
        def run(graphs, *a):
            y, back = jax.vjp(lambda *b: f(graphs, *b), *a)
            return back(jnp.ones_like(y))
        return run

    timed("spmm_csr_vjp", vjp_of(lambda gs, v: spmm_mod.spmm(gs[0], v, gs[1])),
          (cg, cg_t), x)
    timed("spmm_xla_vjp", vjp_of(spmm_xla), cg, x)
    timed("gat_csr", gat_mod.gat_attention, cu, x, a_s, a_d)
    timed("gat_xla", gat_xla, cu, x, a_s, a_d)
    timed("gat_csr_vjp", vjp_of(lambda gs, h, a, b: gat_mod.gat_attention(
        gs[0], h, a, b, cg_t=gs[1], perm_t=gs[2])), (cu, cu_t, perm),
          x, a_s, a_d)
    timed("gat_xla_vjp", vjp_of(gat_xla), cu, x, a_s, a_d)
    del gbar

    if args.sweep:
        for kk in (16, 32, 64, 128, 256):
            for warps in (1, 2, 4, 8):
                la = spmm_mod.Launch(edge_chunk=kk, num_warps=warps)
                timed(f"sweep_spmm_K{kk}_w{warps}",
                      lambda c, v, la=la: spmm_mod.spmm_raw(c, v, launch=la),
                      cg, x)
                timed(f"sweep_gat_K{kk}_w{warps}",
                      lambda c, h, a, b, la=la: jnp.concatenate(
                          gat_mod.gat_partials(
                              c, h, a, b, jnp.max(a, 0, keepdims=True),
                              launch=la), axis=1), cu, x, a_s, a_d)

    if not args.no_train:
        import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
        import optax
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
            schedule as S)
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
            import classify_block
        from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train \
            import TrainState, make_train_step
        xf = jnp.asarray(ds.x)
        y = jnp.asarray(ds.y)
        m = jnp.asarray(ds.train_mask)
        g = ds.graph
        for network in ("GCN", "GAT"):
            model = gta.build_model(network, ds.x.shape[1], ds.n_class,
                                    hidden=128, n_layers=2, heads=4,
                                    reorder=network == "GCN")
            for path in ("csr", "xla"):
                scheds = []
                for og in model.layers:
                    part = (S.aggregation_partition(og) if network == "GCN"
                            else S.pattern_partition(og))
                    tc = S.TileConfig(path=path)
                    scheds.append(S.Schedule(part, tuple(
                        tc if classify_block(og, b, tc)[0] != "xla"
                        else S.TileConfig(path=S.PATH_XLA) for b in part)))
                apply = model.make_apply(jnp.bfloat16, schedules=scheds,
                                         host_graph=hg,
                                         build_transpose=path == "csr")
                tx = optax.adam(1e-3)
                params = model.init(jax.random.key(0))
                state = TrainState(params, tx.init(params),
                                   jnp.zeros((), jnp.int32))

                def step(st, caps, gg, xx, yy, mm, apply=apply, tx=tx):
                    return make_train_step(
                        lambda p, g_, x_: apply.inner(p, g_, x_, caps),
                        tx)(st, gg, xx, yy, mm)

                timed(f"train_{network}_{path}", step, state,
                      apply.captures, g, xf, y, m, iters=5)
                del apply
    sink.close()


if __name__ == "__main__":
    main()
