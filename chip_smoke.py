"""Smoke test of the system's main path on one GPU (or, with --four-cards,
the sharded path on four).

    python chip_smoke.py                 # cora-gat, kernel-parity, reddit-train
    python chip_smoke.py --four-cards    # sharded GCN/GAT + data-parallel only
    python chip_smoke.py --phases kernel-parity

Every phase prints one JSON line carrying the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit``).  The run fails (non-zero
exit, no result line) when JAX finds no GPU, when the package is not
importable, or when any phase fails.  Its last line is

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Phases (one process, in this order):

  cora-gat       GAT at the reference's paper configuration (Cora
                 dimensions, hidden 128, 4 heads, 2 layers, bf16) trained a
                 few steps on the per-op XLA schedule, on the compile-only
                 training pick (``cli train --compiled``) and on the CSR
                 kernels; forward parity of each with the dense oracle;
                 ``cli run --compiled`` (the forward pick).
  kernel-parity  each CSR kernel, forward and VJP, against the plain jnp
                 reference at Reddit widths on the Reddit node set.
  reddit-train   full-batch training steps at Reddit dimensions: GCN
                 (transform-first) and GAT on the compile-only training
                 pick (what ``cli train --compiled`` runs), which must send
                 every aggregation block to the CSR kernels; the transposed
                 graph carries the backward.
  gpu-tests      the test suite's ``gpu``-marked tests, in this process.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import time

PHASES = ("cora-gat", "kernel-parity", "reddit-train", "gpu-tests")

# Reddit-scale graph (bench.py, data.datasets.community_dataset)
REDDIT_EDGES = 114_615_892
# kernel-parity edge cut: the plain references materialise several
# [E, 128] float32 edge tensors (about 2.5 KB per edge with the GAT VJP),
# so 12M edges keep them inside the card's memory
PARITY_EDGES = 12_000_000


def emit(card: dict, phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **card, **fields}), flush=True)


def peak_bytes() -> int:
    import jax
    stats = jax.devices()[0].memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", -1))


def rel_err(a, b) -> float:
    """max |a - b| / max |b| (float64 on the host)."""
    import numpy as np
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def _losses_fall(losses) -> bool:
    import numpy as np
    return bool(np.all(np.isfinite(losses)) and losses[-1] < losses[0])


def kernel_schedules(model):
    """Per-layer schedules that send every SpMM / GAT block of ``model``
    to the CSR kernels and everything else to XLA."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
        import classify_block
    csr = S.TileConfig(path=S.PATH_CSR)
    out = []
    for g in model.layers:
        part = S.aggregation_partition(g) or S.pattern_partition(g)
        out.append(S.Schedule(part, tuple(
            csr if classify_block(g, b, csr)[0] != "xla"
            else S.TileConfig(path=S.PATH_XLA) for b in part)))
    return out


def aggregation_on_csr(model, scheds) -> bool:
    """Whether every aggregation block (one the CSR kernels can run) of
    ``scheds`` is on the CSR path."""
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (
        schedule as S)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.fusion \
        import classify_block
    probe = S.TileConfig(path=S.PATH_CSR)
    agg = [tc for g, sc in zip(model.layers, scheds)
           for b, tc in zip(sc.blocks, sc.tiles)
           if classify_block(g, b, probe)[0] != "xla"]
    return bool(agg) and all(tc.path == S.PATH_CSR for tc in agg)


def phase_cora_gat(card, dataset: str = "cora", steps: int = 8) -> bool:
    import jax
    import jax.numpy as jnp
    import numpy as np

    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu import cli
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.latency \
        import pick_model_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models import (
        dense_oracle as O)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train \
        import train_node_classifier

    ds = gta.load_dataset(dataset)
    hg = ds.host_graph
    model = gta.build_model("GAT", ds.x.shape[1], ds.n_class, hidden=128,
                            n_layers=2, heads=4)
    scheds, _ = pick_model_schedules(model.layers, hg, ds.x.shape[1],
                                     training=True)
    kernel_blocks = sum(t.path == "csr" for s in scheds for t in s.tiles)

    csr = kernel_schedules(model)
    ok = True
    runs = {}
    for label, sched in (("xla", None), ("compiled", scheds), ("csr", csr)):
        losses = []
        _, res = train_node_classifier(
            ds, "GAT", hidden=128, heads=4, n_layers=2, epochs=steps,
            compute_dtype=jnp.bfloat16, model=model, schedules=sched,
            build_transpose=sched is not None,
            on_step=lambda e, l: losses.append(float(l)))
        falls = _losses_fall(losses)
        ok &= falls
        runs[label] = dict(losses=losses, falls=falls,
                           step_s=res.epoch_time_s)

    # forward parity with the dense oracle (numpy float32 on the host);
    # the device forward runs float32 at "highest" matmul precision
    params = model.init(jax.random.key(0))
    x = jnp.asarray(ds.x)
    ne = hg.n_edge
    _, a_cnt = O.dense_mats(hg.senders[:ne], hg.receivers[:ne],
                            hg.edge_weight[:ne], hg.n_node)
    a_cnt = a_cnt.astype(np.float32)
    p_np = {k: np.asarray(v, np.float32) for k, v in params.items()}
    h = O.gat(p_np, ds.x, a_cnt, tag="l0", heads=4, final_sf="elu")
    want = O.gat(p_np, h.astype(np.float32), a_cnt, tag="l1", heads=1,
                 final_sf="identity")
    parity = {}
    with jax.default_matmul_precision("highest"):
        for label, sched in (("xla", None), ("compiled", scheds),
                             ("csr", csr)):
            apply = model.make_apply(None, schedules=sched,
                                     host_graph=hg if sched else None)
            got = jax.jit(apply.inner)(params, ds.graph, x, apply.captures)
            parity[label] = rel_err(got, want)
    # float32 inputs and accumulation on both sides; the summation order
    # and the exp implementation differ
    tol = 1e-3
    ok &= all(v <= tol for v in parity.values())

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(["run", "--dataset", dataset, "--network", "GAT",
                  "--compiled", "--iters", "5", "--json"])
    run_out = json.loads(buf.getvalue().strip().splitlines()[-1])
    emit(card, "cora-gat", ok=bool(ok), schedules=[s.key() for s in scheds],
         kernel_blocks=int(kernel_blocks), train=runs,
         oracle_rel_err=parity, oracle_tol=tol,
         cli_run=dict(latency_us=run_out["latency_us"],
                      schedule=run_out.get("schedule")))
    return bool(ok)


def phase_kernel_parity(card, dataset: str = "reddit",
                        n_edge: int = PARITY_EDGES) -> bool:
    import jax
    import jax.numpy as jnp

    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import DATASET_STATS, synthetic_coo
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.graph import (
        build_host_graph, csr_graph, transpose_host_graph)
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.ops import (
        gat as gat_mod, spmm as spmm_mod)

    t0 = time.perf_counter()
    n = DATASET_STATS[dataset][0]
    s, r, _ = synthetic_coo(n, n_edge, 1, communities=1000, p_in=0.7)
    hg = build_host_graph(s, r, n, add_self_loops=True, symmetric_norm=True)
    hg_t, perm = transpose_host_graph(hg)
    cg, cg_t = csr_graph(hg), csr_graph(hg_t)
    cu, cu_t = csr_graph(hg, unit_weight=True), csr_graph(hg_t,
                                                          unit_weight=True)
    perm = jnp.asarray(perm, jnp.int32)
    setup_s = time.perf_counter() - t0
    k = jax.random.split(jax.random.key(7), 6)
    F, H = 128, 4
    x = jax.random.normal(k[0], (n, F), jnp.bfloat16)
    ybar = jax.random.normal(k[1], (n, F), jnp.float32)
    a_s = jax.random.normal(k[2], (n, H), jnp.float32)
    a_d = jax.random.normal(k[3], (n, H), jnp.float32)

    out = {}
    y, vjp = jax.vjp(lambda v: spmm_mod.spmm(cg, v, cg_t), x)
    y_ref, vjp_ref = jax.vjp(lambda v: spmm_mod.spmm_reference(cg, v), x)
    out["spmm_fwd"] = rel_err(y, y_ref)
    out["spmm_vjp_x"] = rel_err(vjp(ybar)[0], vjp_ref(ybar)[0])
    del y, vjp, y_ref, vjp_ref

    def gat_k(hh, aa, bb):
        return gat_mod.gat_attention(cu, hh, aa, bb, cg_t=cu_t, perm_t=perm)

    def gat_r(hh, aa, bb):
        return gat_mod.gat_reference(cu, hh, aa, bb)

    y, vjp = jax.vjp(gat_k, x, a_s, a_d)
    out["gat_fwd"] = rel_err(y, jax.jit(gat_r)(x, a_s, a_d))
    del y
    got = vjp(ybar)
    del vjp
    want = jax.vjp(gat_r, x, a_s, a_d)[1](ybar)
    for name, a, b in zip(("h", "a_src", "a_dst"), got, want):
        out[f"gat_vjp_{name}"] = rel_err(a, b)
    # tolerances, relative to the reference's largest magnitude:
    # forward — same bf16 inputs, float32 accumulation, different summation
    # order (and, for GAT, the shift bound instead of the exact row max);
    # VJP — the kernels round the cotangent to the input dtype (bf16,
    # 2^-9 relative) before gathering it, and the gradient is bf16
    tol = {k_: (1e-3 if k_.endswith("fwd") else 2e-2) for k_ in out}
    ok = all(out[k_] <= tol[k_] for k_ in out)
    emit(card, "kernel-parity", ok=bool(ok), n_node=n, n_edge=hg.n_edge,
         edge_cut=f"{REDDIT_EDGES} -> {n_edge} (reference memory)",
         widths=dict(spmm_F=F, gat_heads=H, gat_width=F),
         rel_err=out, tol=tol, setup_s=setup_s, peak_bytes=peak_bytes())
    return bool(ok)


def _train_cell(ds, network: str, steps: int, t_setup0: float,
                lr: float = 1e-3) -> dict:
    import jax.numpy as jnp
    import numpy as np

    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler.latency \
        import pick_model_schedules
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train \
        import train_node_classifier

    model = gta.build_model(network, ds.x.shape[1], ds.n_class, hidden=128,
                            n_layers=2, heads=4, reorder=network == "GCN")
    scheds, _ = pick_model_schedules(model.layers, ds.host_graph,
                                     ds.x.shape[1], training=True)
    picked_csr = aggregation_on_csr(model, scheds)
    losses, stamps = [], []

    def on_step(e, loss):
        losses.append(float(loss))
        stamps.append(time.perf_counter())

    train_node_classifier(
        ds, network, hidden=128, heads=4, n_layers=2, epochs=steps, lr=lr,
        compute_dtype=jnp.bfloat16, model=model, schedules=scheds,
        build_transpose=True, on_step=on_step)
    step_s = np.diff(stamps)
    return dict(network=network, n_edge=ds.host_graph.n_edge,
                setup_s=stamps[0] - t_setup0,
                step_s_median=float(np.median(step_s)),
                losses=losses, falls=_losses_fall(losses),
                peak_bytes=peak_bytes(), picked_csr=picked_csr,
                ok=_losses_fall(losses) and picked_csr,
                schedules=[s.key() for s in scheds])


def phase_reddit_train(card, dataset: str = "reddit",
                       n_edge: int = REDDIT_EDGES, steps: int = 5) -> bool:
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.data.datasets \
        import community_dataset

    ok = True
    t0 = time.perf_counter()
    ds = community_dataset(dataset, n_edge=n_edge, seed=1)
    gen_s = time.perf_counter() - t0
    gcn = _train_cell(ds, "GCN", steps, t0)
    gcn["graph_gen_s"] = gen_s
    ok &= gcn["ok"]
    emit(card, "reddit-train", **gcn)
    # GAT at the same graph when it fits; else halve the edge count
    e = n_edge
    while True:
        try:
            t1 = time.perf_counter()
            gds = ds if e == n_edge else community_dataset(
                dataset, n_edge=e, seed=1)
            gat = _train_cell(gds, "GAT", steps, t1)
            break
        except Exception as ex:   # noqa: BLE001 — report the size search
            if "RESOURCE_EXHAUSTED" not in str(ex) or e < 1_000_000:
                raise
            emit(card, "reddit-train", ok=True, network="GAT",
                 n_edge_requested=e, note="out of device memory; halving")
            e //= 2
    ok &= gat["ok"]
    emit(card, "reddit-train", **gat)
    return bool(ok)


def phase_gpu_tests(card) -> bool:
    """The suite's gpu-marked tests, in this process (one JAX process
    holds the card)."""
    import pytest
    os.environ["GTA_TEST_GPU"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                          os.path.join(here, "tests", "test_gpu.py")])
    tail = buf.getvalue().strip().splitlines()[-1:]
    emit(card, "gpu-tests", ok=rc == 0, pytest_rc=int(rc), summary=tail)
    return rc == 0


def phase_four_cards(card, dataset: str = "flickr", steps: int = 3) -> bool:
    """Sharded GCN/GAT over a 1-D ("graph",) mesh of four devices against
    the single-device step, plus data-parallel sampled training."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu import parallel
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.models.train \
        import TrainState, masked_cross_entropy, train_sampled_scan
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.parallel.overlap \
        import overlap_report

    devs = jax.devices()
    n_dev = 4
    if len(devs) < n_dev:
        raise RuntimeError(f"--four-cards needs 4 devices, found {len(devs)}")
    devs = devs[:n_dev]
    mesh = Mesh(np.array(devs), (parallel.AXIS,))
    ds = gta.load_dataset(dataset)
    hg = ds.host_graph
    part_host = parallel.partition_graph(hg, n_dev)
    csrs = parallel.shard_part(parallel.shard_csr(part_host), mesh)
    gcsrs = parallel.shard_part(
        parallel.shard_csr(part_host, unit_weight=True), mesh)
    part = parallel.shard_part(part_host, mesh)
    sh2 = NamedSharding(mesh, P(parallel.AXIS, None))
    sh1 = NamedSharding(mesh, P(parallel.AXIS))
    xs = jax.device_put(jnp.asarray(parallel.pad_nodes(ds.x, part_host)), sh2)
    ys = jax.device_put(jnp.asarray(parallel.pad_nodes(ds.y, part_host)), sh1)
    ms = jax.device_put(
        jnp.asarray(parallel.pad_nodes(ds.train_mask, part_host)), sh1)
    x1 = jax.device_put(jnp.asarray(ds.x), devs[0])
    y1 = jax.device_put(jnp.asarray(ds.y), devs[0])
    m1 = jax.device_put(jnp.asarray(ds.train_mask), devs[0])
    g1 = jax.device_put(ds.graph, devs[0])

    ok = True
    tx = optax.adam(1e-2)
    for network in ("GCN", "GAT"):
        model = gta.build_model(network, ds.x.shape[1], ds.n_class,
                                hidden=128, n_layers=2, heads=4)
        params = model.init(jax.random.key(0))
        kw = (dict(csrs=csrs) if network == "GCN" else dict(gat_csrs=gcsrs))
        fwd = parallel.make_dist_apply(model.layers, mesh, None,
                                       use_kernels=True, **kw)
        scheds = kernel_schedules(model)
        single = model.make_apply(None, schedules=scheds, host_graph=hg,
                                  build_transpose=True)

        def loss_sharded(p):
            return masked_cross_entropy(fwd(p, part, xs), ys, ms)

        def loss_single(p):
            return masked_cross_entropy(
                single.inner(p, g1, x1, single.captures), y1, m1)

        with jax.default_matmul_precision("highest"):
            l_sh, g_sh = jax.jit(jax.value_and_grad(loss_sharded))(params)
            l_1, g_1 = jax.jit(jax.value_and_grad(loss_single))(
                jax.device_put(params, devs[0]))
        grad_err = max(rel_err(a, b) for a, b in zip(
            jax.tree.leaves(g_sh), jax.tree.leaves(g_1)))
        loss_err = rel_err(l_sh, l_1)
        # float32 on both sides; the sharded sum adds local and remote
        # partials in another order
        tol = dict(loss=1e-5, grad=1e-3)
        good = loss_err <= tol["loss"] and grad_err <= tol["grad"]

        step = parallel.make_sharded_train_step(
            model.layers, mesh, tx, jnp.bfloat16, use_kernels=True, **kw)
        state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
        hlo = step.lower(state, part, xs, ys, ms).compile().as_text()
        if "is_scheduled=true" in hlo:
            rep = overlap_report(hlo)
            overlap = dict(n_async=rep["n_async"],
                           n_sync_collectives=rep["n_sync_collectives"],
                           collectives=sorted({p_["collective"]
                                               for p_ in rep["pairs"]}),
                           windows=[p_["window_compute"]
                                    for p_ in rep["pairs"]])
        else:
            overlap = "the compiled module carries no schedule"
        losses = []
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            state, loss = step(state, part, xs, ys, ms)
            losses.append(float(loss))
            times.append(time.perf_counter() - t0)
        good &= bool(np.all(np.isfinite(losses)))
        ok &= good
        emit(card, "four-cards", ok=bool(good), network=network,
             dataset=dataset, n_edge=hg.n_edge, devices=n_dev,
             loss_sharded=float(l_sh), loss_single=float(l_1),
             loss_rel_err=loss_err, grad_rel_err=grad_err, tol=tol,
             step_losses=losses, step_s=times, overlap=overlap)

    dmesh = Mesh(np.array(devs), ("data",))
    batch = min(512, int(ds.train_mask.sum()) // (2 * n_dev))
    _, res, bd = train_sampled_scan(ds, fanouts=(10, 10), batch_size=batch,
                                    epochs=2, hidden=128, mesh=dmesh,
                                    steps_per_epoch=8)
    good = bool(np.isfinite(res.train_loss))
    ok &= good
    emit(card, "four-cards", ok=good, network="GraphSAGE-sampled-dp",
         dataset=dataset, devices=n_dev, batch=batch,
         train_loss=res.train_loss,
         steps_per_epoch=bd["steps_per_epoch"], epoch_s=res.epoch_time_s)
    return bool(ok)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four devices")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma list of phases (default: all)")
    args = ap.parse_args(argv)
    try:
        import gta_graph_tensor_acclelrator_for_general_gnn_tpu  # noqa: F401
    except ImportError as ex:
        print(f"chip_smoke: the package is not importable here: {ex}",
              file=sys.stderr)
        return 2
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.benchmark \
        import card_info
    from gta_graph_tensor_acclelrator_for_general_gnn_tpu.utils.cache import (
        enable_compile_cache)
    enable_compile_cache()
    import jax
    if jax.default_backend() != "gpu":
        print(f"chip_smoke: JAX found no GPU (backend "
              f"{jax.default_backend()!r})", file=sys.stderr)
        return 1
    card = card_info()
    ok = True
    if args.four_cards:
        ok = phase_four_cards(card)
    else:
        fns = {"cora-gat": phase_cora_gat,
               "kernel-parity": phase_kernel_parity,
               "reddit-train": phase_reddit_train,
               "gpu-tests": phase_gpu_tests}
        for name in args.phases.split(","):
            ok &= fns[name](card)
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    print(f"{card['card']}, {card['power_limit']}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
