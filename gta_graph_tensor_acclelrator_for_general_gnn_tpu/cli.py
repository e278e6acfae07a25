"""CLI driver — the reference's ``start.py`` (vTCAD/code/start.py:13-63)
re-imagined for real execution.

Reference flags and their equivalents here:
  --dataset / --network            same
  --isReorder                      --reorder (algebraically reordered graph)
  --isSinput                       (dropped: the first layer's [N, F] @ W is
                                   one dense tensor-core matmul)
  --isPingpang                     (subsumed: the kernels pipeline their
                                   own loads)
  --isFlexibleBuffer               --hw-config region caps (hwconfig.py)
plus new commands the reference cannot do:
  run       forward latency of the model on the dataset
  train     full training run, reports accuracy and epoch time
  tune      schedule autotune (enumerative or --ga), prints the best schedule
  bench     CSR kernel vs XLA time for the SpMM and GAT aggregations

The reference prints simulated latency-seconds and MB moved (start.py:57-58);
``run`` prints *measured* latency of the chosen schedule.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None):
    p = argparse.ArgumentParser(
        prog="gta",
        description="graph tensor accelerator for general GNNs")
    p.add_argument("command", choices=["run", "train", "tune", "bench"])
    p.add_argument("--dataset", default="cora")
    p.add_argument("--network", default="GAT")
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--heads", type=int, default=4)
    p.add_argument("--reorder", action="store_true",
                   help="use the algebraically reordered (trans) op graph")
    p.add_argument("--node-reorder", default="none",
                   choices=["none", "degree", "cluster"],
                   help="relabel nodes before execution (cluster = "
                        "label-propagation communities — the label-free "
                        "locality preprocessing real graphs need)")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--bf16", action="store_true", default=True)
    p.add_argument("--f32", dest="bf16", action="store_false")
    p.add_argument("--ga", action="store_true", help="genetic tile search")
    p.add_argument("--stack", action="store_true",
                   help="tune each layer of the real model stack and write "
                        "a per-layer schedule JSON (run/train --schedule)")
    p.add_argument("--compiled", action="store_true",
                   help="run/train: use the compile-only min-modelled-"
                        "latency schedule pick (compiler/latency.py) when "
                        "no --schedule file is given; train additionally "
                        "builds the transposed CSR so gradients run the "
                        "kernels backwards")
    p.add_argument("--schedule", default=None,
                   help="path to a tuned schedule JSON (results/best_*.json) "
                        "to execute with (run/train)")
    p.add_argument("--ckpt", default=None,
                   help="checkpoint dir: train saves final state here")
    p.add_argument("--memo", default=None, help="schedule memo CSV path")
    p.add_argument("--hw-config", default=None,
                   help="hardware config JSON/YAML (buffer budget, region "
                        "caps, tile palette — the reference's "
                        "hardware_info.yaml); also via $GTA_HW_CONFIG")
    p.add_argument("--derive-palette", action="store_true",
                   help="tune over a palette derived from the buffer-"
                        "maximal tile for this graph's widest op (the "
                        "reference's buffer-maximal tile-scale sweep)")
    p.add_argument("--batch", type=int, default=1,
                   help="bench: compose this many independent copies of "
                        "the dataset graph block-diagonally (the serving "
                        "shape) and report batched edges/s")
    p.add_argument("--iters", type=int, default=20,
                   help="timed calls per measurement (median reported)")
    p.add_argument("--communities", type=int, default=0,
                   help="draw the synthetic graph with this many planted "
                        "communities (data.datasets.community_dataset); "
                        "the full-batch Reddit-scale graph is --dataset "
                        "reddit --communities 1000 --seed 1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--multihost", action="store_true",
                   help="initialize jax.distributed and train full-batch "
                        "over the (hosts x local devices) mesh — run one "
                        "process per host (parallel/multihost.py); needs "
                        "--coordinator, --nprocs and --procid")
    p.add_argument("--coordinator", default=None,
                   help="multihost coordinator address host:port")
    p.add_argument("--nprocs", type=int, default=None,
                   help="multihost process count")
    p.add_argument("--procid", type=int, default=None,
                   help="this process's id")
    args = p.parse_args(argv)

    if args.hw_config:
        import os as _os
        _os.environ["GTA_HW_CONFIG"] = args.hw_config

    from .utils.cache import enable_compile_cache
    enable_compile_cache()

    import jax
    import jax.numpy as jnp

    if args.multihost:
        if None in (args.coordinator, args.nprocs, args.procid):
            p.error("--multihost needs --coordinator, --nprocs and --procid")
        # before any device use: join (or start) the jax.distributed pod
        from .parallel.multihost import init_multihost
        pid, pcount = init_multihost(args.coordinator, args.nprocs,
                                     args.procid)
        print(f"multihost: process {pid}/{pcount}, "
              f"{jax.local_device_count()} local / "
              f"{jax.device_count()} global devices", flush=True)

    from . import build_op_graph, load_dataset
    from .compiler.lower import init_params
    from .data.datasets import community_dataset
    from .utils.benchmark import time_apply

    dtype = jnp.bfloat16 if args.bf16 else None
    ds = (community_dataset(args.dataset, seed=args.seed,
                            communities=args.communities)
          if args.communities else load_dataset(args.dataset, seed=args.seed))
    if args.node_reorder != "none":
        import dataclasses as _dc

        from .graph import reorder_nodes
        hg2, perm = reorder_nodes(ds.host_graph, args.node_reorder)
        ds = _dc.replace(ds, host_graph=hg2, x=ds.x[perm], y=ds.y[perm],
                         train_mask=ds.train_mask[perm],
                         val_mask=ds.val_mask[perm],
                         test_mask=ds.test_mask[perm], _device_graph=None)
    out = {"dataset": args.dataset, "network": args.network,
           "synthetic_data": ds.synthetic,
           "node_reorder": args.node_reorder,
           "graph": dict(n_node=ds.host_graph.n_node,
                         n_edge=ds.host_graph.n_edge,
                         e_pad=ds.host_graph.e_pad)}

    def _parse_sched(spec):
        from .compiler import schedule as S
        return S.Schedule(
            blocks=tuple(tuple(b) for b in spec["blocks"]),
            tiles=tuple(S.TileConfig(*t) for t in spec["tiles"]))

    def load_schedule():
        """One schedule (reused per layer) or a per-layer list when the
        JSON carries a 'layers' key (written by ``tune --stack``)."""
        if not args.schedule:
            return None
        import json as _json
        spec = _json.load(open(args.schedule))
        if "layers" in spec:
            return [_parse_sched(sp) for sp in spec["layers"]]
        return _parse_sched(spec)

    if args.command == "train" and args.multihost:
        from .parallel.multihost import train_multihost
        loss, _state = train_multihost(
            ds, args.network, hidden=args.hidden, n_layers=args.layers,
            heads=args.heads, epochs=args.epochs, lr=args.lr,
            compute_dtype=dtype, seed=args.seed, verbose=not args.json)
        out.update(dict(train_loss=loss, multihost=True,
                        processes=jax.process_count(),
                        devices=jax.device_count()))
    elif args.command == "train":
        from .models.train import train_node_classifier
        sched = load_schedule()
        if sched is not None and not isinstance(sched, list):
            sched = [sched] * args.layers
        model_ = None
        if sched is None and args.compiled:
            # compile-only pick per layer; training flows through the
            # kernels' custom VJPs.  The transposed CSR for the kernel
            # backward rides on build_transpose below.  The picked-for model (incl. the
            # --reorder trans variant) is passed through so block ids
            # match the trained layers.
            from .compiler.latency import pick_model_schedules
            from .models.zoo import build_model
            model_ = build_model(args.network, ds.x.shape[1], ds.n_class,
                                 hidden=args.hidden, n_layers=args.layers,
                                 heads=args.heads, reorder=args.reorder)
            sched, _ = pick_model_schedules(model_.layers, ds.host_graph,
                                            ds.x.shape[1], training=True)
            out["schedule"] = [s.key() for s in sched]
        state, res = train_node_classifier(
            ds, args.network, hidden=args.hidden, n_layers=args.layers,
            heads=args.heads, epochs=args.epochs, lr=args.lr,
            compute_dtype=dtype, seed=args.seed, model=model_,
            schedules=sched, build_transpose=bool(args.compiled))
        if args.ckpt:
            from .utils.checkpoint import save_state
            out["ckpt_step"] = save_state(args.ckpt, state)
        out.update(dict(
            train_loss=res.train_loss, train_acc=res.train_acc,
            val_acc=res.val_acc, test_acc=res.test_acc,
            epoch_time_s=res.epoch_time_s, edges_per_s=res.edges_per_s))

    elif args.command == "run":
        from .models.zoo import build_model
        model = build_model(args.network, ds.x.shape[1], ds.n_class,
                            hidden=args.hidden, n_layers=args.layers,
                            heads=args.heads, reorder=args.reorder)
        params = jax.device_put(model.init(jax.random.key(args.seed)))
        x = jax.device_put(jnp.asarray(ds.x))
        sched = load_schedule()
        if sched is not None and not isinstance(sched, list):
            sched = [sched] * args.layers
        if sched is None and args.compiled:
            # compile-only pick: argmin MODELLED latency incl. the all-XLA
            # candidate (compiler/latency.py — the reference's
            # compiler+simulator role, no measurement in the loop)
            from .compiler.latency import pick_model_schedules
            sched, modelled_ns = pick_model_schedules(
                model.layers, ds.host_graph, ds.x.shape[1])
            out["modelled_us"] = modelled_ns / 1e3
        fwd = model.make_apply(
            dtype, schedules=sched,
            host_graph=ds.host_graph if sched else None)
        if sched:
            out["schedule"] = [s.key() for s in sched]
        lat = time_apply(fwd, params, ds.graph, x, iters=args.iters)
        out.update(dict(latency_us=lat * 1e6,
                        edges_per_s=ds.host_graph.n_edge * args.layers / lat))

    elif args.command == "tune":
        memo = args.memo or f"results/memo_{args.network}_{args.dataset}.csv"

        def tune_one(graph, in_w, warm=()):
            params = jax.device_put(
                init_params(graph, jax.random.key(args.seed)))
            x = jax.device_put(jax.random.normal(
                jax.random.key(1), (ds.host_graph.n_node, in_w),
                jnp.float32))
            if args.ga:
                from .tune import GeneticTuner
                tuner = GeneticTuner(graph, ds.host_graph,
                                     compute_dtype=dtype,
                                     memo_path=memo, iters=args.iters,
                                     warm_start=warm,
                                     derive_palette=args.derive_palette)
                return tuner.search(params, ds.graph, x,
                                    verbose=not args.json)
            from .tune import autotune
            return autotune(graph, ds.host_graph, params, ds.graph, x,
                            compute_dtype=dtype, memo_path=memo,
                            iters=args.iters, verbose=not args.json)

        if args.stack:
            # per-layer tuning of the REAL model stack (1433->128 and
            # 128->7 want different schedules); writes one JSON `run` and
            # `train --schedule` consume directly
            from .models.zoo import build_model
            model = build_model(args.network, ds.x.shape[1], ds.n_class,
                                hidden=args.hidden, n_layers=args.layers,
                                heads=args.heads, reorder=args.reorder)
            specs, total = [], 0.0
            w = ds.x.shape[1]
            prev_best = []           # transfer: seed layer i+1 from layer i
            for li, graph in enumerate(model.layers):
                res = tune_one(graph, w, warm=tuple(prev_best[-1:]))
                prev_best.append(res.best)
                total += res.latency_s
                specs.append(dict(
                    blocks=[list(b) for b in res.best.blocks],
                    tiles=[list(t.key()) for t in res.best.tiles],
                    latency_us=res.latency_s * 1e6))
                w = max(op.out_width for op in graph.ops
                        if op.op_id in graph.outputs)
                if not args.json:
                    print(f"layer {li}: {res.latency_s*1e6:.1f}us "
                          f"{res.best.key()}")
            import os as _os
            path = args.schedule or (
                f"results/best_{args.network}_{args.dataset}_stack.json")
            _os.makedirs(_os.path.dirname(path) or ".", exist_ok=True)
            json.dump({"layers": specs}, open(path, "w"))
            out.update(dict(stack_latency_us=total * 1e6,
                            schedule_path=path))
        else:
            graph = build_op_graph(
                args.network, args.hidden, args.hidden, heads=args.heads,
                reorder=args.reorder, layer_tag="tune")
            res = tune_one(graph, args.hidden)
            out.update(dict(best_latency_us=res.latency_s * 1e6,
                            best_schedule=res.best.key(),
                            n_trials=len(res.trials),
                            pareto=[dict(latency_us=m.latency_s * 1e6,
                                         traffic_bytes=m.traffic,
                                         schedule=m.schedule.key())
                                    for m in res.pareto]))
            if not args.json:
                print(res.report())

    elif args.command == "bench":
        from .ops import gat as gat_mod
        from .ops import spmm as spmm_mod
        from .graph import csr_graph
        from .utils.benchmark import time_fn
        bhg = ds.host_graph
        if args.batch > 1:
            # block-diagonal serving composition: one kernel sweep serves
            # all B copies; per-graph edge weights (the dataset's own
            # symmetric norm) are preserved by batch_graphs
            from .data.batching import batch_graphs
            bhg, _ = batch_graphs([bhg] * args.batch)
            out["batch"] = args.batch
        cg = csr_graph(bhg)
        cg_u = csr_graph(bhg, unit_weight=True)
        heads = args.heads
        key = jax.random.key(args.seed)
        kx, ks, kd = jax.random.split(key, 3)
        x = jax.random.normal(kx, (bhg.n_node, args.hidden),
                              jnp.bfloat16 if args.bf16 else jnp.float32)
        a_s = jax.random.normal(ks, (bhg.n_node, heads), jnp.float32)
        a_d = jax.random.normal(kd, (bhg.n_node, heads), jnp.float32)
        fns = {
            "spmm_csr": (jax.jit(spmm_mod.spmm_raw), (cg, x)),
            "spmm_xla": (jax.jit(spmm_mod.spmm_reference), (cg, x)),
            "gat_csr": (jax.jit(gat_mod.gat_attention),
                        (cg_u, x, a_s, a_d)),
            "gat_xla": (jax.jit(gat_mod.gat_reference),
                        (cg_u, x, a_s, a_d)),
        }
        for name, (f, fargs) in fns.items():
            med, _ = time_fn(f, *fargs, iters=args.iters)
            out[f"{name}_us"] = med * 1e6
            out[f"{name}_edges_per_s"] = bhg.n_edge / med
        dev = jax.devices()[0]
        out["device"] = dict(platform=dev.platform, kind=dev.device_kind,
                             count=len(jax.devices()))

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
