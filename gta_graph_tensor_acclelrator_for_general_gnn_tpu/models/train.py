"""Training: full-batch node classification.

The reference has no training at all (its "execution" is a cycle-count
simulation — SURVEY §2); this module supplies the real thing: masked
cross-entropy over train nodes, optax Adam, a single jitted train step with
donated parameters, and an epoch loop reporting loss/accuracy and edges/s.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from ..data.datasets import Dataset
from ..graph import GraphTensor
from .zoo import Model, build_model


class TrainState(NamedTuple):
    params: Dict[str, jax.Array]
    opt_state: optax.OptState
    step: jax.Array


def masked_cross_entropy(logits: jax.Array, labels: jax.Array, mask: jax.Array) -> jax.Array:
    """Mean softmax CE over masked nodes (f32 for stability)."""
    logits = logits.astype(jnp.float32)
    logp = jax.nn.log_softmax(logits, axis=-1)
    nll = -jnp.take_along_axis(logp, labels[:, None].astype(jnp.int32), axis=-1)[:, 0]
    m = mask.astype(jnp.float32)
    return jnp.sum(nll * m) / jnp.maximum(jnp.sum(m), 1.0)


def accuracy(logits: jax.Array, labels: jax.Array, mask: jax.Array) -> jax.Array:
    pred = jnp.argmax(logits, axis=-1)
    m = mask.astype(jnp.float32)
    return jnp.sum((pred == labels) * m) / jnp.maximum(jnp.sum(m), 1.0)


def make_train_step(
    apply: Callable,
    tx: optax.GradientTransformation,
    *,
    remat: bool = False,
    pmean_axis: Optional[str] = None,
):
    """Build ``step(state, g, x, y, mask) -> (state, loss)``.

    ``remat=True`` wraps the forward in jax.checkpoint, trading FLOPs for HBM
    on deep stacks / large graphs.

    ``pmean_axis`` makes the step data-parallel: gradients (and the reported
    loss) are averaged over that mesh axis before the optimizer update, so
    every shard applies the identical update (synchronous DP; the step must
    then run inside ``shard_map``/``pjit`` over that axis).
    """
    fwd = jax.checkpoint(apply) if remat else apply

    def loss_fn(params, g, x, y, mask):
        logits = fwd(params, g, x)
        return masked_cross_entropy(logits, y, mask)

    def step(state: TrainState, g: GraphTensor, x, y, mask):
        loss, grads = jax.value_and_grad(loss_fn)(state.params, g, x, y, mask)
        if pmean_axis is not None:
            grads = jax.lax.pmean(grads, pmean_axis)
            loss = jax.lax.pmean(loss, pmean_axis)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return step


@dataclasses.dataclass
class FitResult:
    train_loss: float
    train_acc: float
    val_acc: float
    test_acc: float
    epochs: int
    epoch_time_s: float        # steady-state per-epoch wall time
    edges_per_s: float


def train_node_classifier(
    ds: Dataset,
    network: str = "GCN",
    *,
    hidden: int = 128,
    n_layers: int = 2,
    heads: int = 4,
    epochs: int = 100,
    lr: float = 1e-2,
    weight_decay: float = 5e-4,
    compute_dtype=None,
    seed: int = 0,
    remat: bool = False,
    model: Optional[Model] = None,
    schedules=None,
    build_transpose: bool = False,
    verbose: bool = False,
    on_step: Optional[Callable[[int, jax.Array], None]] = None,
) -> Tuple[TrainState, FitResult]:
    """Full-batch training of ``network`` on ``ds``; returns final state +
    metrics.  ``schedules`` routes layers through the fusion compiler
    (CSR kernel / stream execution) — training works through the kernels'
    custom VJPs.  ``build_transpose`` (with schedules) also builds the
    transposed CSR so gradients run the kernels backwards instead of the
    [E, F]-materialising XLA recompute — required at large-graph scale.
    ``on_step(epoch, loss)`` is called after every step (loss stays a
    device scalar; reading it synchronises)."""
    model = model or build_model(
        network, ds.x.shape[1], ds.n_class,
        hidden=hidden, n_layers=n_layers, heads=heads)
    apply = model.make_apply(compute_dtype, schedules=schedules,
                             host_graph=ds.host_graph if schedules else None,
                             build_transpose=build_transpose)
    params = model.init(jax.random.key(seed))
    tx = optax.adamw(lr, weight_decay=weight_decay)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))

    # the layers' graph data rides as a jit ARGUMENT (GB-scale constants
    # would be embedded in the program)
    def step_fn(state, g, x, y, mask, caps):
        def fwd(p, g, x):
            return apply.inner(p, g, x, caps)
        return make_train_step(fwd, tx, remat=remat)(state, g, x, y, mask)

    step = jax.jit(step_fn, donate_argnums=0)
    eval_fn = jax.jit(apply.inner)
    caps = apply.captures

    g = ds.graph
    x = jax.device_put(jnp.asarray(ds.x))
    y = jax.device_put(jnp.asarray(ds.y))
    tr = jax.device_put(jnp.asarray(ds.train_mask))

    # warmup (compile) outside the timed region
    state, loss = step(state, g, x, y, tr, caps)
    jax.block_until_ready(loss)
    if on_step is not None:
        on_step(0, loss)
    t0 = time.perf_counter()
    timed = 0
    for e in range(1, epochs):
        state, loss = step(state, g, x, y, tr, caps)
        timed += 1
        if on_step is not None:
            on_step(e, loss)
        if verbose and e % 20 == 0:
            print(f"epoch {e}: loss {float(loss):.4f}")
    jax.block_until_ready(loss)
    dt = (time.perf_counter() - t0) / max(timed, 1)

    logits = eval_fn(state.params, g, x, caps)
    res = FitResult(
        train_loss=float(loss),
        train_acc=float(accuracy(logits, y, tr)),
        val_acc=float(accuracy(logits, y, jnp.asarray(ds.val_mask))),
        test_acc=float(accuracy(logits, y, jnp.asarray(ds.test_mask))),
        epochs=epochs,
        epoch_time_s=dt,
        edges_per_s=ds.graph.n_edge / dt if dt > 0 else 0.0,
    )
    return state, res


def train_sampled(
    ds: Dataset,
    *,
    fanouts=(10, 10),
    batch_size: int = 256,
    epochs: int = 3,
    hidden: int = 128,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    network: str = "GraphSAGE",
    device_features: Optional[bool] = None,
    prefetch: int = 2,
    eval_full: Optional[bool] = None,
    steps_per_epoch: Optional[int] = None,
) -> Tuple[TrainState, FitResult]:
    """Minibatch training with neighbour sampling (the Reddit-scale path).

    Every batch has identical static shapes, so ONE jitted train step serves
    the whole run; per-step host work is the sampler (overlapped with device
    execution by a ``prefetch``-deep background thread).

    ``device_features``: keep the FULL [N, F] feature/label matrices resident
    on device and gather each batch's rows *inside* the jitted step — per
    step only the index/edge arrays cross host->device (a few MB), not the
    gathered features (hundreds of MB at Reddit scale).  Default: auto-on
    when the feature matrix exceeds 32 MB.

    ``eval_full``: run the final full-batch accuracy pass.  Default:
    auto-off for graphs > 4M edges (the XLA eval path materialises [E, F]).

    ``steps_per_epoch`` caps each epoch (benchmark use).
    """
    import numpy as np
    from ..data.sampling import NeighborSampler, gather_features

    if device_features is None:
        device_features = ds.x.nbytes > 32 * 2**20
    if eval_full is None:
        eval_full = ds.host_graph.n_edge <= 4_000_000

    model = build_model(network, ds.x.shape[1], ds.n_class,
                        hidden=hidden, n_layers=len(fanouts))
    apply = model.make_apply(compute_dtype)
    params = model.init(jax.random.key(seed))
    tx = optax.adamw(lr, weight_decay=5e-4)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))

    base_step = make_train_step(apply, tx)
    if device_features:
        # xfull/yfull are jit ARGUMENTS (closure constants at this size would
        # be embedded in the HLO — the round-1 full-Reddit crash)
        def dev_step(state, g, ids, seed_mask, xfull, yfull):
            valid = ids >= 0
            rows = jnp.maximum(ids, 0)
            xb = jnp.where(valid[:, None], xfull[rows], 0)
            yb = jnp.where(valid, yfull[rows], 0)
            return base_step(state, g, xb, yb, seed_mask)
        step = jax.jit(dev_step, donate_argnums=0)
        xfull = jax.device_put(jnp.asarray(ds.x))
        yfull = jax.device_put(jnp.asarray(ds.y.astype(np.int32)))
    else:
        step = jax.jit(base_step, donate_argnums=0)
        xfull = yfull = None

    sampler = NeighborSampler(ds.host_graph, fanouts, batch_size, seed=seed)
    train_nodes = np.flatnonzero(ds.train_mask)

    def host_batches():
        for ep in range(epochs):
            n = 0
            for batch in sampler.epoch(train_nodes):
                if device_features:
                    yield (batch.device_graph(), batch.node_ids.astype(np.int32),
                           batch.seed_mask)
                else:
                    xb = gather_features(ds.x, batch)
                    valid = batch.node_ids >= 0
                    yb = np.zeros(batch.cap_nodes, np.int32)
                    yb[valid] = ds.y[batch.node_ids[valid]]
                    yield (batch.device_graph(), xb, yb, batch.seed_mask)
                n += 1
                if steps_per_epoch and n >= steps_per_epoch:
                    break

    def prefetched(it, depth: int):
        """Run the host-side sampler in a daemon thread ``depth`` batches
        ahead of the device loop."""
        if depth <= 0:
            yield from it
            return
        import queue as _q
        import threading
        q: "_q.Queue" = _q.Queue(maxsize=depth)
        END = object()

        def produce():
            try:
                for item in it:
                    q.put(item)
                q.put(END)
            except BaseException as ex:  # surface in the consumer, never
                q.put(ex)                # silently end the epoch early

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    n_steps = 0
    timed_from = 0
    t0 = None
    loss = jnp.zeros(())
    for item in prefetched(host_batches(), prefetch):
        if device_features:
            g, ids, sm = item
            state, loss = step(state, g, jnp.asarray(ids), jnp.asarray(sm),
                               xfull, yfull)
        else:
            g, xb, yb, sm = item
            state, loss = step(state, g, jnp.asarray(xb), jnp.asarray(yb),
                               jnp.asarray(sm))
        n_steps += 1
        if t0 is None:
            # first step compiled; start the clock after it completes
            jax.block_until_ready(loss)
            t0 = time.perf_counter()
            timed_from = n_steps
    jax.block_until_ready(loss)
    total = time.perf_counter() - (t0 if t0 is not None else time.perf_counter())
    steps_ep = max(n_steps // max(epochs, 1), 1)
    dt = total / max((n_steps - timed_from) / steps_ep, 1e-9) \
        if n_steps > timed_from else float("inf")

    y = jnp.asarray(ds.y)
    if eval_full:
        eval_fn = jax.jit(apply)
        logits = eval_fn(state.params, ds.graph, jnp.asarray(ds.x))
        tr_acc = float(accuracy(logits, y, jnp.asarray(ds.train_mask)))
        va_acc = float(accuracy(logits, y, jnp.asarray(ds.val_mask)))
        te_acc = float(accuracy(logits, y, jnp.asarray(ds.test_mask)))
    else:
        tr_acc = va_acc = te_acc = float("nan")
    res = FitResult(
        train_loss=float(loss),
        train_acc=tr_acc,
        val_acc=va_acc,
        test_acc=te_acc,
        epochs=epochs,
        epoch_time_s=dt,
        edges_per_s=steps_ep * sampler.cap_edges / dt if dt > 0 else 0.0,
    )
    return state, res


def train_sampled_scan(
    ds: Dataset,
    *,
    fanouts=(10, 10),
    batch_size: int = 512,
    epochs: int = 3,
    hidden: int = 128,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    network: str = "GraphSAGE",
    steps_per_epoch: Optional[int] = None,
    measure_device_epoch: bool = False,
    mesh=None,
    dp_axis: str = "data",
) -> Tuple[TrainState, FitResult, dict]:
    """Sampled training with ONE device dispatch per epoch.

    The per-step dispatch path (:func:`train_sampled`) pays the runtime's
    per-execution overhead on every minibatch, the dominant cost at small
    step times.  Here the whole epoch is a ``lax.scan`` of the
    train step over device-stacked batch arrays: the sampler produces all
    S batches for the epoch on host (stacked [S, ...] numpy arrays, a few
    hundred MB at Reddit scale), one transfer ships them, and one jitted
    scan trains through them.  Features/labels stay device-resident; each
    scan step gathers its rows in-graph.

    Returns ``(state, FitResult, breakdown)`` where breakdown has
    ``sample_s`` / ``h2d_dispatch_s`` per-epoch host-side costs and (with
    ``measure_device_epoch``) ``device_epoch_s``, the slope time of the
    pure device epoch (1 vs 3 chained epochs in one dispatch each).

    ``mesh`` enables synchronous data parallelism over its ``dp_axis``:
    each global step consumes D = mesh.shape[dp_axis] sampled batches (one
    per shard), gradients are pmean'd before the (replicated) optimizer
    update — effective batch D * batch_size, S // D optimizer steps per
    epoch.  The stacked epoch arrays are sharded [S//D, D, ...] along the
    data axis, so the host sampler feeds all shards from one epoch buffer.
    Composes with the graph-sharded full-batch path (parallel/dist.py) as
    the second parallelism dimension.
    """
    import numpy as np
    from ..data.sampling import NeighborSampler
    from ..graph import GraphTensor as GT

    model = build_model(network, ds.x.shape[1], ds.n_class,
                        hidden=hidden, n_layers=len(fanouts))
    apply = model.make_apply(compute_dtype)
    params = model.init(jax.random.key(seed))
    tx = optax.adamw(lr, weight_decay=5e-4)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    n_dp = int(mesh.shape[dp_axis]) if mesh is not None else 1
    base_step = make_train_step(
        apply, tx, pmean_axis=dp_axis if mesh is not None else None)

    sampler = NeighborSampler(ds.host_graph, fanouts, batch_size, seed=seed)
    train_nodes = np.flatnonzero(ds.train_mask)
    if len(train_nodes) < batch_size:
        raise ValueError(
            f"batch_size={batch_size} exceeds the train split "
            f"({len(train_nodes)} nodes) — no full batch can be sampled; "
            f"shrink batch_size")
    cap_n = sampler.cap_nodes

    xfull = jax.device_put(jnp.asarray(ds.x))
    yfull = jax.device_put(jnp.asarray(ds.y.astype(np.int32)))

    from .. import native as native_mod
    epoch_counter = [0]
    e_pad_static = sampler.cap_edges + sampler.cap_nodes

    def stack_epoch():
        """Host-sample one epoch; returns stacked numpy pytree + e_pad.

        Native path: all batches of the epoch sample in parallel C++
        threads (native/sampler.cpp) straight into the stacked arrays —
        ~10x the single-threaded numpy path at Reddit scale."""
        n_steps = len(train_nodes) // batch_size
        if steps_per_epoch:
            n_steps = min(n_steps, steps_per_epoch)
        if native_mod.HAVE_NATIVE and n_steps >= 1:
            perm = sampler.rng.permutation(train_nodes)
            seeds = perm[: n_steps * batch_size]
            epoch_counter[0] += 1
            stacked = native_mod.sample_epoch_native(
                sampler.row_ptr, sampler.senders, seeds, fanouts,
                batch_size, cap_n, e_pad_static,
                seed * 1_000_003 + epoch_counter[0])
            if stacked is not None:
                return stacked, e_pad_static, n_steps
        gs = []
        for batch in sampler.epoch(train_nodes):
            gs.append(batch)
            if steps_per_epoch and len(gs) >= steps_per_epoch:
                break
        return dict(
            senders=np.stack([b.graph.senders for b in gs]),
            receivers=np.stack([b.graph.receivers for b in gs]),
            mask=np.stack([b.graph.edge_mask for b in gs]),
            weight=np.stack([b.graph.edge_weight for b in gs]),
            ids=np.stack([b.node_ids.astype(np.int32) for b in gs]),
            seed=np.stack([b.seed_mask for b in gs]),
        ), gs[0].graph.e_pad, len(gs)

    first, e_pad, n_steps = stack_epoch()
    if mesh is not None:
        if n_steps < n_dp:
            raise ValueError(
                f"data parallelism needs >= {n_dp} batches/epoch, "
                f"got {n_steps} (shrink batch_size or the mesh)")
        n_steps = (n_steps // n_dp) * n_dp

    def _put(stacked):
        """Ship one epoch's stacked batch arrays; in DP mode sharded
        [S//D, D, ...] over the data axis so scan step i feeds shard d its
        batch i*D+d."""
        if mesh is None:
            return jax.device_put(stacked)
        from jax.sharding import NamedSharding, PartitionSpec as P
        sh = NamedSharding(mesh, P(None, dp_axis))
        return {k: jax.device_put(
                    v[: n_steps].reshape((n_steps // n_dp, n_dp)
                                         + v.shape[1:]), sh)
                for k, v in stacked.items()}

    def epoch_fn(state, stacked, xf, yf):
        # xf/yf are jit ARGUMENTS: closing over device arrays embeds them as
        # HLO constants (GB-scale compile payloads — the round-1 crash class)
        def body(st, b):
            g = GT(senders=b["senders"], receivers=b["receivers"],
                   edge_mask=b["mask"], edge_weight=b["weight"],
                   n_node=cap_n, n_edge=e_pad)
            valid = b["ids"] >= 0
            rows = jnp.maximum(b["ids"], 0)
            xb = jnp.where(valid[:, None], xf[rows], 0)
            yb = jnp.where(valid, yf[rows], 0)
            st, loss = base_step(st, g, xb, yb, b["seed"])
            return st, loss
        if mesh is None:
            state, losses = jax.lax.scan(body, state, stacked)
            return state, losses[-1]

        from jax import shard_map
        from jax.sharding import PartitionSpec as P

        def local_epoch(st, sd, xf_, yf_):
            def dp_body(s, b):
                # local slice of the D axis is width 1: drop it
                return body(s, jax.tree.map(lambda a: a[0], b))
            st2, losses = jax.lax.scan(dp_body, st, sd)
            return st2, losses[-1]

        # grads are pmean'd inside base_step, so state stays replicated;
        # check_rep can't prove that through optax — assert it ourselves
        return shard_map(
            local_epoch, mesh=mesh,
            in_specs=(P(), P(None, dp_axis), P(), P()),
            out_specs=(P(), P()), check_vma=False,
        )(state, stacked, xf, yf)

    run_epoch = jax.jit(epoch_fn, donate_argnums=0)

    # warmup epoch (compile) — counts as training, not as timing
    sample_s = []
    h2d_s = []
    state, loss = run_epoch(state, _put(first), xfull, yfull)
    jax.block_until_ready(loss)

    t_all = time.perf_counter()
    for _ in range(max(epochs - 1, 0)):
        t0 = time.perf_counter()
        stacked, _, _ = stack_epoch()
        sample_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        state, loss = run_epoch(state, _put(stacked), xfull, yfull)
        h2d_s.append(time.perf_counter() - t0)
    jax.block_until_ready(loss)
    total = time.perf_counter() - t_all
    dt = total / max(epochs - 1, 1)

    breakdown = dict(
        sample_s=float(np.mean(sample_s)) if sample_s else 0.0,
        h2d_dispatch_s=float(np.mean(h2d_s)) if h2d_s else 0.0,
        steps_per_epoch=n_steps,
    )
    if measure_device_epoch:
        # slope between k=1 and k=3 chained epochs in ONE dispatch each:
        # pure device time, every constant overhead cancelled
        stacked_dev = _put(first)

        def k_epochs(k):
            def fn(st, sd, xf, yf):
                def body(i, s):
                    s2, _ = epoch_fn(s, sd, xf, yf)
                    return s2
                return jax.lax.fori_loop(0, k, body, st)
            return jax.jit(fn)

        f1, f3 = k_epochs(1), k_epochs(3)
        a = (stacked_dev, xfull, yfull)
        _ = float(f1(state, *a).step)
        _ = float(f3(state, *a).step)
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter(); _ = float(f1(state, *a).step)
            t1 = time.perf_counter() - t0
            t0 = time.perf_counter(); _ = float(f3(state, *a).step)
            t3 = time.perf_counter() - t0
            best = min(best, (t3 - t1) / 2)
        breakdown["device_epoch_s"] = max(best, 0.0)

    res = FitResult(
        train_loss=float(loss),
        train_acc=float("nan"),
        val_acc=float("nan"),
        test_acc=float("nan"),
        epochs=epochs,
        epoch_time_s=dt,
        edges_per_s=n_steps * sampler.cap_edges / dt if dt > 0 else 0.0,
    )
    return state, res, breakdown
