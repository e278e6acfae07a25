"""Multi-host bootstrap: ``jax.distributed`` initialization + the
full-batch distributed training driver over a {hosts x local devices} mesh.

The reference is a single Python process with no distributed execution of
any kind (SURVEY §2 parallelism audit); this module is the piece that
lets the SAME training entry point run unchanged on several hosts: each
host process calls :func:`init_multihost` with the coordinator address,
process count and its own id (nothing on a GPU host describes the cluster
to JAX), then :func:`train_multihost` builds the hierarchical 2-D
partition (parallel/mesh2d.py — intra-host halo, deduped host exchange),
shards every array with named shardings, and steps the jitted sharded
train step.  With one process and N local (or virtual) devices
the same code path degenerates to the 1-host row of the mesh — which is
how the CPU virtual-mesh test drives it.
"""
from __future__ import annotations

from typing import Optional

AXES = ("host", "chip")


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> tuple:
    """Initialize ``jax.distributed`` and return
    ``(process_index, process_count)``.

    Pass all three arguments (e.g. ``localhost:<port>``, the process
    count, this process's id).  With none given this is a single-process
    run: nothing is initialized and the result is (0, 1)."""
    import jax

    args = (coordinator_address, num_processes, process_id)
    if all(a is None for a in args):
        return jax.process_index(), jax.process_count()
    if any(a is None for a in args):
        raise ValueError("init_multihost needs coordinator_address, "
                         "num_processes and process_id together")
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=int(num_processes),
                               process_id=int(process_id))
    return jax.process_index(), jax.process_count()


def train_multihost(
    ds,
    network: str = "GCN",
    *,
    hidden: int = 128,
    n_layers: int = 2,
    heads: int = 4,
    epochs: int = 20,
    lr: float = 1e-2,
    compute_dtype=None,
    seed: int = 0,
    mesh=None,
    verbose: bool = False,
):
    """Full-batch distributed training over a (hosts x chips) mesh.

    ``mesh``: an explicit 2-D Mesh with axes ("host", "chip") — default is
    process_count x local_device_count over all devices (the pod shape).
    Every process executes this function with identical arguments (SPMD);
    per-process work is its address-space shard of the jitted step.
    Returns ``(final_loss, losses)``.
    """
    import numpy as np

    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from . import (make_sharded_train_step, partition_graph_2d, pad_nodes,
                   shard_part)
    from ..models.train import TrainState
    from ..models.zoo import build_model

    if mesh is None:
        dh = jax.process_count()
        dc = jax.local_device_count()
        devs = np.array(jax.devices()).reshape(dh, dc)
        mesh = Mesh(devs, AXES)
    dh, dc = (int(mesh.shape[a]) for a in AXES)

    model = build_model(network, ds.x.shape[1], ds.n_class, hidden=hidden,
                        n_layers=n_layers, heads=heads)
    params = model.init(jax.random.key(seed))

    part_host = partition_graph_2d(ds.host_graph, dh, dc)
    part = shard_part(part_host, mesh, axis=AXES)
    sh2 = NamedSharding(mesh, P(AXES, None))
    sh1 = NamedSharding(mesh, P(AXES))
    x = jax.device_put(jnp.asarray(pad_nodes(ds.x, part_host)), sh2)
    y = jax.device_put(jnp.asarray(pad_nodes(ds.y, part_host)), sh1)
    m = jax.device_put(jnp.asarray(pad_nodes(ds.train_mask, part_host)), sh1)

    tx = optax.adam(lr)
    step = make_sharded_train_step(model.layers, mesh, tx,
                                   compute_dtype=compute_dtype, axis=AXES)
    state = TrainState(params, tx.init(params), jnp.zeros((), jnp.int32))
    losses = []
    for e in range(epochs):
        state, loss = step(state, part, x, y, m)
        if verbose and jax.process_index() == 0 and e % 5 == 0:
            print(f"epoch {e}: loss {float(loss):.4f}", flush=True)
    jax.block_until_ready(loss)
    losses.append(float(loss))
    return losses[-1], state
