"""Distributed execution: shard_map lowering of the IR over a device mesh.

The reference has no multi-device execution of any kind (SURVEY §2); this is
the scaling layer.  The op graph lowers to a *per-shard* JAX
function over the :class:`~.partition.PartitionedGraph` split-edge layout:

  * edge-domain values are PAIRS ``(local_vals [EL, F], remote_vals [ER, F])``
    — local-edge compute depends only on ``x_local``, so XLA's scheduler can
    run the whole local chain while the halo/hub collectives for the remote
    chain are still in flight (comm/compute overlap by dependence structure,
    not hand-written double buffering);
  * apply_node / apply_edge: purely local (mapped over both halves);
  * gather: two local segment reductions (edges live with their receiver)
    summed — the remote half is the only consumer of the exchange;
  * scatter(order=C): local half takes from ``x_local``; remote half takes
    from the combined ``[all_to_all halo ‖ all_gather hubs ‖ 0]`` table
    (hub replication bounds the per-pair halo width — partition.py);
  * scatter(order=R): local takes on both halves (receivers are local).

Parameters are replicated (in_spec P()); their gradient transpose inserts the
psum across shards, so ``jax.grad`` through the shard_mapped forward is the
data-parallel gradient — no hand-written collectives in the training step.

``use_kernels=True`` routes the dominant local aggregation pattern
(scatter(C) [-> MUL edge_weight] -> gather(ADD), the SpMM of GCN/SAGE/GIN)
and the GAT attention chain through the CSR kernels on each shard's local
edges — the multi-device execution path shares the single-device kernels.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import ir
from ..ops import primitives as Pr
from .partition import PartitionedGraph

AXIS = "graph"


def _sq(a):
    """Drop the per-device leading dim (1) of a sharded [D, ...] array."""
    return a[0]


def remote_table(x_local: jax.Array, sh, axis=AXIS,
                 quantize: bool = False) -> jax.Array:
    """Exchange boundary rows; returns the combined remote source table
    [D*H + D*Kh + 1, F] (halo rows, hub rows, zero dump row).

    A :class:`~.mesh2d.PartitionedGraph2D` routes to the hierarchical
    per-axis exchange (``axis`` is then the (host, chip) tuple).

    ``quantize``: transmit int8 payloads + per-row scales (parallel/
    qcomm.py) — halves the bf16 exchange bytes on the saturated-halo
    regime at <= 0.8%-of-row-max element error."""
    from .mesh2d import (CHIP_AXIS, HOST_AXIS, PartitionedGraph2D,
                         remote_table_2d)
    if isinstance(sh, PartitionedGraph2D):
        ha, ca = (axis if isinstance(axis, (tuple, list))
                  else (HOST_AXIS, CHIP_AXIS))
        return remote_table_2d(x_local, sh, ha, ca, quantize=quantize)
    from .qcomm import q8_all_gather, q8_all_to_all
    send_idx = _sq(sh.send_idx)                       # [D, H]
    send_mask = _sq(sh.send_mask)                     # [D, H]
    send = jnp.take(x_local, send_idx, axis=0)        # [D, H, F]
    send = jnp.where(send_mask[..., None], send, 0.0).astype(x_local.dtype)
    halo = (q8_all_to_all(send, axis) if quantize
            else jax.lax.all_to_all(send, axis, split_axis=0, concat_axis=0))
    halo = halo.reshape(-1, x_local.shape[-1])        # [D*H, F]

    hub_src = jnp.take(x_local, _sq(sh.hub_idx), axis=0)   # [Kh, F]
    hub_src = jnp.where(_sq(sh.hub_mask)[:, None], hub_src, 0.0)
    hub_src = hub_src.astype(x_local.dtype)
    hubs = (q8_all_gather(hub_src, axis) if quantize
            else jax.lax.all_gather(hub_src, axis))
    hubs = hubs.reshape(-1, x_local.shape[-1])        # [D*Kh, F]

    dump = jnp.zeros((1, x_local.shape[-1]), x_local.dtype)
    return jnp.concatenate([halo, hubs, dump], axis=0)


def _scatter_c(v_node, sh: PartitionedGraph, axis: str,
               quantize: bool = False):
    dump = jnp.zeros((1, v_node.shape[-1]), v_node.dtype)
    loc = jnp.take(jnp.concatenate([v_node, dump], axis=0),
                   _sq(sh.el_src), axis=0)
    rem = jnp.take(remote_table(v_node, sh, axis, quantize=quantize),
                   _sq(sh.er_src), axis=0)
    return (loc, rem)


def _scatter_r(v_node, sh: PartitionedGraph):
    dump = jnp.zeros((1, v_node.shape[-1]), v_node.dtype)
    table = jnp.concatenate([v_node, dump], axis=0)
    return (jnp.take(table, _sq(sh.el_dst), axis=0),
            jnp.take(table, _sq(sh.er_dst), axis=0))


def _gather(v_edge, sh: PartitionedGraph, reduce: str) -> jax.Array:
    vl, vr = v_edge
    dl, dr = _sq(sh.el_dst), _sq(sh.er_dst)
    num = sh.n_local + 1
    if reduce == ir.ADD:
        out = (jax.ops.segment_sum(vl, dl, num)
               + jax.ops.segment_sum(vr, dr, num))
    elif reduce == ir.MAX:
        out = jnp.maximum(jax.ops.segment_max(vl, dl, num),
                          jax.ops.segment_max(vr, dr, num))
        out = jnp.where(jnp.isfinite(out), out, jnp.zeros_like(out))
    elif reduce == ir.MEAN:
        s = (jax.ops.segment_sum(vl, dl, num)
             + jax.ops.segment_sum(vr, dr, num))
        d = (jax.ops.segment_sum(_sq(sh.el_mask).astype(vl.dtype), dl, num)
             + jax.ops.segment_sum(_sq(sh.er_mask).astype(vr.dtype), dr, num))
        out = s / jnp.maximum(d, 1.0)[:, None]
    else:
        raise ValueError(f"bad gather reduce {reduce}")
    return out[: sh.n_local]


def _spmm_local_kernel(h, sh: PartitionedGraph, csrs):
    """Local-edge aggregation through the CSR SpMM kernel (per-shard
    CsrGraph built by :func:`shard_csr`; its weights are the real edge
    weights).  Its VJP is the XLA segment-op transpose over the shard's
    local edge arrays."""
    from ..ops import spmm as spmm_mod
    return spmm_mod.spmm(jax.tree.map(_sq, csrs), h)[: sh.n_local]


def _leaky(v, slope: float):
    return jnp.where(v >= 0, v, slope * v)


def _gat_local_kernel(h, a_s, a_d, msrc, sh: PartitionedGraph, csrs,
                      slope: float):
    """Local-edge attention PARTIALS [n_local, HD+H] = [num ‖ den] through
    the CSR attention kernel under the mesh-global shift bound ``msrc``
    (pmax of per-shard a_src maxima) — so the remote partial computed in
    XLA adds EXACTLY (same per-row bound b[r] = leaky(msrc + a_dst[r]);
    ops/gat.py module docstring).

    VJP = autodiff of the XLA num/den partial over the shard's local edge
    arrays — includes the msrc dependence, whose contributions cancel only
    after the outer normalise, so it must flow."""
    from ..ops import gat as gat_mod
    from ..ops.backend import zero_cotangent
    cg = jax.tree.map(_sq, csrs)
    n_l = sh.n_local
    H = a_d.shape[1]
    HD = h.shape[1]
    D_ = HD // H
    dts = (h.dtype, a_s.dtype, a_d.dtype, msrc.dtype)

    def local_ref(hv, sv, dv, ms, el_src, el_dst, el_mask):
        f32 = jnp.float32
        pad1 = jnp.zeros((1, H), f32)
        padh = jnp.zeros((1, HD), f32)
        hs = jnp.take(jnp.concatenate([hv.astype(f32), padh], 0),
                      el_src, axis=0)
        asr = jnp.take(jnp.concatenate([sv.astype(f32), pad1], 0),
                       el_src, axis=0)
        ads = jnp.take(jnp.concatenate([dv.astype(f32), pad1], 0),
                       el_dst, axis=0)
        e = _leaky(asr + ads, slope)
        bound = _leaky(ms.astype(f32) + dv.astype(f32), slope)  # [n_l, H]
        b = jnp.take(jnp.concatenate([bound, pad1], 0), el_dst, axis=0)
        p = jnp.where(el_mask[:, None], jnp.exp(e - b), 0.0)
        num = jax.ops.segment_sum(jnp.repeat(p, D_, axis=1) * hs,
                                  el_dst, n_l + 1)
        den = jax.ops.segment_sum(p, el_dst, n_l + 1)
        return jnp.concatenate([num, den], axis=1)[: n_l]

    @jax.custom_vjp
    def f(hv, sv, dv, ms, el_src, el_dst, el_mask, cgv):
        num, den = gat_mod.gat_partials(cgv, hv, sv, dv, ms,
                                        negative_slope=slope)
        return jnp.concatenate([num, den], axis=1)[: n_l]

    def fwd(hv, sv, dv, ms, el_src, el_dst, el_mask, cgv):
        return (f(hv, sv, dv, ms, el_src, el_dst, el_mask, cgv),
                (hv, sv, dv, ms, el_src, el_dst, el_mask, cgv))

    def bwd(res, gy):
        hv, sv, dv, ms, el_src, el_dst, el_mask, cgv = res
        _, vjp = jax.vjp(
            lambda a, b, c, m: local_ref(a, b, c, m, el_src, el_dst,
                                         el_mask), hv, sv, dv, ms)
        dh, ds, dd, dm = vjp(gy.astype(jnp.float32))
        return ((dh.astype(dts[0]), ds.astype(dts[1]), dd.astype(dts[2]),
                 dm.astype(dts[3]))
                + zero_cotangent((el_src, el_dst, el_mask))
                + (zero_cotangent(cgv),))

    f.defvjp(fwd, bwd)
    return f(h, a_s, a_d, msrc, _sq(sh.el_src), _sq(sh.el_dst),
             _sq(sh.el_mask), cg)


def lower_shard(
    graph: ir.OpGraph,
    compute_dtype=None,
    axis: str = AXIS,
    use_kernels: bool = False,
    csrs=None,
    gat_csrs=None,
    quantize_halo: bool = False,
) -> Callable:
    """Lower an OpGraph to a per-shard function ``fn(params, sh, x_local)``
    for use inside shard_map.  Mirrors compiler.lower but with the scatter /
    gather primitives replaced by their halo-partitioned equivalents.

    ``use_kernels`` + ``csrs`` (weighted :func:`shard_csr`): the SpMM
    aggregation pattern executes its LOCAL edges through the CSR SpMM
    kernel; remote edges stay on the XLA segment path.

    ``gat_csrs`` (unit-weight shard_csr): the GAT attention chain's local
    edges run the CSR attention kernel as [num ‖ den] PARTIALS under a
    mesh-global (pmax) shift bound; the remote-edge partial adds exactly
    and the combine normalises once — multi-device attention through the
    single-device kernel."""
    order = graph.topo_order()
    outputs = list(graph.outputs)

    gat_plan = None
    if use_kernels and gat_csrs is not None:
        from ..ops.gat import find_gat_chain
        plan = find_gat_chain(graph)
        if plan is not None:
            # internal chain values must not escape (only out_op is
            # materialised by the fused route)
            consumers = {op.op_id: set() for op in graph.ops}
            for op in graph.ops:
                for i in op.inputs:
                    if i in consumers:
                        consumers[i].add(op.op_id)
            internal = plan.ops - {plan.out_op}
            escapes = (any(consumers[o] - plan.ops for o in internal)
                       or (internal & set(graph.outputs)))
            if not escapes:
                gat_plan = plan

    # match scatter(C) -> [MUL edge_weight ->] gather(ADD) chains for the
    # kernel route (ids resolved at lowering time, not per call)
    kernel_chains = {}
    if use_kernels and csrs is not None:
        for op in graph.ops:
            if op.kind != ir.GATHER or op.compute != ir.ADD:
                continue
            src = graph.by_id.get(op.inputs[0]) if op.inputs else None
            weighted = False
            sc = src
            if (src is not None and src.kind == ir.APPLY_EDGE
                    and src.compute == ir.MUL
                    and ir.EDGE_WEIGHT in src.inputs):
                inner = [i for i in src.inputs if i != ir.EDGE_WEIGHT]
                sc = graph.by_id.get(inner[0]) if inner else None
                weighted = True
            # tile weights carry el_w, so only the weighted chain routes to
            # the kernel (an unweighted sum would wrongly apply them)
            if (weighted and sc is not None and sc.kind == ir.SCATTER
                    and sc.order == "C" and sc.compute == ir.NONE
                    and len(sc.inputs) == 1):
                kernel_chains[op.op_id] = (sc.inputs[0], weighted)

    def apply(params: Dict[str, jax.Array], sh: PartitionedGraph,
              x: jax.Array, csrs_shard=None, gat_csrs_shard=None):
        # csrs_shard: the per-shard [1, ...] CSR pytree passed THROUGH
        # shard_map (a closure over the stacked array would silently give
        # every device shard 0's graph)
        csrs_in = csrs_shard if csrs_shard is not None else csrs
        gat_csrs_in = (gat_csrs_shard if gat_csrs_shard is not None
                        else gat_csrs)
        vals: Dict[int, object] = {}

        def ref(i: int):
            if i == ir.X_INPUT:
                return x
            if i == ir.EDGE_WEIGHT:
                return (_sq(sh.el_w)[:, None], _sq(sh.er_w)[:, None])
            return vals[i]

        def emap(f, *ins):
            """Map an elementwise op over the (local, remote) edge halves;
            node-domain operands broadcast by... never occur (domains are
            checked by ir.validate)."""
            return (f(*[a[0] for a in ins]), f(*[a[1] for a in ins]))

        for oid in order:
            op = graph.by_id[oid]
            if gat_plan is not None and oid in gat_plan.ops:
                if oid != gat_plan.out_op:
                    continue      # internal chain value: never materialised
                f32 = jnp.float32
                h = ref(gat_plan.h_op)
                a_s = ref(gat_plan.asrc_op)
                a_d = ref(gat_plan.adst_op)
                if compute_dtype is not None:
                    h = h.astype(compute_dtype)
                H = a_d.shape[1]
                HD = h.shape[1]
                D_ = HD // H
                slope = gat_plan.negative_slope
                # mesh-global shift bound (both partials must share it).
                # stop_gradient is EXACT, not an approximation: the final
                # out = num/den is invariant to the shift (both partials
                # scale by exp(-b)), so d out/d msrc == 0 analytically —
                # and pmax has no differentiation rule anyway
                # (stop_gradient on the INPUT: pmax has no JVP rule, and a
                # symbolically-zero tangent skips it entirely)
                msrc = jax.lax.pmax(
                    jnp.max(jax.lax.stop_gradient(a_s).astype(f32),
                            axis=0, keepdims=True), axis)
                acc = _gat_local_kernel(h, a_s, a_d, msrc, sh,
                                        gat_csrs_in, slope)
                # remote partial (XLA): ONE exchange carries [h ‖ a_src]
                cat = jnp.concatenate(
                    [h.astype(f32), a_s.astype(f32)], axis=1)
                rem = jnp.take(remote_table(cat, sh, axis,
                                            quantize=quantize_halo),
                               _sq(sh.er_src), axis=0)
                hr, asr = rem[:, :HD], rem[:, HD:]
                pad1 = jnp.zeros((1, H), f32)
                ads = jnp.take(
                    jnp.concatenate([a_d.astype(f32), pad1], 0),
                    _sq(sh.er_dst), axis=0)
                e = _leaky(asr + ads, slope)
                bound = _leaky(msrc + a_d.astype(f32), slope)
                b = jnp.take(jnp.concatenate([bound, pad1], 0),
                             _sq(sh.er_dst), axis=0)
                p = jnp.where(_sq(sh.er_mask)[:, None], jnp.exp(e - b), 0.0)
                num_r = jax.ops.segment_sum(
                    jnp.repeat(p, D_, axis=1) * hr, _sq(sh.er_dst),
                    sh.n_local + 1)
                den_r = jax.ops.segment_sum(p, _sq(sh.er_dst),
                                            sh.n_local + 1)
                acc = acc + jnp.concatenate(
                    [num_r, den_r], axis=1)[: sh.n_local]
                num, den = acc[:, :HD], acc[:, HD:]
                vals[oid] = num / jnp.repeat(
                    jnp.maximum(den, 1e-20), D_, axis=1)
                continue
            if oid in kernel_chains:
                in_ref, weighted = kernel_chains[oid]
                h = ref(in_ref)
                if compute_dtype is not None:
                    h = h.astype(compute_dtype)
                y_loc = _spmm_local_kernel(h, sh, csrs_in)
                # remote half via the XLA segment path
                vr = jnp.take(remote_table(h, sh, axis,
                                           quantize=quantize_halo),
                              _sq(sh.er_src), axis=0)
                if weighted:
                    vr = vr * _sq(sh.er_w)[:, None]
                y_rem = jax.ops.segment_sum(
                    vr.astype(jnp.float32), _sq(sh.er_dst), sh.n_local + 1)
                vals[oid] = y_loc + y_rem[: sh.n_local]
                continue
            ins = [ref(i) for i in op.inputs] if op.inputs else [x]
            if op.kind == ir.SCATTER:
                v = _scatter_c(ins[0], sh, axis, quantize_halo) \
                    if op.order == "C" \
                    else _scatter_r(ins[0], sh)
            elif op.kind == ir.GATHER:
                v = _gather(ins[0], sh, op.compute)
            elif op.compute == ir.NONE:
                v = ins[0]
            elif op.compute == ir.MM:
                name, _, _ = op.extra["weight"]
                mfn = lambda a: Pr.dense_mm(a, params[name], compute_dtype)
                v = emap(mfn, ins[0]) if op.out_domain == ir.EDGE else mfn(ins[0])
            elif op.compute == ir.SF:
                fn = lambda a: Pr.special_function(
                    a, op.extra.get("sf", "relu"),
                    op.extra.get("negative_slope", 0.2))
                v = emap(fn, ins[0]) if op.out_domain == ir.EDGE else fn(ins[0])
            elif op.compute in (ir.ADD, ir.MUL, ir.SUB, ir.DIV):
                bfn = lambda *a: Pr.binary_op(op.compute, *a)
                if op.out_domain == ir.EDGE:
                    if len(ins) == 2:
                        v = emap(bfn, ins[0], ins[1])
                    else:
                        c = jnp.asarray(op.extra["const"])
                        v = emap(lambda a: Pr.binary_op(
                            op.compute, a, jnp.broadcast_to(
                                c.astype(a.dtype), (1, 1))), ins[0])
                else:
                    if len(ins) == 2:
                        v = bfn(ins[0], ins[1])
                    else:
                        c = jnp.asarray(op.extra["const"], ins[0].dtype)
                        v = bfn(ins[0], jnp.broadcast_to(c, (1, 1)))
            else:
                raise ValueError(f"op {op.op_id}: unhandled compute {op.compute}")
            vals[oid] = v
        if len(outputs) == 1:
            return vals[outputs[0]]
        return {o: vals[o] for o in outputs}

    return apply


def shard_csr(part_host, *, unit_weight: bool = False):
    """Per-shard :class:`~..graph.CsrGraph` over LOCAL edges, stacked on a
    leading D axis with uniform edge and piece counts (the max over shards)
    so one shard_map program serves every device.  Shorter shards pad with
    empty pieces on the dump row.

    ``unit_weight``: weights forced to 1 (the attention chain).

    Pass HOST numpy views of the partition's el_* arrays (the
    PartitionedGraph built on the host before shard_part ships it)."""
    import dataclasses as _dc
    import numpy as np
    from ..graph import HostGraph, csr_graph, csr_pieces

    el_src = np.asarray(part_host.el_src)
    el_dst = np.asarray(part_host.el_dst)
    el_w = np.asarray(part_host.el_w)
    el_mask = np.asarray(part_host.el_mask)
    D = el_src.shape[0]
    n_local = part_host.n_local
    e_pad = el_src.shape[1]

    hosts = []
    for d in range(D):
        m = el_mask[d]
        ne = int(m.sum())
        order = np.argsort(el_dst[d][m], kind="stable")
        pad = e_pad - ne
        hosts.append(HostGraph(
            senders=np.concatenate(
                [el_src[d][m][order], np.full(pad, n_local, np.int32)]),
            receivers=np.concatenate(
                [el_dst[d][m][order], np.full(pad, n_local, np.int32)]),
            edge_mask=np.concatenate([np.ones(ne, bool),
                                      np.zeros(pad, bool)]),
            edge_weight=np.concatenate(
                [el_w[d][m][order], np.zeros(pad, np.float32)]
            ).astype(np.float32),
            n_node=n_local,
            n_edge=ne,
        ))
    n_pieces = max(len(csr_pieces(hg)[0]) for hg in hosts) + 1
    per = [_dc.replace(csr_graph(hg, unit_weight=unit_weight,
                                 n_pieces=n_pieces), split=True)
           for hg in hosts]
    return jax.tree.map(lambda *xs: jnp.stack(xs), *per)


def make_dist_apply(
    layers: List[ir.OpGraph],
    mesh: Mesh,
    compute_dtype=None,
    axis: str = AXIS,
    use_kernels: bool = False,
    csrs=None,
    gat_csrs=None,
    quantize_halo: bool = False,
) -> Callable:
    """Build the mesh-wide forward ``apply(params, part, x) -> logits``.

    ``part`` is the full PartitionedGraph ([D, ...] arrays), ``x`` the padded
    [D*n_local, F] node features; both should be device_put with P(axis)
    shardings (see :func:`shard_part`).  Output is [D*n_local, n_out] sharded
    the same way.
    """
    fns = [lower_shard(g, compute_dtype, axis, use_kernels, csrs,
                       gat_csrs, quantize_halo=quantize_halo)
           for g in layers]

    def local_forward(params, sh, x_local, *csr_args):
        ts = gts = None
        if csrs is not None and gat_csrs is not None:
            ts, gts = csr_args
        elif csrs is not None:
            ts, = csr_args
        elif gat_csrs is not None:
            gts, = csr_args
        h = x_local
        for fn in fns:
            h = fn(params, sh, h, ts, gts)
        return h

    in_specs = [P(), P(axis), P(axis, None)]
    args = ()
    if csrs is not None:
        in_specs.append(P(axis))
        args = args + (csrs,)
    if gat_csrs is not None:
        in_specs.append(P(axis))
        args = args + (gat_csrs,)

    def wrapper(params, part, x):
        fn = jax.shard_map(
            local_forward,
            mesh=mesh,
            in_specs=tuple(in_specs),
            out_specs=P(axis, None),
            check_vma=False,
        )
        return fn(params, part, x, *args)

    return wrapper


def shard_part(part, mesh: Mesh, axis: str = AXIS):
    """device_put every array leaf of a pytree with its P(axis) sharding."""
    def put(leaf):
        spec = P(axis, *([None] * (leaf.ndim - 1)))
        return jax.device_put(leaf, NamedSharding(mesh, spec))
    return jax.tree.map(put, part)


def make_sharded_train_step(
    layers: List[ir.OpGraph],
    mesh: Mesh,
    tx,
    compute_dtype=None,
    axis: str = AXIS,
    use_kernels: bool = False,
    csrs=None,
    gat_csrs=None,
    quantize_halo: bool = False,
) -> Callable:
    """Full distributed training step: forward via shard_map (halo all_to_all
    + hub all_gather inside), masked CE on the node-sharded logits, grads
    (the replicated-param transpose inserts the cross-shard psum), optax
    update.  Jit once over the mesh; all arrays keep their NamedShardings."""
    from ..models.train import TrainState, masked_cross_entropy

    fwd = make_dist_apply(layers, mesh, compute_dtype, axis,
                          use_kernels, csrs, gat_csrs,
                          quantize_halo=quantize_halo)

    def step(state: TrainState, part: PartitionedGraph, x, y, mask):
        def loss_fn(params):
            logits = fwd(params, part, x)
            return masked_cross_entropy(logits, y, mask)

        loss, grads = jax.value_and_grad(loss_fn)(state.params)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        import optax
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    return jax.jit(step, donate_argnums=0)
