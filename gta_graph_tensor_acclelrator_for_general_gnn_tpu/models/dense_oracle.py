"""Independent dense-adjacency oracle implementations of the model zoo.

Pure numpy, no shared code with the IR lowering or the Pallas kernels — this
is the "numerical allclose vs. a reference GNN implementation" leg of the
test strategy (SURVEY §4 implication).  Small graphs only (O(N^2 F)).

Each function takes the same params dict produced by
``compiler.lower.init_params`` for the corresponding builder, the node
features ``x`` [N, F], and dense matrices derived from the graph:

* ``A_w``     [N, N]: A_w[r, s] = sum of edge_weight over edges s->r
* ``A_cnt``   [N, N]: edge multiplicity (s->r count)
"""
from __future__ import annotations

import numpy as np


def dense_mats(senders, receivers, edge_weight, n_node):
    A_w = np.zeros((n_node, n_node), np.float64)
    A_cnt = np.zeros((n_node, n_node), np.float64)
    np.add.at(A_w, (receivers, senders), edge_weight)
    np.add.at(A_cnt, (receivers, senders), 1.0)
    return A_w, A_cnt


def _leaky(x, s=0.2):
    return np.where(x >= 0, x, s * x)


def _relu(x):
    return np.maximum(x, 0)


def _elu(x):
    return np.where(x >= 0, x, np.expm1(x))


def _sf(x, name):
    return {"relu": _relu, "elu": _elu, "identity": lambda v: v}[name](x)


def gcn(params, x, A_w, tag="l0", reorder=False):
    if reorder:
        return A_w @ (x @ params[f"gcn_{tag}_w"])
    return (A_w @ x) @ params[f"gcn_{tag}_w"]


def sgc(params, x, A_w, tag="l0"):
    return (A_w @ (A_w @ x)) @ params[f"sgc_{tag}_w"]


def graphsage(params, x, A_cnt, tag="l0", final_sf="relu"):
    deg = np.maximum(A_cnt.sum(axis=1, keepdims=True), 1.0)
    mean_neigh = (A_cnt @ x) / deg
    out = mean_neigh @ params[f"sage_{tag}_wn"] + x @ params[f"sage_{tag}_ws"]
    return _sf(out, final_sf)


def gin(params, x, A_cnt, tag="l0", eps=0.1, final_sf="relu"):
    h = (1.0 + eps) * x + A_cnt @ x
    h = _relu(h @ params[f"gin_{tag}_w1"])
    return _sf(h @ params[f"gin_{tag}_w2"], final_sf)


def gat(params, x, A_cnt, tag="l0", heads=4, final_sf="relu", slope=0.2):
    """Multi-head GAT with stable softmax over incoming edges; a multi-edge
    counts once per copy (A_cnt multiplicities), as in the edge-list IR."""
    W = params[f"gat_{tag}_w"]
    A1 = params[f"gat_{tag}_asrc"]
    A2 = params[f"gat_{tag}_adst"]
    n = x.shape[0]
    HD = W.shape[1]
    D = HD // heads
    h = x @ W                                # [N, H*D]
    a_src = h @ A1                           # [N, H]
    a_dst = h @ A2                           # [N, H]
    adj = A_cnt > 0
    out = np.zeros((n, HD))
    for head in range(heads):
        e = _leaky(a_src[None, :, head] + a_dst[:, None, head], slope)  # [r, s]
        e = np.where(adj, e, -np.inf)
        m = e.max(axis=1, keepdims=True)
        m = np.where(np.isfinite(m), m, 0.0)
        ex = np.where(adj, np.exp(e - m), 0.0) * A_cnt
        denom = ex.sum(axis=1, keepdims=True)
        alpha = np.divide(ex, denom, out=np.zeros_like(ex), where=denom > 0)
        out[:, head * D:(head + 1) * D] = alpha @ h[:, head * D:(head + 1) * D]
    return _sf(out, final_sf)


def dgn(params, x, A_cnt, tag="l0", final_sf="relu"):
    We = params[f"dgn_{tag}_we"]
    Wn = params[f"dgn_{tag}_wn"]
    t = x @ Wn
    n = x.shape[0]
    O = We.shape[1]
    agg = np.zeros((n, O))
    rs, ss = np.nonzero(A_cnt)
    for r, s in zip(rs, ss):
        c = A_cnt[r, s]
        msg = (x[s] + x[r]) @ We + t[s] + t[r]
        agg[r] += c * msg
    return _sf(0.5 * agg, final_sf)


def pna(params, x, A_cnt, tag="l0", slope=0.2):
    Wsrc = params[f"pna_{tag}_wsrc"]
    Wdst = params[f"pna_{tag}_wdst"]
    Wo = params[f"pna_{tag}_wo"]
    n = x.shape[0]
    D = Wsrc.shape[1]
    ssum = np.zeros((n, D))
    smax = np.full((n, D), -np.inf)
    cnt = np.zeros((n, 1))
    rs, ss = np.nonzero(A_cnt)
    for r, s in zip(rs, ss):
        c = int(A_cnt[r, s])
        m = _leaky(x[s] @ Wsrc + x[r] @ Wdst, slope)
        for _ in range(c):
            ssum[r] += m
            cnt[r] += 1
        smax[r] = np.maximum(smax[r], m)
    smax = np.where(np.isfinite(smax), smax, 0.0)
    smean = np.divide(ssum, np.maximum(cnt, 1.0))
    comb = (ssum + smax + smean) / 3.0
    return comb @ Wo
