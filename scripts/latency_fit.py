"""Fit the latency-model constants (compiler/latency.py LatencyConstants)
to the tuner's measured memo rows.

Every schedule reduces to the model's counts (latency.schedule_counts); the
measured latency of each memo row is fitted as a non-negative combination
of those counts (scipy.optimize.nnls), and the result printed as the
``LatencyConstants`` defaults to paste, with the rank check of each memo.

Run after regenerating the memos on the device the model is calibrated for
(compiler/latency.CALIBRATED_DEVICE):

    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu.cli tune \\
        --dataset flickr --network GCN --hidden 128 --heads 4 \\
        --memo results/memo_GCN_flickr.csv   (GAT, and --dataset cora)
    python -m gta_graph_tensor_acclelrator_for_general_gnn_tpu.cli tune \\
        --dataset reddit --communities 1000 --seed 1 --network GCN \\
        --hidden 128 --heads 4 --iters 5 --memo results/memo_GCN_reddit.csv
    python scripts/latency_fit.py

The Reddit-scale rows are what let the model see the per-edge costs: on
Cora and Flickr fixed and per-row costs dominate every candidate.  The
fit reads that graph's sizes from latency.LARGE_MEMO_GRAPHS instead of
drawing its 114.6M edges again.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
from scipy.optimize import nnls  # noqa: E402

import gta_graph_tensor_acclelrator_for_general_gnn_tpu as gta  # noqa: E402
from gta_graph_tensor_acclelrator_for_general_gnn_tpu.compiler import (  # noqa: E402,E501
    latency as L)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (memo, dataset, network) — the memos `cli tune --dataset D --network N
# --hidden 128 --heads 4` writes; graph name "<N>-original-tune"
CASES = [(f"results/memo_{net}_{ds}.csv", ds, net)
         for ds in ("flickr", "cora", "reddit") for net in ("GCN", "GAT")]


def op_graph(network: str):
    return gta.build_op_graph(network, 128, 128, heads=4, layer_tag="tune")


def main():
    rows, meas, graphs = [], [], []
    for memo, ds, net in CASES:
        stats = hg = L.memo_graph_stats(ds)
        og = op_graph(net)
        name = og.name
        graphs.append((memo, name, og, hg))
        for sched, secs in L.memo_rows(os.path.join(ROOT, memo), name):
            rows.append(L.schedule_counts(og, sched, stats))
            meas.append(secs * 1e9)
    if not rows:
        sys.exit("no memo rows for " + L.CALIBRATED_DEVICE)
    a = np.array(rows)
    b = np.array(meas)
    # relative least squares: every row weighs the same whatever its size
    coef, _ = nnls(a / b[:, None], np.ones_like(b))
    print(f"# fitted on {len(b)} rows of {L.CALIBRATED_DEVICE}")
    for f, c in zip(L.FEATURES, coef):
        print(f"    {f}: float = {c:.6g}")
    consts = L.LatencyConstants(**dict(zip(L.FEATURES, coef)))
    for memo, name, og, hg in graphs:
        r = L.rank_check(os.path.join(ROOT, memo), name, og, hg,
                         constants=consts)
        if r:
            print(f"# {memo} {name}: rows {len(r['rows'])} spearman "
                  f"{r['spearman']:.3f} regret {r['argmin_regret']:.3f}")


if __name__ == "__main__":
    main()
