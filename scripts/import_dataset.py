import os, sys  # noqa: E401
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Import real GNN benchmark datasets into the loader's npz schema.

This environment has zero network egress, so the published Planetoid /
OGB archives cannot be fetched here — but a user WITH the files runs
this offline and ``load_dataset(name, root=...)`` (or dropping the npz
into ``data/fixtures/``) then serves the real graph everywhere the
synthetic twin is used today.  Reference analog: the real-adjacency
preprocessing pipeline (``FinalVersion For Paper/preprocessing.py:11-39``
loads real .npy adjacency; ``preprocessing_forReditFlickr.py:1-40`` real
Reddit/Flickr npz).

Supported inputs:

  planetoid  — the ``ind.<name>.{x,tx,allx,y,ty,ally,graph,test.index}``
               pickle set (Kipf & Welling splits for cora/citeseer/pubmed)
  npz-coo    — any npz with senders/receivers/x/y (+optional masks):
               remapped/validated into the canonical schema
  ogb-nodeprop — an extracted ogbn-* directory (raw/ with edge.csv.gz,
               node-feat.csv.gz, node-label.csv.gz and split/<split>/
               {train,valid,test}.csv.gz)

Usage:
  python scripts/import_dataset.py planetoid <dir> <name> [out.npz]
  python scripts/import_dataset.py npz-coo <file.npz> <name> [out.npz]
  python scripts/import_dataset.py ogb-nodeprop <dir> <name> [out.npz]
"""
import os
import pickle

import numpy as np

FIXDIR = os.path.join(os.path.dirname(__file__), "..",
                      "gta_graph_tensor_acclelrator_for_general_gnn_tpu",
                      "data", "fixtures")


def save(out, senders, receivers, x, y, train, val, test):
    n = x.shape[0]
    assert senders.max(initial=-1) < n and receivers.max(initial=-1) < n
    assert y.shape == (n,) and train.shape == (n,)
    np.savez_compressed(
        out, senders=senders.astype(np.int32),
        receivers=receivers.astype(np.int32),
        x=np.asarray(x, np.float32), y=y.astype(np.int32),
        train_mask=train.astype(bool), val_mask=val.astype(bool),
        test_mask=test.astype(bool))
    print(f"wrote {out}: {n} nodes, {len(senders)} directed edges, "
          f"{x.shape[1]} feats, {int(y.max()) + 1} classes, "
          f"splits {int(train.sum())}/{int(val.sum())}/{int(test.sum())}")


def _dense(m):
    return np.asarray(m.todense()) if hasattr(m, "todense") else np.asarray(m)


def import_planetoid(d: str, name: str):
    """The Kipf & Welling pickle set: allx/tx row-stack with the
    test-index permutation, graph = {node: [neighbors]}."""
    def rd(suffix):
        with open(os.path.join(d, f"ind.{name}.{suffix}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, tx, allx = rd("x"), rd("tx"), rd("allx")
    y, ty, ally = rd("y"), rd("ty"), rd("ally")
    graph = rd("graph")
    test_idx = np.loadtxt(os.path.join(d, f"ind.{name}.test.index"),
                          dtype=np.int64)
    allx_d, tx_d = _dense(allx), _dense(tx)
    ally_d, ty_d = np.asarray(ally), np.asarray(ty)
    n = int(max(len(allx_d) + len(tx_d), test_idx.max() + 1))

    # tx/ty row i belongs to node test_idx[i] (the FILE order — the
    # standard vstack+reorder in the Planetoid release reduces to exactly
    # this assignment); citeseer's isolated test ids not present in the
    # file keep zero rows
    feats = np.zeros((n, allx_d.shape[1]), np.float32)
    feats[: len(allx_d)] = allx_d
    feats[test_idx] = tx_d
    labs1h = np.zeros((n, ally_d.shape[1]), np.float32)
    labs1h[: len(ally_d)] = ally_d
    labs1h[test_idx] = ty_d
    labels = labs1h.argmax(1).astype(np.int32)
    test_sorted = np.sort(test_idx)

    src, dst = [], []
    for u, nbrs in graph.items():
        for v in nbrs:
            if u != v and u < n and v < n:
                src.append(u); dst.append(v)
    senders = np.array(src, np.int32)
    receivers = np.array(dst, np.int32)

    n_train = len(_dense(x))
    train = np.zeros(n, bool); train[:n_train] = True
    val = np.zeros(n, bool); val[n_train:n_train + 500] = True
    test = np.zeros(n, bool); test[test_sorted] = True
    val &= ~test
    return senders, receivers, feats, labels, train, val, test


def import_npz_coo(path: str):
    z = np.load(path)
    s, r = z["senders"], z["receivers"]
    x, y = z["x"], z["y"]
    n = x.shape[0]
    if "train_mask" in z:
        tr, va, te = z["train_mask"], z["val_mask"], z["test_mask"]
    else:
        rng = np.random.default_rng(0)
        idx = rng.permutation(n)
        k = max(n // 10, 1)
        tr = np.zeros(n, bool); tr[idx[:k]] = True
        va = np.zeros(n, bool); va[idx[k:2 * k]] = True
        te = np.zeros(n, bool); te[idx[2 * k:]] = True
    return s, r, x, y, tr, va, te


def import_ogb_nodeprop(d: str):
    import csv
    import gzip

    def rows(path, dtype):
        with gzip.open(path, "rt") as f:
            return np.array([[dtype(v) for v in row]
                             for row in csv.reader(f)])

    raw = os.path.join(d, "raw")
    edges = rows(os.path.join(raw, "edge.csv.gz"), int)
    x = rows(os.path.join(raw, "node-feat.csv.gz"), float).astype(np.float32)
    y = rows(os.path.join(raw, "node-label.csv.gz"), int).reshape(-1)
    n = x.shape[0]
    split_dir = os.path.join(d, "split")
    sub = os.listdir(split_dir)[0]
    masks = []
    for part in ("train", "valid", "test"):
        idx = rows(os.path.join(split_dir, sub, f"{part}.csv.gz"),
                   int).reshape(-1)
        m = np.zeros(n, bool); m[idx] = True
        masks.append(m)
    return (edges[:, 0].astype(np.int32), edges[:, 1].astype(np.int32),
            x, y.astype(np.int32), *masks)


def main(argv):
    kind, src, name = argv[0], argv[1], argv[2]
    out = argv[3] if len(argv) > 3 else os.path.join(FIXDIR, f"{name}.npz")
    if kind == "planetoid":
        parts = import_planetoid(src, name)
    elif kind == "npz-coo":
        parts = import_npz_coo(src)
    elif kind == "ogb-nodeprop":
        parts = import_ogb_nodeprop(src)
    else:
        raise SystemExit(f"unknown import kind {kind!r} (see module doc)")
    save(out, *parts)


if __name__ == "__main__":
    main(sys.argv[1:])
