import os, sys  # noqa: E401
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
"""Build the checked-in REAL-graph fixtures (no network needed — both
datasets ship inside packages baked into the image):

* ``karate`` — Zachary's karate club (networkx): a REAL social network
  (34 members, 78 observed friendships) with the REAL post-split club
  membership as labels.  The classic semi-supervised anchor: train on
  the two leaders only (node 0 = Mr. Hi, node 33 = Officer); published
  GCN-style results recover the split for all but the boundary member
  (node 8) — accuracy ~0.97 (Kipf & Welling 2017 demo setup).
* ``digits`` — sklearn's real handwritten-digits bitmaps (1,797 images,
  UCI optdigits) as a symmetrised 8-NN graph over raw pixels; labels
  are the true digit classes.  Real features + a derived graph: the
  standard construction for graph-based semi-supervised learning
  benchmarks.

Writes gta_graph_tensor_acclelrator_for_general_gnn_tpu/data/fixtures/
{karate,digits}.npz in the loader's real-npz schema
(data/datasets.py:137-144).  Reference analog: the real-adjacency
preprocessing pipeline (FinalVersion For Paper/preprocessing.py:11-39).
"""
import os

import numpy as np

OUT = os.path.join(os.path.dirname(__file__), "..",
                   "gta_graph_tensor_acclelrator_for_general_gnn_tpu",
                   "data", "fixtures")
os.makedirs(OUT, exist_ok=True)


def save(name, senders, receivers, x, y, train, val, test):
    path = os.path.join(OUT, f"{name}.npz")
    np.savez_compressed(
        path, senders=senders.astype(np.int32),
        receivers=receivers.astype(np.int32), x=x, y=y.astype(np.int32),
        train_mask=train, val_mask=val, test_mask=test)
    print(f"{name}: {len(y)} nodes, {len(senders)} directed edges, "
          f"{x.shape[1]} feats, {y.max()+1} classes, "
          f"{os.path.getsize(path)/1024:.0f} KiB -> {path}")


# --- karate -----------------------------------------------------------------
import networkx as nx

G = nx.karate_club_graph()
n = G.number_of_nodes()
e = np.array(G.edges(), np.int32)
senders = np.concatenate([e[:, 0], e[:, 1]])
receivers = np.concatenate([e[:, 1], e[:, 0]])
y = np.array([0 if G.nodes[i]["club"] == "Mr. Hi" else 1 for i in range(n)])
x = np.eye(n, dtype=np.float32)          # identity features (Kipf demo)
train = np.zeros(n, bool); train[[0, 33]] = True      # the two leaders
val = np.zeros(n, bool); val[[1, 32]] = True
test = ~(train | val)
save("karate", senders, receivers, x, y, train, val, test)

# --- digits -----------------------------------------------------------------
from sklearn.datasets import load_digits
from sklearn.neighbors import kneighbors_graph

d = load_digits()
xf = d.data.astype(np.float32)           # raw 0..16 pixel counts
A = kneighbors_graph(xf, n_neighbors=8, mode="connectivity",
                     include_self=False)
A = A + A.T                              # symmetrise
A = A.tocoo()
senders, receivers = A.col.astype(np.int32), A.row.astype(np.int32)
y = d.target.astype(np.int32)
rng = np.random.default_rng(0)
idx = rng.permutation(len(y))
n_tr, n_va = len(y) // 10, len(y) // 10
train = np.zeros(len(y), bool); train[idx[:n_tr]] = True
val = np.zeros(len(y), bool); val[idx[n_tr:n_tr + n_va]] = True
test = np.zeros(len(y), bool); test[idx[n_tr + n_va:]] = True
# store pixels as uint8 (0..16) — the loader casts to f32
save("digits", senders, receivers, xf.astype(np.uint8), y, train, val, test)
