"""GTA: a graph tensor acceleration framework for general GNNs.

A from-scratch reimplementation of the capabilities of
``Jagnate/GTA_graph_tensor_acclelrator_for_general_GNN`` — the 4-primitive
message-passing IR, 7-family model zoo, fusion/tiling schedule search, and
latency/traffic observability — with the simulated accelerator replaced by
real execution on a GPU: XLA for dense/elementwise paths, CSR Pallas
kernels (Triton route) for the sparse gather-reduce hot ops, and
jax.sharding/shard_map for multi-device scaling (which the reference does
not have at all).
"""

from . import ir
from . import ir_io
from .graph import (
    CsrGraph, GraphTensor, HostGraph,
    build_graph, build_host_graph, csr_graph,
    nnz_histogram, reorder_nodes, cluster_labels,
)
from .models.builders import build_op_graph, NETWORKS
from .models.zoo import build_model, Model
from .compiler.lower import lower, init_params
from .compiler.schedule import Schedule, TileConfig, default_schedule
from .compiler.fusion import lower_schedule
from .data.datasets import load_dataset, Dataset, DATASET_STATS

__version__ = "0.1.0"
