from .partition import (PartitionedGraph, community_partition_order,
                        partition_graph, pad_nodes)
from .scaling import overlap_fraction, predicted_scaling
from .multihost import init_multihost, train_multihost
from .mesh2d import (CHIP_AXIS, HOST_AXIS, PartitionedGraph2D,
                     partition_graph_2d, remote_table_2d)
from .dist import (
    AXIS,
    remote_table,
    lower_shard,
    make_dist_apply,
    make_sharded_train_step,
    shard_part,
    shard_csr,
)
