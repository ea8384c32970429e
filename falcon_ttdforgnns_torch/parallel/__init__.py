"""Multi-device paths of the port (port of ``falcon_ttdforgnns_tpu/parallel``):
the process group and its ``(data, node)`` mesh (:mod:`.mesh`), ``--dist``
data parallelism (:mod:`.data_parallel`) and ``--node-shard``, the ring
SpMM over the node axis (:mod:`.node_sharding`)."""

from .data_parallel import DataParallel, data_parallel_for, scaling_efficiency
from .mesh import (NodeMesh, backend_for, destroy_process_group, init_multihost,
                   init_process_group, make_mesh, rank, resolve_data_shards, world_size)
from .node_sharding import (NodeSharding, RaggedRingLayout, RingShard,
                            balanced_row_assignment, consume, consume_transposed, dense_shard,
                            node_mesh_for, partition_edges_by_block, partition_edges_ragged,
                            ragged_shard, ring_spmm, sharded_layerwise_inference)
