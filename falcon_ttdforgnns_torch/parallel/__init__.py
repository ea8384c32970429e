"""Multi-device paths of the port (port of ``falcon_ttdforgnns_tpu/parallel``):
the process group (:mod:`.mesh`) and ``--dist`` data parallelism
(:mod:`.data_parallel`).  ``--node-shard`` (the JAX package's
``node_sharding.py``) is ROADMAP A8.3."""

from .data_parallel import DataParallel, data_parallel_for, scaling_efficiency
from .mesh import (backend_for, destroy_process_group, init_multihost,
                   init_process_group, rank, world_size)
