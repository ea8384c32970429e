from .csr import (CSRGraph, NodeDataset, synthetic_dataset,
                  hard_synthetic_dataset, get_dataset, load_ogb_raw,
                  rmat_edges, DATASET_SCALES, OFFICIAL_SPLITS)
from .sampler import NeighborLoader, SampledBatch, sample_block
from .reorder import (reorder_permutation, reorder_permutation_cached,
                      partition_reorder, recursive_partition_reorder, rcmk_reorder,
                      degree_reorder, random_permutation, louvain_partition_reorder,
                      partition_graph)
