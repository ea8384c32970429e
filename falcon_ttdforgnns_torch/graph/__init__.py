from .csr import (CSRGraph, NodeDataset, synthetic_dataset,
                  hard_synthetic_dataset, get_dataset, load_ogb_raw,
                  rmat_edges, DATASET_SCALES, OFFICIAL_SPLITS)
from .sampler import NeighborLoader, SampledBatch, sample_block
from .reorder import reorder_permutation, random_permutation
