from .layers import SAGEConv
from .tt_embedding import (AccessCountingEmbedding, DenseEmbedding, FixedFeatureEmbedding,
                           TableBatchedTTEmbeddingBag, TTEmbeddingBag)
