from .layers import SAGEConv
from .tt_embedding import TTEmbeddingBag
