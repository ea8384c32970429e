from .sage import SAGE, collect_level_ids, make_embed_layer
