from .sage import SAGE, collect_level_ids
