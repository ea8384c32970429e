from .tt_shapes import (TTShapes, make_tt_shapes, suggested_tt_shapes,
                        prime_factors, factor_combinations)
from .tt_lookup import (tt_digits, tt_to_full, tt_lookup_gather,
                        tt_materialize_rows, tt_core_grads, tt_lookup_batched)
from . import tt_init
from .tt_kernels import (tt_fwd, tt_grads, tt_adam_apply, tt_fused_adam,
                         TTLookup, tt_lookup_fused, reset_launch_counts,
                         launch_counts)
from . import segment
