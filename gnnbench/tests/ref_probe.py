"""A reference module for tests: ``reference/sage.py``'s interface under
another file, counting every call of its functions and every read of its
constants.  A configuration that names this file is run through it, and
the counts show what came from here."""

from collections import Counter

from gnnbench.reference import sage

ARCH = sage.ARCH
CALLS: Counter = Counter()
FUNCTIONS = ("param_shapes", "make_weights", "train_readings", "full_graph_logits",
             "level_ids", "mask_shapes", "tower_train_flops", "tower_eval_flops")
CONSTANTS = ("CONTROLS", "ADAM_B1", "DROPOUT_SITES")


def _counted(name):
    inner = getattr(sage, name)

    def call(*args, **kw):
        CALLS[name] += 1
        return inner(*args, **kw)
    return call


for _name in FUNCTIONS:
    globals()[_name] = _counted(_name)


def __getattr__(name):
    if name in CONSTANTS:
        CALLS[name] += 1
        return getattr(sage, name)
    raise AttributeError(name)
