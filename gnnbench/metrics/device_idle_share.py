"""The device's idle share of a unit of the untraced window, a train epoch
or an evaluate() call (``gnnbench/readers.py`` ``idle_share``); read as
``device_idle_share.train``, ``.dense`` and ``.eval``."""

from gnnbench.readers import idle_share as read  # noqa: F401
