"""The window's model FLOPs a second over the configuration's matmul peak
(``gnnbench/readers.py`` ``train_mfu``); read as ``train_mfu`` and
``train_mfu.dense``."""

from gnnbench.readers import train_mfu as read  # noqa: F401
