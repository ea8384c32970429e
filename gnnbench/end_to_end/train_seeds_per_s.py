"""Labelled train seeds over the window's seconds: every epoch trains each
of the split's seeds, epoch boundaries counted in the time; read as
``train_seeds_per_s`` and ``train_seeds_per_s.dense``, the latter with a
bound of its own."""


def read(win):
    return win.labelled_seeds / win.window_s if win.kind == "train" else None
