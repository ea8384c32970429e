"""The window's milliseconds over the evaluate() calls it completed."""


def read(win):
    return 1e3 * win.window_s / win.calls if win.kind == "eval" else None
