"""Process start to the window's start: the graph read (or made, in a
checkout's first run), the weights, the trainer, the kernels' build (in
a checkout's first run) and the cell's warm-up."""


def read(win):
    return win.setup_s
