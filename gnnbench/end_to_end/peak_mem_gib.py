"""torch.cuda.max_memory_allocated() over the window, from a reset at its
start, in GiB."""


def read(win):
    return win.peak_bytes / 2**30 if win.peak_bytes else None
