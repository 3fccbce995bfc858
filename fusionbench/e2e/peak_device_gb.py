"""The card memory the window needed: ``torch.cuda.max_memory_allocated()``
over the window, its count reset at the window's start with the grid
already allocated, in GB (1e9 bytes)."""


def read(rec):
    return rec["peak_bytes"] / 1e9
