"""torch.cuda.max_memory_allocated() over the window (its peak statistics
reset as the window opens), in GB (1e9 bytes): the program's working memory
with the window's inputs resident."""


def read(records):
    return None if records["peak_bytes"] is None else records["peak_bytes"] / 1e9
