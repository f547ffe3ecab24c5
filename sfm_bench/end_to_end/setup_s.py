"""Seconds from the start of the process to the first timed job: Python and
torch, the CUDA context, the kernel libraries (built on the first run in a
checkout), the inputs made from the seed, and one warm-up job of each kind
of input."""


def read(records):
    return records["setup_s"]
