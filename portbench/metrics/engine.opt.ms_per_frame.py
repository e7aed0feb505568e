"""The engine's optimization (the program's ``3.1 optimization`` spans:
upload, the LM program's dispatch, its fetch and the write-back) per frame,
mean over the window's frames (those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    return programspans.ms_per_frame(run, "3.1 optimization")
