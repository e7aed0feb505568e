"""The engine's association and speculative stereo with their fetch (the
program's ``2.4 matching`` spans) per frame, mean over the window's frames
(those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    return programspans.ms_per_frame(run, "2.4 matching")
