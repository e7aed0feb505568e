"""The engine's detection and description with their fetch (the program's
``2.1 detect_describe`` spans) per frame, mean over the window's frames
(those outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    return programspans.ms_per_frame(run, "2.1 detect_describe")
