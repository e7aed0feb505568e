"""The engine's IMU preintegration and propagation dispatch (the program's
``2.3 preint`` spans) per frame, mean over the window's frames (those
outside a profiled stretch), in ms."""
from portbench import programspans


def read(run):
    return programspans.ms_per_frame(run, "2.3 preint")
