from . import timebase
from .timing import Timer, Timing

__all__ = ["timebase", "Timer", "Timing"]
