from .timing import Timer, Timing

__all__ = ["Timer", "Timing"]
