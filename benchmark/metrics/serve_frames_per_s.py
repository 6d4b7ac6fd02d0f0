"""Frames the scheduler wrote inside the window, over the window."""
from benchmark.readers import served_frames_per_s as read  # noqa: F401
