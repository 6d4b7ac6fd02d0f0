"""Frames the scheduler wrote inside the window, over the window (host
clock over the untraced window of a traced run)."""
from benchmark.readers import served_frames_per_s as read  # noqa: F401
