"""ms per output frame of one clip in stream mode (host clock over the
window of a traced run, which the profiler does not touch: it traces
after the window)."""
from benchmark.readers import frame_ms as read  # noqa: F401
