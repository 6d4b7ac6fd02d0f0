"""ms per output frame of one clip (host clock over the window)."""
from benchmark.readers import frame_ms as read  # noqa: F401
