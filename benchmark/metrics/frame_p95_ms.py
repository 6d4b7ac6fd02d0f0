"""95th percentile of the interval between consecutive output frames."""
from benchmark.readers import frame_p95_ms as read  # noqa: F401
