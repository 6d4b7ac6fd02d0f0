"""95th percentile of the interval between consecutive output frames in
stream mode (host clock over the untraced window of a traced run)."""
from benchmark.readers import frame_p95_ms as read  # noqa: F401
