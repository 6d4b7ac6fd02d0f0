"""Device kernels in the traced window over the frames traced (a count)."""
from benchmark.readers import launches_per_frame as read  # noqa: F401
