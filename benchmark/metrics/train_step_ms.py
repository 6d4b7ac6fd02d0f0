"""ms per training step (host clock over the window, loader running)."""
from benchmark.readers import step_ms as read  # noqa: F401
