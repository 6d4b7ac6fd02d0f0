"""ms a batched step in which the device did nothing (the traced window
less its busy time, over the steps traced): the scheduler's host side."""
from benchmark.readers import sched_host_ms as read  # noqa: F401
