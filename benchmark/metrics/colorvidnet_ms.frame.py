"""Device ms a traced frame spends in ColorVidNet: every operation launched
inside the port's span "frame::colorvidnet"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "frame::colorvidnet", "trace_frames")
