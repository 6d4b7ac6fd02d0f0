"""Device ms a traced frame spends in the correspondence: K1, the warp and
the similarity: every operation launched inside the port's span
"frame::corr"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "frame::corr", "trace_frames")
