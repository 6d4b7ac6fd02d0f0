"""Device ms a traced frame spends in the ab upsample, the smoother (K2)
and Lab to uint8: every operation launched inside the port's span
"frame::post"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "frame::post", "trace_frames")
