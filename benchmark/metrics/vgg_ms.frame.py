"""Device ms a traced frame spends in the gray frame's VGG19 taps: every
operation launched inside the port's span "frame::vgg"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "frame::vgg", "trace_frames")
