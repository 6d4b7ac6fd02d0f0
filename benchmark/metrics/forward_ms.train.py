"""Device ms a traced training step spends in the forward: the batch's
preprocessing, the exemplar's VGG taps and the two-frame unroll: every
operation launched inside the port's span "train::forward"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "train::forward", "trace_steps")
