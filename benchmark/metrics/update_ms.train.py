"""Device ms a traced training step spends in the generator's optimizer
update: every operation launched inside the port's span "train::update"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "train::update", "trace_steps")
