"""Device ms a traced training step spends in the critic: its two forwards,
its gradient and its update: every operation launched inside the port's
span "train::critic"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "train::critic", "trace_steps")
