"""Device ms a traced training step spends in the generator's loss against
the updated critic: every operation launched inside the port's span
"train::g_loss"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "train::g_loss", "trace_steps")
