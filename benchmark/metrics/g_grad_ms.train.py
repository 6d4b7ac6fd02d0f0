"""Device ms a traced training step spends in the generator's gradient, the
checkpointed unroll's recomputation included (kernels the autograd
engine's thread launches): every operation launched inside the port's
span "train::g_grad"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "train::g_grad", "trace_steps")
