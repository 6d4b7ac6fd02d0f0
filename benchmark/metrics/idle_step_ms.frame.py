"""ms a traced frame in which the device idles while the host dispatches
the frame step (the port's span "clip::step"): launch-bound dispatch."""
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, ["clip::step"], "trace_frames", present="clip::frame")
