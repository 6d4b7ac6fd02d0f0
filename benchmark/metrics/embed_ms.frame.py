"""Device ms a traced frame spends in the query embedding (embed_queries):
every operation launched inside the port's span "frame::embed"."""
from benchmark.spans import device_ms


def read(run):
    return device_ms(run, "frame::embed", "trace_frames")
