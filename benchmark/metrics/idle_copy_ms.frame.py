"""ms a traced frame in which the device idles while the host uploads the
frame and downloads its output (the port's spans "clip::upload" and
"clip::download")."""
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, ["clip::upload", "clip::download"], "trace_frames",
                   present="clip::frame")
