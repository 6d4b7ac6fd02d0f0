"""ms a traced batched step in which the device idles while the scheduler
refills a slot whose clip ended (the port's span "sched::refill": probe,
reader start, the exemplar's features, the first decode); 0 when no clip
ended in the traced steps."""
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, ["sched::refill"], "trace_steps",
                   present="sched::step")
