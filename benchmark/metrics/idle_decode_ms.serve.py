"""ms a traced batched step in which the device idles while the scheduler's
main loop waits on a decode thread (the port's span
"sched::decode_wait")."""
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, ["sched::decode_wait"], "trace_steps",
                   present="sched::step")
