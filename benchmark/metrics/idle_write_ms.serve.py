"""ms a traced batched step in which the device idles while the scheduler's
main loop waits on the writer's queue (the port's span
"sched::write_wait")."""
from benchmark.spans import idle_ms


def read(run):
    return idle_ms(run, ["sched::write_wait"], "trace_steps",
                   present="sched::step")
