"""Run a function on several ranks of one machine, each a process of its
own (what `torchrun --nproc_per_node N` does for a script, for a function).

    results = spawn_ranks(fn, world=2, args=(x,), device="cpu", timeout=120)

Each rank is a fresh interpreter (the "spawn" start method: a parent that
has threads, or JAX loaded, must not fork). It joins a process group on
localhost (`mesh.init_distributed`: gloo on the CPU or when the ranks
share a card, NCCL when each has its own), calls fn(ctx, *args) with its
`DistContext`, and sends back the result, which must pickle. fn is
pickled by its import path, so it lives at the top level of a module that
the ranks can import.

The parent waits at most `timeout` seconds in all. Any rank that raises,
dies or is still running then fails the call: the others are killed, and
RankFailure carries each failed rank's traceback. Nothing is left running.
"""

from __future__ import annotations

import datetime
import multiprocessing
import queue as queue_mod
import socket
import time
import traceback


class RankFailure(RuntimeError):
    pass


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, port, device, collective_s, args, results):
    import torch.distributed as dist

    from devc_tpu_torch.parallel.mesh import init_distributed

    try:
        ctx = init_distributed(
            device, timeout=datetime.timedelta(seconds=collective_s),
            init_method=f"tcp://localhost:{port}", rank=rank,
            world_size=world)
        out = fn(ctx, *args)
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, then the rank exits
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, world: int, args=(), device: str = "cpu",
                timeout: float = 600.0, collective_timeout: float = 60.0):
    """fn(ctx, *args) on `world` ranks; returns the results in rank order.
    collective_timeout: seconds a rank waits at one collective (or at the
    group's start-up) before it raises."""
    mp = multiprocessing.get_context("spawn")
    results = mp.Queue()
    port = free_port()
    procs = [mp.Process(target=_rank_main,
                        args=(fn, r, world, port, device, collective_timeout,
                              args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    got, failures = {}, {}
    try:
        # drain the queue before joining: a child blocks on a full pipe;
        # the first failure ends the wait (the other ranks would only
        # reach their collective timeout)
        while len(got) < world and not failures:
            left = deadline - time.monotonic()
            if left <= 0:
                break
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                # a rank that died without reporting (killed, crashed)
                for r, p in enumerate(procs):
                    if p.exitcode not in (None, 0) and r not in got:
                        time.sleep(0.5)  # its report may be in flight
                        if results.empty():
                            failures[r] = f"exited with code {p.exitcode}"
                continue
            (got if ok else failures)[rank] = out
        if not failures:
            for r in range(world):
                if r not in got:
                    failures[r] = f"no result within {timeout:.0f} s"
        for p in procs:
            p.join(max(0.0, min(5.0, deadline - time.monotonic())))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        results.close()
    if failures:
        raise RankFailure("; ".join(
            f"rank {r}: {failures[r]}" for r in sorted(failures)))
    return [got[r] for r in range(world)]
