"""The benchmark's run: find the cell in BENCHMARK.json, its configuration,
traffic mix and metric readers by name, hand the cell to the driver its
mix names, read the metrics, judge the outputs and print the result line.

Nothing here knows a cell, a configuration or a metric by name: a later
change adds one by adding files and entries (benchmark/__init__.py).
"""

from __future__ import annotations

import argparse
import faulthandler
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that no run may load
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "devc_tpu")
# a run that outlives this dumps every thread's stack and exits non-zero
RUN_LIMIT_S = 340
# the port's build and kernel caches, at fixed paths inside the checkout
CACHE_DIR = os.path.join(ROOT, ".bench_cache")


def load_manifest(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise SystemExit(f"no {what} named {name!r} in BENCHMARK.json")


def cell_metrics(manifest: dict, cell: str, traced: bool) -> list:
    """The metrics a run of `cell` reports: the end-to-end ones untraced,
    the per-layer ones traced; a metric with `workloads` only in those."""
    group = manifest["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", (cell,))]


def wants_window_device(readers) -> bool:
    """Whether a reader asks for the card's busy time over the window
    (WINDOW_DEVICE in its module): the driver then runs devclock's
    DeviceClock over the window, and leaves the window alone otherwise."""
    return any(getattr(r, "WINDOW_DEVICE", False) for r in readers)


def load_file_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, bench_dir: str = BENCH_DIR):
    """benchmark/metrics/<name>.py: read(run) -> a number, or None when
    the run has nothing for it to read."""
    return load_file_module(os.path.join(bench_dir, "metrics", name + ".py"),
                            "bench_metric_" + name.replace(".", "_"))


def forbidden_loaded(modules=None) -> list:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN_MODULES, compared whole: devc_tpu_torch is not
    devc_tpu."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN_MODULES)


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path in the checkout, set
    before CUDA or Triton starts (the port's nvcc build already lives at
    devc_tpu_torch/_build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = os.path.join(CACHE_DIR, sub)
        os.makedirs(os.environ[var], exist_ok=True)


@dataclass
class Run:
    """One run: what the driver measured, and what the readers read."""
    cell: dict
    config: dict
    traffic: dict
    seed: int
    seconds: float
    traced: bool
    device: str
    bench_dir: str = BENCH_DIR
    record: dict = field(default_factory=dict)
    trace: object = None  # trace.Trace of the traced stretch
    entry_calls: dict = field(default_factory=dict)  # range -> [call args]
    # a metric reads the card's busy time over the window (devclock.py)
    window_device: bool = False


def note(msg: str) -> None:
    """A progress line on standard error, with the seconds since start."""
    print(f"[bench {time.monotonic() - _T0:8.2f}s] {msg}", file=sys.stderr,
          flush=True)


_T0 = time.monotonic()


def process_age_s(t_first_line: float) -> float:
    """Seconds since the process started, from /proc where it is there
    (the interpreter's own start-up counts as set-up), else since the
    entry script's first line."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return max(age, time.time() - t_first_line)
    except (OSError, ValueError, IndexError):
        return time.time() - t_first_line


def load_run(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str, root: str = ROOT,
             bench_dir: str = BENCH_DIR) -> Run:
    """The Run of one cell: its manifest entry, configuration and traffic
    mix, found by name."""
    manifest = load_manifest(root)
    cell = find(manifest["workloads"], cell_name, "workload")
    cfg_entry = find(manifest["configs"], cell["config"], "config")
    with open(os.path.join(root, cfg_entry["file"])) as f:
        config = json.load(f)
    with open(os.path.join(bench_dir, "traffic",
                           cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return Run(cell, config, traffic, seed, seconds, traced, device,
               bench_dir)


def card(device) -> dict:
    """The result's device entry (the peak and trace readings are added
    by the driver)."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def run_cell(cell_name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t_start: float | None = None,
             root: str = ROOT, bench_dir: str = BENCH_DIR) -> dict:
    """Run one cell once on `device` and return the result object (the
    contract's keys, the compared numbers last under "checks")."""
    t_start = time.time() if t_start is None else t_start
    run = load_run(cell_name, seed, seconds, traced, device, root, bench_dir)
    run.record["t_start"] = t_start
    metrics = cell_metrics(load_manifest(root), cell_name, traced)
    readers = {m["name"]: metric_reader(m["name"], bench_dir)
               for m in metrics}
    driver = load_file_module(
        os.path.join(bench_dir, "drivers", run.traffic["driver"] + ".py"),
        "bench_driver_" + run.traffic["driver"])
    entries = sorted({r.ENTRY for r in readers.values()
                      if getattr(r, "ENTRY", None)})
    run.window_device = wants_window_device(readers.values())
    outcome = driver.run(run, entries)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": outcome["correct"],
        "attempted": outcome["attempted"],
        "failed": outcome["failed"],
        "metrics": values,
        "device": outcome["device"],
    }
    if traced and outcome.get("breakdown"):
        result["breakdown"] = outcome["breakdown"]
    result["checks"] = outcome["checks"]
    return result


def limits(run: Run) -> dict:
    """The cell's limits, limits/<cell>.json."""
    with open(os.path.join(run.bench_dir, "limits",
                           run.cell["name"] + ".json")) as f:
        return json.load(f)["limits"]


def _power_limit() -> str:
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def _check_lines(checks: dict) -> list:
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r}, "
            f"{v.get('rule', 'at most')})" for k, v in checks.items()]


def main(argv, t_start: float) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
    set_cache_dirs()
    import torch

    manifest = load_manifest()
    chips = find(manifest["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"need {chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t_start)
    bad = forbidden_loaded()
    if bad:
        print("a module of JAX or of the JAX package is loaded: "
              + ", ".join(bad), file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    for line in _check_lines(result["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
