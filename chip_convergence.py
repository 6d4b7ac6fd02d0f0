#!/usr/bin/env python3
"""The convergence demo's long run on one NVIDIA GPU: python -m
devc_tpu_torch.examples.convergence_demo at the configuration of
devc_tpu's recorded runs (docs/CONVERGENCE.md: batch 8, 216x384,
--holdout 2, --device-preprocess, 4 loader threads) on chip_smoke.py's
generated scene tree (`write_scene_tree`), instrumented as chip_smoke.py's
`convergence` phase is (`run_convergence_demo`, `convergence_report`).

    python3 chip_convergence.py --out DIR [--steps 1000]

Writes to --out:
  convergence_summary_<steps>.json   the demo's summary (--summary-out)
  convergence_metrics_<steps>.jsonl  the run's metrics.jsonl
  convergence_run_<steps>.json       the card; ms a step (median and p90
                                     after the first step) and every
                                     step's ms and loader wait; the
                                     loader-wait share; the device memory
                                     allocated after step MEM_FROM, after
                                     the last step and every 100 steps;
                                     the launches of the training run and
                                     of each held-out cli.colorize call
and prints that record's summary as one JSON line, then the card's name
and power limit. Exits 1 without a GPU or when a check of
`convergence_report` fails (total_loss did not fall, a loss not finite,
launches off, memory grown by more than 1%).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

# the step whose allocated memory the last step's is held to (within 1%)
MEM_FROM = 100
# chip_smoke.py's convergence phase draws its scene tree from its --seed
# (default 0) + 61: the same tree
SCENE_SEED = 61


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--out", required=True,
                   help="directory for the three records")
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_convergence: torch.cuda.is_available() is false; this "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from devc_tpu_torch.utils import build

    card = smoke.card_line()
    build.load_kernels()
    os.makedirs(args.out, exist_ok=True)
    name = lambda kind, ext: os.path.join(
        args.out, f"convergence_{kind}_{args.steps}.{ext}")
    tmp = tempfile.mkdtemp(prefix="devc_convergence_")
    try:
        src = os.path.join(tmp, "scenes")
        smoke.write_scene_tree(src, SCENE_SEED)
        rec = smoke.run_convergence_demo(
            os.path.join(tmp, "work"), src, args.steps, smoke.CONV_BATCH,
            smoke.CONV_HOLDOUT, name("summary", "json"))
        shutil.copy(os.path.join(tmp, "work", "runs", "metrics.jsonl"),
                    name("metrics", "jsonl"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    run = {"card": card, "device": torch.cuda.get_device_name(0),
           "steps": args.steps, "batch": smoke.CONV_BATCH,
           "image_size": list(smoke.TRAIN_HW), "holdout": smoke.CONV_HOLDOUT,
           "scenes": smoke.CONV_SCENES, "scene_seed": SCENE_SEED,
           "workers": 4, "device_preprocess": True,
           "allocated_mib_every_100": {
               s: v for s, v in rec["allocated_mib"].items()
               if s % 100 == 0 or s in (1, args.steps)},
           "step_ms": [s * 1e3 for s in rec["train"]["step_s"]],
           "loader_wait_ms": [s * 1e3 for s in rec["train"]["loader_wait_s"]]}
    ok = True
    try:
        run.update(smoke.convergence_report(rec, args.steps, MEM_FROM))
    except AssertionError as e:
        ok = False
        run.update(failed=repr(e), rc=rec["rc"],
                   train_launches=rec["train_launches"],
                   colorize=rec["colorize"], summary=rec["summary"])
    with open(name("run", "json"), "w") as f:
        json.dump(run, f, indent=1)
    print(json.dumps({k: v for k, v in run.items()
                      if k not in ("step_ms", "loader_wait_ms")}), flush=True)
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
