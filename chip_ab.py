#!/usr/bin/env python3
"""Run the port's phases of two checkouts on one GPU, in turns.

    python3 chip_ab.py BEFORE_DIR AFTER_DIR [--seed 0]
        [--phases kernels,k1,main,layers,bwd,train]

Each turn runs, in a fresh process from one checkout's root, that
checkout's own `chip_smoke.py` phases, with the same seed and seeded
random weights: by default `kernels`, `main` and `layers` (K1 and K2
against their plain versions; colorize_frames on 8 frames of 432x768; one
frame's stages timed apart) and `bwd` (K2b / K3, the correspondence
backward, against its plain version, timed at the training shape);
`k1` (K1 fp32 alone at every shape a driven path gives it, with SDPA's
fp32 call and the bound: `chip_smoke.k1_sweep`) and `train` (the
training step at batch 16, 216x384: ms per step, peak memory) on
request. The turns go BEFORE, AFTER, AFTER, BEFORE, so that a
drift of the card over the call shows on both sides. Every JSON line a
turn prints is printed again with "tree" (the checkout's label) and
"turn" added; a turn that fails stops the run with its exit code.

Both checkouts build their own kernels (into their own
`devc_tpu_torch/_build/`). Needs one NVIDIA GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

PHASES = ("kernels", "k1", "main", "layers", "bwd", "train")

_TURN = """
import sys
sys.path.insert(0, ".")
import chip_smoke as c
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.utils.convert import use_full_fp32
from devc_tpu_torch.utils import build
from devc_tpu_torch.utils.convert import state_dicts_from_numpy
from devc_tpu_torch.utils.init import host_pipeline_params

seed, phases = int(sys.argv[1]), sys.argv[2].split(",")
use_full_fp32()
build.load_kernels()
card = c.card_line()
if "kernels" in phases:
    c.phase_kernels(seed)
if "k1" in phases:
    c.k1_sweep(seed)
if "main" in phases or "layers" in phases:
    models = PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(seed)), "cuda")
    _, _, ref, frames = c.phase_main(models, seed, card)
    if "layers" in phases:
        c.phase_layers(models, ref, frames[0], card)
    del models
if "bwd" in phases:
    c.phase_bwd(seed)
if "train" in phases:
    c.phase_train(seed, card)
"""


def run_turn(label: str, root: str, turn: int, seed: int,
             phases: str) -> int:
    proc = subprocess.run([sys.executable, "-c", _TURN, str(seed), phases],
                          cwd=root, capture_output=True, text=True,
                          timeout=1800)
    for line in proc.stdout.splitlines():
        try:
            rec = json.loads(line)
        except json.JSONDecodeError:
            continue
        print(json.dumps({"tree": label, "turn": turn, **rec}), flush=True)
    if proc.returncode != 0:
        print(f"chip_ab: turn {turn} ({label}) failed "
              f"({proc.returncode}):\n{proc.stderr[-4000:]}", file=sys.stderr)
    return proc.returncode


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("before")
    p.add_argument("after")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--phases", default="kernels,main,layers,bwd",
                   help=f"comma-separated, of {', '.join(PHASES)}")
    args = p.parse_args(argv)
    unknown = set(args.phases.split(",")) - set(PHASES)
    if unknown:
        p.error(f"unknown phases: {', '.join(sorted(unknown))}")

    import torch

    if not torch.cuda.is_available():
        print("chip_ab: torch.cuda.is_available() is false; this run needs "
              "an NVIDIA GPU", file=sys.stderr)
        return 1
    trees = {"before": os.path.abspath(args.before),
             "after": os.path.abspath(args.after)}
    for turn, label in enumerate(("before", "after", "after", "before")):
        code = run_turn(label, trees[label], turn, args.seed, args.phases)
        if code != 0:
            return code
    return 0


if __name__ == "__main__":
    sys.exit(main())
