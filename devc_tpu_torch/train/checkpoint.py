"""Checkpoint / resume of the whole TrainState with torch.save (mirrors
devc_tpu/train/checkpoint.py, which uses orbax).

One file per step, `step_<n>.pt`, written to a temporary name and renamed
into place, so a crash never leaves a half-written step behind. The file
holds the step, both modules' state dicts (the generator's in the
reference's `.pth` key layout under "warpnet." / "colorvid."), the
spectral-norm vectors and both optimizer states. `max_to_keep` newest
steps are kept; a save happens when the step is a multiple of
`save_interval_steps`, or when forced.
"""

from __future__ import annotations

import json
import os
import re

import torch

from devc_tpu_torch.train.state import FlatAdamState, TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:09d}.pt")


def _steps(directory: str) -> list[int]:
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory))
                  if m)


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 5,
                 save_interval_steps: int = 2000):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps

    def save(self, step: int, state: TrainState, force: bool = False) -> bool:
        """Write `state` as step `step`; returns whether it was written."""
        if not force and step % self.save_interval_steps:
            return False
        blob = {
            "step": state.step,
            "params_g": state.params_g.state_dict(),
            "params_d": state.params_d.state_dict(),
            "sn_state": state.sn_state,
            "opt_state_g": state.opt_state_g._asdict(),
            "opt_state_d": state.opt_state_d._asdict(),
        }
        path = _path(self.directory, step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        for old in _steps(self.directory)[:-self.max_to_keep]:
            os.remove(_path(self.directory, old))
        return True

    def restore(self, state_like: TrainState, step: int | None = None
                ) -> TrainState:
        """Load a step (the latest by default) into state_like's modules
        (in place) and return the restored state, tensors on the device of
        state_like's generator."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.directory}")
        device = next(state_like.params_g.parameters()).device
        blob = torch.load(_path(self.directory, step), map_location=device,
                          weights_only=True)
        state_like.params_g.load_state_dict(blob["params_g"], strict=True)
        state_like.params_d.load_state_dict(blob["params_d"], strict=True)
        return TrainState(
            step=blob["step"],
            params_g=state_like.params_g,
            params_d=state_like.params_d,
            sn_state=_to(blob["sn_state"], device),
            opt_state_g=FlatAdamState(**blob["opt_state_g"]),
            opt_state_d=FlatAdamState(**blob["opt_state_d"]),
        )

    def latest_step(self) -> int | None:
        steps = _steps(self.directory)
        return steps[-1] if steps else None

    def all_steps(self) -> list[int]:
        return _steps(self.directory)


def load_train_state_dict(directory: str, step: int | None = None):
    """(blob, step): a checkpoint's contents on the CPU, the latest step by
    default, with no template: {"step", "params_g": {"warpnet": state
    dict, "colorvid": state dict} (the reference's .pth layout),
    "params_d", "sn_state", "opt_state_g", "opt_state_d"}."""
    directory = os.path.abspath(directory)
    steps = _steps(directory)
    if step is None and not steps:
        raise FileNotFoundError(f"no checkpoint under {directory}")
    step = steps[-1] if step is None else step
    blob = torch.load(_path(directory, step), map_location="cpu",
                      weights_only=True)
    params_g = {"warpnet": {}, "colorvid": {}}
    for k, v in blob["params_g"].items():
        net, name = k.split(".", 1)
        params_g[net][name] = v
    blob["params_g"] = params_g
    return blob, step


def load_train_params_g(directory: str, step: int | None = None) -> dict:
    """The generator's state dicts {"warpnet": ..., "colorvid": ...} (the
    reference's `.pth` layout, on the CPU) from a checkpoint directory, the
    latest step by default: the deployment artifact, no template needed."""
    return load_train_state_dict(directory, step)[0]["params_g"]


def save_run_metadata(directory: str, meta: dict) -> None:
    """Side-band run metadata (which VGG weights the run used, ...) next to
    the steps, so inference can refuse a mismatched feature extractor."""
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "run_metadata.json"), "w") as f:
        json.dump(meta, f, indent=1)


def load_run_metadata(directory: str) -> dict | None:
    path = os.path.join(os.path.abspath(directory), "run_metadata.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)
