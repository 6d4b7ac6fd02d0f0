"""The controls on the card, at the cells' own size: the reference in TF32
in the program's place must come out as not correct on every seed, by the
cell's own limits (for the training cell, the reference on half of each
batch too); the judge's own reference (TF32 off, convolutions in
float64) in the program's place must read 0.
Run on the card with `python -m pytest benchmark/tests -q -m cuda`."""

import json
import os

import pytest

from benchmark import compare, harness
from benchmark.control import control_numbers, serve_control_numbers

pytestmark = pytest.mark.cuda

# about as many sampled frames as a run compares (15-16 in 10 s)
CONTROL_FRAMES = 480


def _limits(cell):
    with open(os.path.join(harness.BENCH_DIR, "limits", cell + ".json")) as f:
        return json.load(f)["limits"]


@pytest.mark.parametrize("cell", ["stream432", "scan432", "serve432-b4"])
@pytest.mark.parametrize("seed", [21, 22, 2**31 + 23])
def test_the_tf32_control_is_not_correct(cuda_device, cell, seed):
    """The serving control writes no files: its written_off is left out."""
    if cell.startswith("serve"):
        numbers = serve_control_numbers(cell, seed, CONTROL_FRAMES,
                                        cuda_device)
    else:
        numbers = control_numbers(cell, seed, CONTROL_FRAMES, cuda_device)
    assert numbers["sampled_frames"] >= 10
    limits = {k: v for k, v in _limits(cell).items() if k != "written_off"}
    correct, checks = compare.verdict(numbers, limits)
    print(json.dumps({"cell": cell, "seed": seed, **numbers}))
    assert not correct, checks


def test_the_fp32_reference_agrees_with_itself(cuda_device):
    numbers = control_numbers("stream432", 5, 64, cuda_device, tf32=False)
    assert numbers["px_off"] == 0.0 and numbers["carry_ab_off"] == 0.0
    assert numbers["px_off_worst"] == 0.0 and numbers["frames_off"] == 0


@pytest.mark.parametrize("seed", [51, 2**31 + 52, 53])
def test_the_training_controls_are_not_correct(cuda_device, seed):
    from benchmark.control import train_control_numbers

    limits = _limits("train-b16")
    numbers = train_control_numbers("train-b16", seed, cuda_device)
    print(json.dumps({"cell": "train-b16", "seed": seed, **numbers}))
    for name in ("control", "half_batch"):
        correct, checks = compare.verdict(numbers[name], limits)
        assert not correct, (name, checks)
