"""Fixtures of the benchmark's own tests (CPU; those marked `cuda` run on
the card and skip without one). No JAX here: the card's machine has none.

    python -m pytest benchmark/tests -q                      # the CPU
    python -m pytest benchmark/tests -q -m cuda              # on the card
"""

import json
import os
import shutil
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skipped where "
        "torch.cuda.is_available() is false")


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's "
                    "size on the card")
    return "cuda"


@pytest.fixture
def tiny_bench(tmp_path):
    """(root, bench_dir): the manifest with every configuration cut to
    64x128 (a training batch to 2), and a copy of benchmark/'s data and
    readers whose clip mixes check one frame in 4 and trace 3 frames,
    whose serving mix has a backlog of 16 clips of 4-8 frames, and whose
    training mix writes 8 stills, so that a CPU run takes seconds."""
    root, bench = tmp_path / "root", tmp_path / "bench"
    root.mkdir()
    src = os.path.join(ROOT, "benchmark")
    shutil.copytree(src, bench, ignore=shutil.ignore_patterns(
        "reference", "tests", "__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        manifest = json.load(f)
    for c in manifest["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        cfg["image_size"] = [64, 128]
        if "batch_size" in cfg:
            cfg["batch_size"] = 2
        c["file"] = f"{c['name']}.json"
        (root / c["file"]).write_text(json.dumps(cfg))
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    for p in (bench / "traffic").iterdir():
        mix = json.loads(p.read_text())
        if mix["driver"] == "clip":
            mix.update(sample_every=4, trace_frames=3, chunk=2)
        elif mix["driver"] == "serve":
            mix.update(jobs=16, clip_frames=[4, 8], distinct_frames=12,
                       exemplars=2, warm_frames=2, sample_every=4,
                       trace_steps=2)
        else:
            mix.update(per_class=2, workers=2, loader_warm_steps=1)
        p.write_text(json.dumps(mix))
    return str(root), str(bench)
