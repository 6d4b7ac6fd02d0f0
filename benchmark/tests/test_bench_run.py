"""The harness end to end on the CPU at 64x128 (tiny_bench): the plain
reference against the port, each cell's run correct, and the run made
wrong by a fault planted in the timed path."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import compare, harness, scenes, weights
from benchmark.reference import infer

ROOT = harness.ROOT


def test_reference_follows_the_port_frame_by_frame():
    """Five frames at 64x128, the port's carry handed to the reference
    each time (teacher-forced): both plain on the CPU, so no value is off
    and the carries agree to rounding."""
    from devc_tpu_torch.pipeline import video
    from devc_tpu_torch.pipeline.frame import PipelineModels

    hw = (64, 128)
    port = PipelineModels.from_state_dicts(
        weights.pipeline_state_dicts(5, "cpu"), "cpu")
    ref = infer.Models.from_state_dicts(
        weights.pipeline_state_dicts(5, "cpu"), "cpu")
    frames = scenes.panned_clip(5, hw, 5, (1, 3))
    exemplar = torch.from_numpy(scenes.exemplar(5, hw))
    _, port_state = video._device_ref_features(port, exemplar)
    ref_state = infer.prepare_reference(ref, exemplar[None])
    carry = torch.zeros((1, 32, 64, 3))
    pairs, gaps = [], []
    for f in frames:
        f = torch.from_numpy(f)
        out, new = video.frame_step(port, f, carry, port_state)
        r_out, r_new = infer.step(ref, f[None], carry, ref_state)
        pairs.append((out, r_out[0], new, r_new))
        gaps.append(float((new - r_new).abs().max()))
        carry = new
    numbers = compare.clip_numbers(pairs)
    assert numbers["frames_off"] == 0, numbers
    assert {v for k, v in numbers.items()
            if not k.endswith("_frames")} == {0.0}, numbers
    assert max(gaps) < 1e-3


@pytest.mark.parametrize("cell", ["stream432", "scan432"])
def test_a_cpu_run_of_each_cell_is_correct(tiny_bench, cell):
    root, bench = tiny_bench
    r = harness.run_cell(cell, 2**31 + 7, 1.5, False, "cpu", root=root,
                         bench_dir=bench)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # stream432's frame_device_ms reads the card: nothing to read here
    assert set(r["metrics"]) == {"stream432": {"setup_s"},
                                 "scan432": {"frame_ms", "setup_s"}}[cell]
    assert list(r)[-1] == "checks"
    assert r["checks"]["sampled_frames"]["value"] >= 2


def test_a_traced_cpu_run_reports_its_per_layer_metrics(tiny_bench):
    root, bench = tiny_bench
    r = harness.run_cell("stream432", 11, 1.0, True, "cpu", root=root,
                         bench_dir=bench)
    assert r["correct"], r["checks"]
    assert "idle_pct.stream" in r["metrics"]
    assert "mfu.stream" not in r["metrics"]  # no device time to read on the CPU
    # the host's pace, read over the window the profiler leaves alone
    assert r["metrics"]["frame_ms.stream"]["value"] > 0
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("fault", ["stale_answer", "channels_swapped",
                                   "state_unchanged", "frame0_only",
                                   "every_other_frame"])
@pytest.mark.parametrize("cell", ["stream432", "scan432"])
def test_a_fault_in_the_timed_path_makes_the_run_incorrect(
        tiny_bench, monkeypatch, cell, fault):
    """Faults planted where the answer and the state are produced: each
    frame's output replaced by the frame before's (a buffer reused), its
    colour channels swapped, or a step that returns its carry unchanged;
    and faults on some frames only: the first frame of the window alone
    answered wrong and carried unchanged, or every other frame."""
    from devc_tpu_torch.pipeline import video

    orig = video.step_body
    last, calls = [], [0]
    warm = 2  # the mix's warm_frames go through the step before the window

    def broken(models, frames_u8, last_lab, *args, **kwargs):
        out, new = orig(models, frames_u8, last_lab, *args, **kwargs)
        i = calls[0] - warm
        calls[0] += 1
        if fault == "stale_answer":
            stale = last[0] if last else torch.zeros_like(out)
            last[:] = [out]
            return stale, new
        if fault == "channels_swapped":
            return out.flip(-1), new
        if fault == "frame0_only":
            return (out.flip(-1), last_lab.clone()) if i == 0 else (out, new)
        if fault == "every_other_frame":
            return (out.flip(-1), new) if i % 2 else (out, new)
        return out, last_lab.clone()

    monkeypatch.setattr(video, "step_body", broken)
    root, bench = tiny_bench
    r = harness.run_cell(cell, 3, 1.5, False, "cpu", root=root,
                         bench_dir=bench)
    assert not r["correct"], r["checks"]


def test_a_configuration_mix_and_metric_are_added_by_files_alone(tiny_bench):
    """A throw-away configuration, traffic mix and metric reader, each a
    new file, and a cell in the manifest that names them: the harness
    finds all three by name."""
    root, bench = tiny_bench
    manifest = harness.load_manifest(root)
    cfg = json.load(open(os.path.join(root, manifest["configs"][0]["file"])))
    cfg["image_size"] = [48, 96]
    with open(os.path.join(root, "extra.json"), "w") as f:
        json.dump(cfg, f)
    mix = json.load(open(os.path.join(bench, "traffic", "clip-stream.json")))
    mix["pan_px"] = [2, 2]
    with open(os.path.join(bench, "traffic", "clip-slowpan.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "frames_in_window.py"),
              "w") as f:
        f.write("def read(run):\n    return len(run.record['times'])\n")
    with open(os.path.join(bench, "limits", "extra48.json"), "w") as f:
        json.dump(json.load(open(os.path.join(bench, "limits",
                                              "stream432.json"))), f)
    manifest["configs"].append({"name": "extra-48x96", "source": "a test",
                                "file": "extra.json", "reduced": [],
                                "why": "a test"})
    manifest["workloads"].append({"name": "extra48", "config": "extra-48x96",
                                  "traffic": "clip-slowpan", "chips": 1,
                                  "why": "a test"})
    manifest["end_to_end"].append({"name": "frames_in_window",
                                   "unit": "frames", "better": "higher",
                                   "bound": 0.05, "source": "host_clock",
                                   "workloads": ["extra48"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(manifest, f)
    r = harness.run_cell("extra48", 9, 1.0, False, "cpu", root=root,
                         bench_dir=bench)
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_in_window"]["value"] == r["attempted"] > 0
    assert "frame_ms" not in r["metrics"]  # scan432's alone


def test_the_module_check_compares_whole_top_level_names():
    assert harness.forbidden_loaded({"devc_tpu_torch.ops": 1,
                                     "jaxtyping": 1, "flaxen": 1}) == []
    assert harness.forbidden_loaded({"devc_tpu.ops.fgs": 1, "jax": 1,
                                     "jaxlib.xla": 1, "flax": 1}) == [
        "devc_tpu.ops.fgs", "flax", "jax", "jaxlib.xla"]


def test_the_reference_and_the_harness_import_no_port_and_no_jax():
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.reference.infer, benchmark.flops,"
            " benchmark.weights, benchmark.compare;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('devc_tpu_torch', 'devc_tpu', 'jax', 'jaxlib', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    code = ("import sys; sys.path.insert(0, sys.argv[1]);"
            "import benchmark.harness, benchmark.drivers.clip;"
            "import devc_tpu_torch.pipeline.video;"
            "bad = [m for m in sys.modules if m.split('.')[0] in"
            " ('devc_tpu', 'jax', 'jaxlib', 'flax')];"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code, ROOT],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_entry_script_refuses_to_run_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "benchmark", "run.py"),
         "--workload", "stream432", "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, timeout=120,
        env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_clip_numbers_read_frame_by_frame():
    """Every sampled frame is read alone as well as all together: one
    frame far off, frame 0 or any other, moves the worst frame's share;
    every frame off moves the shares over all frames."""
    h, w = 8, 16
    same = torch.zeros((h, w, 3), dtype=torch.uint8)
    off = same + 9
    carry = torch.zeros((h // 2, w // 2, 3))
    good = (same, same, carry, carry)
    bad = (off, same, carry + 1, carry)
    n = compare.clip_numbers([good] * 8)
    assert n["px_off"] == n["px_off_worst"] == n["carry_ab_off"] == 0.0
    assert n["frames_off"] == 0
    for first in (True, False):
        one = [bad] + [good] * 7 if first else [good] * 7 + [bad]
        n = compare.clip_numbers(one)
        assert n["px_off"] == 0.125 and n["carry_l_off"] == 0.125
        assert n["px_off_worst"] == 1.0 and n["carry_ab_off_worst"] == 1.0
        assert n["frames_off"] == 1
        ok, checks = compare.verdict(n, {"px_off": 0.25,
                                         "px_off_worst": 0.5})
        assert not ok and list(checks) == ["px_off", "px_off_worst"]
        assert checks["px_off"]["value"] == 0.125
    n = compare.clip_numbers([bad] * 8)
    assert n["px_off"] == 1.0 and n["carry_ab_off"] == 1.0
    assert n["frames_off"] == 8


def test_a_cpu_run_of_the_serving_cell_is_correct(tiny_bench):
    root, bench = tiny_bench
    r = harness.run_cell("serve432-b4", 2**31 + 9, 2.0, False, "cpu",
                         root=root, bench_dir=bench)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    # frame_device_ms reads the card: nothing to read here
    assert {"setup_s"} == set(r["metrics"])
    assert r["checks"]["written_off"]["value"] == 0.0
    assert r["checks"]["sampled_frames"]["value"] >= 4  # each job's first


def test_a_traced_cpu_run_of_the_serving_cell_reports_its_rate(tiny_bench):
    """frames_per_s.serve, the host's rate, from the window that a traced
    run leaves untraced."""
    root, bench = tiny_bench
    r = harness.run_cell("serve432-b4", 2**31 + 11, 2.0, True, "cpu",
                         root=root, bench_dir=bench)
    assert r["correct"], r["checks"]
    assert r["metrics"]["frames_per_s.serve"]["value"] == pytest.approx(
        r["attempted"] / 2.0)


@pytest.mark.parametrize("fault", ["stale_answer", "channels_swapped",
                                   "state_unchanged", "one_row_once",
                                   "written_altered"])
def test_a_fault_in_the_serving_path_makes_the_run_incorrect(
        tiny_bench, monkeypatch, fault):
    """Faults planted in the scheduler's timed run (its second run(), after
    the warm-up's): every row's output replaced by the step before's, its
    colour channels swapped, the carries returned unchanged; the first
    step's first row alone answered wrong and carried unchanged; the
    writer saving another image than the one it was handed."""
    from devc_tpu_torch.parallel import inference
    from devc_tpu_torch.pipeline import scheduler

    runs, steps, last = [0], [0], []
    orig_run, orig_body, orig_save = (scheduler.ClipBatchScheduler.run,
                                      inference.step_body, scheduler._save)

    def counted_run(self):
        runs[0] += 1
        return orig_run(self)

    def broken(models, frames_u8, last_lab, *args, **kwargs):
        out, new = orig_body(models, frames_u8, last_lab, *args, **kwargs)
        if runs[0] < 2:
            return out, new
        steps[0] += 1
        if fault == "stale_answer":
            stale = last[0] if last else torch.zeros_like(out)
            last[:] = [out]
            return stale, new
        if fault == "channels_swapped":
            return out.flip(-1), new
        if fault == "state_unchanged":
            return out, last_lab.clone()
        if fault == "one_row_once" and steps[0] == 1:
            out, new = out.clone(), new.clone()
            out[0], new[0] = out[0].flip(-1), last_lab[0]
        return out, new

    def altered(path, arr):
        orig_save(path, arr[::-1] if runs[0] >= 2 else arr)

    monkeypatch.setattr(scheduler.ClipBatchScheduler, "run", counted_run)
    if fault == "written_altered":
        monkeypatch.setattr(scheduler, "_save", altered)
    else:
        monkeypatch.setattr(inference, "step_body", broken)
    root, bench = tiny_bench
    r = harness.run_cell("serve432-b4", 5, 2.0, False, "cpu", root=root,
                         bench_dir=bench)
    assert not r["correct"], r["checks"]
