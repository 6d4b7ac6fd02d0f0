"""The port's training convergence demo
(`python -m devc_tpu_torch.examples.convergence_demo`) against devc_tpu's
(examples/convergence_demo.py, imported by path) on the CPU.

- `build_pairs_dataset`: on a generated scene tree (stills under
  `min_side`, a non-RGB still, a one-still scene) both write the same
  tree, file for file and byte for byte, the same pairs.txt and the same
  held-out scenes, at holdout 0, 1 and 2; both refuse a tree without a
  pair with the same SystemExit.
- `smoothed`: equal on the same lists.
- `evaluate_holdout`'s random_init arm at 64x64 on held scenes of two
  stills (each clip one frame: a single-frame comparison): PSNR within
  0.05 dB and SSIM within 1e-3 of devc_tpu's (measured: 0.000 dB and
  0.0000; the two sides' output frames are equal pixel for pixel). The trained arm
  needs a checkpoint of each side's own trainer (orbax against
  torch.save files); here it runs on the random weights on both sides,
  so only random_init is compared.
- The port's `main` end to end (2 steps at batch 2, 64x64, holdout 1):
  its exit code follows the total_loss rule and its summary has the
  keys of devc_tpu's recorded 1000-step summary.
- `--device cuda` without a GPU raises before anything is written.
"""

import contextlib
import importlib.util
import io
import json
import os
import re

import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu_torch.cli import colorize as tcolorize
from devc_tpu_torch.examples import convergence_demo as tdemo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_jax_demo():
    spec = importlib.util.spec_from_file_location(
        "jax_convergence_demo",
        os.path.join(ROOT, "examples", "convergence_demo.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jdemo = _load_jax_demo()


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _textured(rng, h, w, tint):
    coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w] * tint
    return np.clip(field * 200 + 20 + rng.randn(h, w, 3) * 12, 0,
                   255).astype(np.uint8)


def _write_tree(root, seed=0):
    """Five scenes: s0 three stills, s1 one of them under min_side, s2
    one of them grayscale (mode L), s3 a single still (dropped), s4 two
    stills; plus a stray top-level file and an unreadable file in s0."""
    rng = np.random.RandomState(seed)
    sizes = {"s0": [(256, 300)] * 3, "s1": [(260, 280), (200, 320),
                                            (260, 280)],
             "s2": [(270, 256)] * 3, "s3": [(256, 256)],
             "s4": [(300, 264)] * 2}
    for scene, hws in sizes.items():
        d = os.path.join(root, scene)
        os.makedirs(d)
        tint = 0.4 + rng.rand(3) * 0.6  # one palette a scene
        for i, (h, w) in enumerate(hws):
            img = Image.fromarray(_textured(rng, h, w, tint))
            if scene == "s2" and i == 1:
                img = img.convert("L")
            img.save(os.path.join(d, f"{i:02d}.png"))
    with open(os.path.join(root, "README.txt"), "w") as f:
        f.write("not a scene\n")
    with open(os.path.join(root, "s0", "notes.jpg"), "w") as f:
        f.write("not an image\n")
    return root


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return _write_tree(str(tmp_path_factory.mktemp("scenes") / "src"))


def _files(root):
    out = {}
    for d, _sub, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("holdout", [0, 1, 2])
def test_build_pairs_dataset_matches_devc_tpu(tree, tmp_path, holdout):
    want = jdemo.build_pairs_dataset(tree, str(tmp_path / "jax"),
                                     holdout=holdout)
    got = tdemo.build_pairs_dataset(tree, str(tmp_path / "torch"),
                                    holdout=holdout)
    assert got == want
    n_pairs, held = got
    assert n_pairs == {0: 5, 1: 4, 2: 3}[holdout]
    assert [s for s, _ in held] == ["s2", "s4"][2 - holdout:]
    want_files, got_files = (_files(str(tmp_path / d))
                             for d in ("jax", "torch"))
    assert sorted(got_files) == sorted(want_files)
    assert all(got_files[k] == want_files[k] for k in want_files)
    pairs = got_files[os.path.join("scene0", "pairs.txt")].decode()
    assert "s1_01" not in pairs and "s2_01" not in pairs  # small, not RGB
    assert "s3" not in pairs  # one still: no pair


def test_build_pairs_dataset_refuses_a_tree_without_pairs(tmp_path):
    src = tmp_path / "src"
    rng = np.random.RandomState(1)
    for scene, hw in (("a", (256, 256)), ("b", (128, 300))):
        (src / scene).mkdir(parents=True)
        Image.fromarray(_textured(rng, *hw, np.ones(3))).save(
            src / scene / "0.png")
    (src / "b" / "1.png").write_bytes((src / "b" / "0.png").read_bytes())
    errors = []
    for demo, dst in ((jdemo, "jax"), (tdemo, "torch")):
        with pytest.raises(SystemExit) as e:
            demo.build_pairs_dataset(str(src), str(tmp_path / dst))
        errors.append(str(e.value))
    assert errors[0] == errors[1] and "no usable image pairs" in errors[0]


@pytest.mark.parametrize("vals,k", [
    ([5.0, 4.0, 3.0, 2.0, 1.0], 5), ([3.0], 5), ([1.0, 2.0], 1),
    ([float(i % 7) for i in range(40)], 4), ([2.5, 0.5, 1.5, 9.0], 0)])
def test_smoothed_matches_devc_tpu(vals, k):
    assert tdemo.smoothed(vals, k) == jdemo.smoothed(vals, k)


def _held(root):
    """Two held scenes of two stills each: still 0 the exemplar, still 1
    a one-frame clip."""
    rng = np.random.RandomState(2)
    held = []
    for scene in ("h0", "h1"):
        os.makedirs(os.path.join(root, scene))
        tint = 0.4 + rng.rand(3) * 0.6
        paths = []
        for i in range(2):
            p = os.path.join(root, scene, f"{i}.png")
            Image.fromarray(_textured(rng, 80, 96, tint)).save(p)
            paths.append(p)
        held.append((scene, paths))
    return held


def _random_weights_for_both_arms(real_main):
    """cli.colorize.main with the trained arm's --train_ckpt replaced by
    --random_init (no checkpoint of either trainer here)."""
    def main(argv):
        if "--train_ckpt" in argv:
            i = argv.index("--train_ckpt")
            argv = argv[:i] + ["--random_init"] + argv[i + 2:]
        return real_main(argv)

    return main


@pytest.fixture(scope="module")
def holdout_both(tmp_path_factory):
    """evaluate_holdout of devc_tpu and of the port on the same held
    scenes at 64x64, once for the module."""
    import cli.colorize as jcolorize

    root = tmp_path_factory.mktemp("holdout")
    held = _held(str(root / "src"))
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcolorize, "main",
                   _random_weights_for_both_arms(jcolorize.main))
        mp.setattr(tcolorize, "main",
                   _random_weights_for_both_arms(tcolorize.main))
        out["jax"] = jdemo.evaluate_holdout(
            held, str(root / "jax"), "unused", (64, 64))
        out["torch"] = tdemo.evaluate_holdout(
            held, str(root / "torch"), "unused", (64, 64), device="cpu")
    return root, out


def test_evaluate_holdout_random_init_matches_devc_tpu(holdout_both):
    root, res = holdout_both
    want, got = res["jax"]["random_init"], res["torch"]["random_init"]
    assert sorted(got) == sorted(want) == [
        "psnr_mean", "scenes", "ssim_mean", "temporal_rmse"]
    assert got["scenes"] == want["scenes"] == 2
    assert abs(got["psnr_mean"] - want["psnr_mean"]) <= 0.05, (got, want)
    assert abs(got["ssim_mean"] - want["ssim_mean"]) <= 1e-3, (got, want)
    # one frame a clip: no temporal score on either side
    assert got["temporal_rmse"] is None and want["temporal_rmse"] is None
    # both arms ran on the same random weights here
    assert res["torch"]["trained"] == got
    # the same layout: clip, ground truth and one output folder an arm
    for scene in ("h0", "h1"):
        for side in ("jax", "torch"):
            d = root / side / "eval" / scene
            assert sorted(os.listdir(d)) == [
                "clip", "gt", "out_random_init", "out_trained"]
            assert os.listdir(d / "out_random_init" / "clip_0") == [
                "00000.jpg"]
        gt = [np.asarray(Image.open(root / side / "eval" / scene / "gt"
                                    / "00000.png"))
              for side in ("jax", "torch")]
        assert gt[0].shape == (64, 64, 3)
        np.testing.assert_array_equal(gt[0], gt[1])


def test_evaluate_holdout_rounds_up_to_the_shape_contract(tmp_path):
    """216x384 becomes 224x384 (H % 16, W % 32), as in devc_tpu."""
    held = _held(str(tmp_path / "src"))[:1]
    seen = []

    def fake_colorize(argv):
        """The ground truth with its low bits flipped as the output."""
        seen.append(argv)
        out = argv[argv.index("--output_path") + 1]
        os.makedirs(os.path.join(out, "clip_0"))
        gt = np.asarray(Image.open(os.path.join(
            tmp_path, "run", "eval", "h0", "gt", "00000.png")))
        Image.fromarray(gt ^ 3).save(os.path.join(out, "clip_0",
                                                  "00000.png"))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tcolorize, "main", fake_colorize)
        res = tdemo.evaluate_holdout(held, str(tmp_path / "run"), "ck",
                                     (216, 384), device="cpu")
    assert [a[a.index("--image_size") + 1:a.index("--image_size") + 3]
            for a in seen] == [["224", "384"]] * 2
    assert seen[0][-4:] == ["--train_ckpt", "ck", "--device", "cpu"]
    assert seen[1][-3:] == ["--random_init", "--device", "cpu"]
    gt = np.asarray(Image.open(tmp_path / "run" / "eval" / "h0" / "gt"
                               / "00000.png"))
    assert gt.shape == (224, 384, 3)
    assert res["trained"] == res["random_init"]
    assert 35.0 < res["trained"]["psnr_mean"] < 60.0


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_main_end_to_end_on_cpu(tree, tmp_path):
    """2 steps at batch 2, 64x64, holdout 1: the exit code follows the
    total_loss rule, the summary has devc_tpu's keys, metrics.jsonl one
    line a step, a checkpoint at the last step (~770 MB, removed here)."""
    work, summary_path = tmp_path / "work", tmp_path / "summary.json"
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = tdemo.main([
                "--src", tree, "--workdir", str(work), "--device", "cpu",
                "--steps", "2", "--batch", "2", "--image-size", "64", "64",
                "--holdout", "1", "--workers", "2",
                "--summary-out", str(summary_path)])
        ckpts = sorted(os.listdir(work / "ckpt"))
    finally:
        for f in os.listdir(work / "ckpt"):
            if f.endswith(".pt"):
                os.remove(work / "ckpt" / f)
    summary = json.loads(summary_path.read_text())
    with open(os.path.join(ROOT, "docs", "convergence_summary_1000.json")) as f:
        want = json.load(f)
    assert _keys(summary) == _keys(want)
    total = summary["losses"]["total_loss"]
    assert rc == (0 if total["last"] < total["first"] else 1)
    assert ("OK: total_loss decreased" if rc == 0 else
            "FAIL: total_loss did not decrease") in buf.getvalue()
    records = [json.loads(line) for line in open(work / "runs"
                                                 / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2]
    assert (total["first"], total["last"]) == (records[0]["total_loss"],
                                               records[1]["total_loss"])
    assert all(np.isfinite(v) for r in records for v in r.values())
    assert "step_000000002.pt" in ckpts
    for arm in ("trained", "random_init"):
        assert summary["holdout"][arm]["scenes"] == 1
        assert np.isfinite(summary["holdout"][arm]["psnr_mean"])
        # the held scene (s4) has two stills: a one-frame clip
        assert summary["holdout"][arm]["temporal_rmse"] is None


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="a GPU is present: nothing to refuse")
def test_device_cuda_without_a_gpu_raises(tree, tmp_path):
    with pytest.raises(RuntimeError, match="cuda"):
        tdemo.main(["--src", tree, "--workdir", str(tmp_path / "w"),
                    "--steps", "1"])
    assert not os.path.exists(tmp_path / "w")


def _options(main):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf), pytest.raises(SystemExit):
        main(["--help"])
    return set(re.findall(r"^\s+(--[\w-]+)", buf.getvalue(), re.M))


def test_flags_are_devc_tpus_with_device_for_platform():
    want = _options(jdemo.main) - {"--platform"} | {"--device"}
    assert _options(tdemo.main) == want
