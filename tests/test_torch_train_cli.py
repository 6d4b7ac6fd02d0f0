"""The port's training entry point, its export and VGG provenance across the
CLIs, on the CPU at 64x64, batch 2 (tests/test_train_cli.py's cases on
python -m devc_tpu_torch.cli.train, plus cli.export and
cli.colorize / cli.serve --train_ckpt).

Tolerances: the exported .pth files must carry the checkpoint's tensors
bit for bit through devc_tpu's importers; devc_tpu's frame_colorization
on them is held against the port's forward on the same weights at
tests/test_torch_models.py's bounds (1e-4 of the largest magnitude for
the similarity, the output's absolute 1e-2 for ColorVidNet's +-128 ab),
at T = 1 so that the softmax does not amplify a last-bit difference. A
colorization from --train_ckpt must equal, bit for bit, one from the
same weights loaded as .pth files.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu.pipeline import frame as jframe
from devc_tpu.pipeline import video as jvideo
from devc_tpu.utils import convert as jconvert
from devc_tpu_torch.cli import colorize as tcolorize
from devc_tpu_torch.cli import export as texport
from devc_tpu_torch.cli import serve as tserve
from devc_tpu_torch.cli import train as ttrain
from devc_tpu_torch.pipeline import frame as tframe
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.train.checkpoint import load_train_state_dict
from devc_tpu_torch.utils.convert import vgg19_state_dict
from devc_tpu_torch.utils.init import host_train_vgg_init

MISSING_VGG = "/nonexistent/forces-random-vgg.pth"


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _textured(rng, h, w):
    coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    return np.clip(field * 200 + 20 + rng.randn(h, w, 3) * 12, 0,
                   255).astype(np.uint8)


def _make_imagenet_dataset(root, n_images=3):
    rng = np.random.RandomState(0)
    d = root / "class0"
    (d / "input").mkdir(parents=True)
    for i in range(n_images):
        Image.fromarray(_textured(rng, 80, 100)).save(
            d / "input" / f"img{i}.JPEG")
    with open(d / "pairs.txt", "w") as f:
        for i in range(n_images - 1):
            f.write(f"img{i}.JPEG img{i + 1}.JPEG 1.0\n")
    return root


def _args(data_root, ckpt_dir, log_dir, steps=2, extra=()):
    # --checkpoint_step 2: a full-width checkpoint (weights and both
    # optimizers' moments) is ~770 MB, so each run writes one
    return ["--data_root_imagenet", str(data_root), "--batch_size", "2",
            "--image_size", "64", "64", "--max_steps", str(steps),
            "--workers", "2", "--checkpoint_dir", str(ckpt_dir),
            "--checkpoint_step", "2", "--log_dir", str(log_dir),
            "--print_step", "1", "--tb_log_step", "1",
            "--vgg_ckpt", MISSING_VGG, "--device", "cpu", *extra]


def _drop_checkpoints(root):
    for d, _sub, files in os.walk(root):
        for f in files:
            if f.endswith(".pt"):
                os.remove(os.path.join(d, f))


@pytest.fixture(autouse=True)
def _no_checkpoints_left(tmp_path):
    yield
    _drop_checkpoints(tmp_path)


def _linked_copy(src, dst):
    """The checkpoint directory's files at dst: the steps hard-linked (no
    second ~770 MB copy), the small files copied."""
    import shutil

    os.makedirs(dst)
    for name in os.listdir(src):
        if name.endswith(".pt"):
            os.link(os.path.join(src, name), os.path.join(dst, name))
        else:
            shutil.copy(os.path.join(src, name), dst)
    return dst


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A 2-step run (its checkpoint at step 2)."""
    root = tmp_path_factory.mktemp("train")
    data = _make_imagenet_dataset(root / "data")
    summary = ttrain.main(_args(data, root / "ckpt", root / "runs"))
    yield root, data, summary
    _drop_checkpoints(root)


def test_train_cli_two_steps_logs_and_checkpoints(trained):
    root, _data, summary = trained
    lines = [json.loads(line) for line in open(root / "runs" / "metrics.jsonl")]
    assert [line["step"] for line in lines] == [1, 2]
    for line in lines:
        for k in ("total_loss", "l1_loss", "generator_loss",
                  "discriminator_loss"):
            assert np.isfinite(line[k]), (k, line)
    ckpt = root / "ckpt"
    assert (ckpt / "opt.txt").exists()
    assert json.load(open(ckpt / "run_metadata.json")) == {
        "vgg_source": "random:seed1"}
    assert sorted(os.listdir(ckpt)) == [
        "opt.txt", "run_metadata.json", "step_000000002.pt"]
    assert summary["steps"] == 2 and summary["last_step"] == 2
    assert len(summary["loader_wait_s"]) == 2
    assert 0.0 <= summary["loader_wait_share"] <= 1.0
    assert summary["device"] == "cpu"


def test_train_cli_resume_restores_and_continues(trained, tmp_path):
    """--resume restores the latest step (weights and both optimizers'
    states) and counts on from it; the loader and the noise start again
    from step 0 of --seed."""
    root, data, _ = trained
    ckpt = _linked_copy(root / "ckpt", tmp_path / "ckpt")
    before, _ = load_train_state_dict(str(ckpt))
    summary = ttrain.main(_args(data, ckpt, tmp_path / "runs", steps=1,
                                extra=["--resume"]))
    assert summary["first_step"] == 3 and summary["last_step"] == 3
    lines = [json.loads(line) for line in open(tmp_path / "runs"
                                               / "metrics.jsonl")]
    assert [line["step"] for line in lines] == [3]
    after, step = load_train_state_dict(str(ckpt))
    assert step == 3 and after["step"] == 3
    assert after["opt_state_g"]["count"] == before["opt_state_g"]["count"] + 1
    assert after["opt_state_d"]["count"] == before["opt_state_d"]["count"] + 1
    # the step from the restored state moved the weights
    moved = max(float((after["params_g"]["colorvid"][k]
                       - before["params_g"]["colorvid"][k]).abs().max())
                for k in before["params_g"]["colorvid"])
    assert moved > 0


def test_train_cli_device_preprocess(tmp_path):
    data = _make_imagenet_dataset(tmp_path / "data")
    summary = ttrain.main(_args(data, tmp_path / "ckpt", tmp_path / "runs",
                                steps=1, extra=["--device_preprocess"]))
    assert summary["last_step"] == 1
    line = json.loads(open(tmp_path / "runs" / "metrics.jsonl").readline())
    assert all(np.isfinite(v) for v in line.values())


def test_boolean_optional_flags_reach_config(tmp_path, monkeypatch):
    """--no-permute_data, --no-with_bad and --no-with_mid reach TrainConfig
    and the dataset (the reference's `type=bool` flags are truthy for any
    string)."""
    import devc_tpu_torch.data.videoloader as vl
    import devc_tpu_torch.train.loop as loop_mod

    data = _make_imagenet_dataset(tmp_path / "data")
    captured = {}

    class _Abort(Exception):
        pass

    def spy(tx_g, tx_d, vgg, cfg, **kw):
        captured["cfg"] = cfg
        raise _Abort()

    real_ds = vl.ImageNetPairsDataset

    def ds_spy(root, **kw):
        captured["ds"] = kw
        return real_ds(root, **kw)

    monkeypatch.setattr(loop_mod, "make_train_step", spy)
    monkeypatch.setattr(vl, "ImageNetPairsDataset", ds_spy)
    args = _args(data, tmp_path / "ckpt", tmp_path / "runs", steps=1)
    with pytest.raises(_Abort):
        ttrain.main(args + ["--no-permute_data", "--no-with_bad",
                            "--no-with_mid"])
    assert captured["cfg"].permute_data is False
    assert captured["ds"]["with_bad"] is False
    assert captured["ds"]["with_mid"] is False
    with pytest.raises(_Abort):
        ttrain.main(args)
    assert captured["cfg"].permute_data is True
    assert captured["ds"]["with_bad"] is True
    assert captured["ds"]["with_mid"] is True


def test_resume_refuses_vgg_provenance_mismatch(trained, tmp_path):
    root, data, _ = trained
    ckpt = _linked_copy(root / "ckpt", tmp_path / "ckpt")
    meta_path = ckpt / "run_metadata.json"
    with open(meta_path, "w") as f:  # as if trained against torch VGG
        json.dump({"vgg_source": "torch:vgg19_conv.pth"}, f)
    args = _args(data, ckpt, tmp_path / "runs", steps=1)
    with pytest.raises(SystemExit, match="vgg_source"):
        ttrain.main(args + ["--resume"])
    assert json.load(open(meta_path))["vgg_source"] == "torch:vgg19_conv.pth"
    # the override proceeds and rewrites the provenance
    summary = ttrain.main(args + ["--resume", "--allow_vgg_mismatch"])
    assert summary["first_step"] == 3
    assert json.load(open(meta_path))["vgg_source"] == "random:seed1"


def test_train_cli_refuses_cuda_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    data = _make_imagenet_dataset(tmp_path / "data")
    args = _args(data, tmp_path / "ckpt", tmp_path / "runs", steps=1)
    with pytest.raises(RuntimeError, match="is_available"):
        ttrain.main(args[:-2] + ["--device", "cuda"])


def test_train_cli_keeps_convolutions_in_full_fp32(tmp_path):
    """cli.train switches cuDNN's TF32 default off, as inference does,
    before anything else (here: the missing-dataset refusal)."""
    flags = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(SystemExit, match="need --data_root"):
            ttrain.main(["--device", "cpu", "--log_dir", str(tmp_path / "r"),
                         "--checkpoint_dir", str(tmp_path / "c")])
        assert not torch.backends.cudnn.allow_tf32
        assert not torch.backends.cuda.matmul.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = flags


@pytest.fixture(scope="module")
def exported(trained, tmp_path_factory):
    root, _data, _ = trained
    out = tmp_path_factory.mktemp("exported")
    texport.main(["--train_ckpt", str(root / "ckpt"), "--out", str(out),
                  "--discriminator", "--vgg"])
    yield out
    for name in os.listdir(out):
        os.remove(out / name)


def test_export_loads_through_devc_tpus_importers(trained, exported):
    root, _data, _ = trained
    blob, step = load_train_state_dict(str(root / "ckpt"))
    assert step == 2
    names = sorted(os.listdir(exported))
    assert names == ["colornet_iter_2.pth", "discriminator_iter_2.pth",
                     "nonlocal_net_iter_2.pth", "vgg19_conv.pth"]
    vgg, warp, color = jconvert.convert_checkpoints(
        str(exported / "vgg19_conv.pth"),
        str(exported / "nonlocal_net_iter_2.pth"),
        str(exported / "colornet_iter_2.pth"))
    # back to the port's layout: the same tensors, bit for bit
    from devc_tpu_torch.utils import convert as tconvert

    for got, want in ((tconvert.warpnet_state_dict(warp),
                       blob["params_g"]["warpnet"]),
                      (tconvert.colorvidnet_state_dict(color),
                       blob["params_g"]["colorvid"]),
                      (tconvert.vgg19_state_dict(vgg),
                       vgg19_state_dict(host_train_vgg_init()))):
        assert set(got) == set(want)
        for k in want:
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    params_d, sn = jconvert.discriminator_from_torch(
        jconvert.load_torch_state_dict(str(exported
                                           / "discriminator_iter_2.pth")))
    got = tconvert.discriminator_state_dict(params_d, sn)
    want = tconvert.discriminator_reference_state_dict(blob["params_d"],
                                                       blob["sn_state"])
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k].reshape(got[k].shape),
                                   rtol=0, atol=0)


def test_export_frame_colorization_matches_devc_tpu(exported):
    """devc_tpu's forward on the exported files against the port's on the
    same files, one frame at 48x96, T = 1."""
    paths = [str(exported / n) for n in (
        "vgg19_conv.pth", "nonlocal_net_iter_2.pth", "colornet_iter_2.pth")]
    jparams = jax.tree.map(jnp.asarray, dict(zip(
        ("vgg", "warpnet", "colorvid"), jconvert.convert_checkpoints(*paths))))
    models = PipelineModels.from_state_dicts(
        {k: torch.load(p, weights_only=True) for k, p in
         zip(("vgg", "warpnet", "colorvid"), paths)}, "cpu")
    rng = np.random.RandomState(3)
    ref, frame = _textured(rng, 48, 96), _textured(rng, 48, 96)
    ref_lab_small, ref_state = jvideo._device_ref_features(
        jparams, jnp.asarray(ref))
    _, lab_small = jvideo._preprocess_device(jnp.asarray(frame))
    last = jnp.zeros_like(ref_lab_small)
    want_ab, _, want_sim = jax.jit(lambda lab, prev: jframe.frame_colorization(
        jparams, lab, None, prev, ref_state["features"], temperature=1.0,
        joint_training=False, use_pallas=False,
        ref_embedding=(ref_state["phi"], ref_state["values"]))[:3])(
        lab_small, last)
    with torch.inference_mode():
        _, t_state = tvideo._device_ref_features(models, torch.from_numpy(ref))
        got_ab, _, got_sim = tframe.frame_colorization(
            models, torch.from_numpy(np.array(lab_small)),
            torch.from_numpy(np.array(last)), t_state, 1.0)
    want_sim, want_ab = np.asarray(want_sim), np.asarray(want_ab)
    np.testing.assert_allclose(got_sim.numpy(), want_sim, rtol=0,
                               atol=1e-4 * np.abs(want_sim).max())
    np.testing.assert_allclose(got_ab.numpy(), want_ab, rtol=0, atol=1e-2)


def test_export_refuses_vgg_of_a_torch_vgg_run(trained, tmp_path):
    root, _data, _ = trained
    ckpt = _linked_copy(root / "ckpt", tmp_path / "ckpt")
    with open(ckpt / "run_metadata.json", "w") as f:
        json.dump({"vgg_source": "torch:vgg19_conv.pth"}, f)
    out = tmp_path / "out"
    with pytest.raises(SystemExit, match="torch VGG"):
        texport.main(["--train_ckpt", str(ckpt), "--out", str(out), "--vgg"])
    assert not out.exists()  # nothing written before the refusal


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip")
    rng = np.random.RandomState(4)
    (root / "frames").mkdir()
    for i in range(2):
        Image.fromarray(_textured(rng, 64, 128)).save(
            root / "frames" / f"{i:03d}.png")
    Image.fromarray(_textured(rng, 64, 128)).save(root / "ref.png")
    return root


def _colorize(clip, out, extra):
    tcolorize.main(["--clip_path", str(clip / "frames"), "--ref_path",
                    str(clip / "ref.png"), "--output_path", str(out),
                    "--image_size", "64", "128", "--no_video",
                    "--device", "cpu", *extra])
    d = out / "frames_ref"
    return [np.asarray(Image.open(d / n)) for n in sorted(os.listdir(d))]


def test_colorize_train_ckpt_equals_the_exported_weights(trained, exported,
                                                         clip, tmp_path):
    """C9: --train_ckpt takes the seed-1 VGG the run recorded; its frames
    equal a run on the same weights loaded as .pth files."""
    root, _data, _ = trained
    got = _colorize(clip, tmp_path / "a", [
        "--train_ckpt", str(root / "ckpt"), "--vgg_ckpt", MISSING_VGG])
    want = _colorize(clip, tmp_path / "b", [
        "--vgg_ckpt", str(exported / "vgg19_conv.pth"),
        "--warpnet_ckpt", str(exported / "nonlocal_net_iter_2.pth"),
        "--colornet_ckpt", str(exported / "colornet_iter_2.pth")])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert max(np.abs(g[..., 0].astype(int) - g[..., 1]).max()
               for g in got) > 3  # chroma was added
    with pytest.raises(FileNotFoundError):  # no step 1 was kept
        _colorize(clip, tmp_path / "c", [
            "--train_ckpt", str(root / "ckpt"), "--train_ckpt_step", "1",
            "--vgg_ckpt", MISSING_VGG])


@pytest.mark.parametrize("cli", ["colorize", "serve"])
def test_train_ckpt_refuses_a_torch_vgg_for_a_random_vgg_run(
        cli, trained, exported, clip, tmp_path):
    root, _data, _ = trained
    common = ["--train_ckpt", str(root / "ckpt"), "--device", "cpu",
              "--vgg_ckpt", str(exported / "vgg19_conv.pth")]
    with pytest.raises(SystemExit, match="seed-1 random VGG"):
        if cli == "colorize":
            _colorize(clip, tmp_path / "out", common[:2] + common[4:])
        else:
            tserve.main(common + ["--image_size", "64", "128"])


@pytest.mark.parametrize("cli", ["colorize", "serve"])
def test_train_ckpt_refuses_a_missing_vgg_for_a_torch_vgg_run(
        cli, trained, clip, tmp_path):
    root, _data, _ = trained
    ckpt = _linked_copy(root / "ckpt", tmp_path / "ckpt")
    with open(ckpt / "run_metadata.json", "w") as f:
        json.dump({"vgg_source": "torch:vgg19_conv.pth"}, f)
    common = ["--train_ckpt", str(ckpt), "--vgg_ckpt", MISSING_VGG]
    with pytest.raises(SystemExit, match="allow_random_vgg"):
        if cli == "colorize":
            _colorize(clip, tmp_path / "out", common)
        else:
            tserve.main(common + ["--device", "cpu", "--image_size", "64",
                                  "128"])
    if cli == "colorize":  # the override takes the seed-1 VGG
        frames = _colorize(clip, tmp_path / "out2",
                           common + ["--allow_random_vgg"])
        assert len(frames) == 2


def _parser_of(main, monkeypatch):
    """The ArgumentParser a CLI's main() builds, caught at parse_args."""
    import argparse

    caught = {}

    class _Stop(Exception):
        pass

    def grab(self, args=None, namespace=None):
        caught["parser"] = self
        raise _Stop()

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", grab)
    with pytest.raises(_Stop):
        main([])
    monkeypatch.undo()
    return {a.dest: (a.default, a.nargs, type(a).__name__)
            for a in caught["parser"]._actions if a.dest != "help"}


@pytest.mark.parametrize("name", ["train", "export"])
def test_cli_flags_and_defaults_are_devc_tpus(name, monkeypatch):
    """Every flag keeps devc_tpu's default; cli.train swaps --platform for
    --device and keeps the mesh flags (--n_model, --spmd_step)."""
    import importlib

    ours = _parser_of({"train": ttrain, "export": texport}[name].main,
                      monkeypatch)
    theirs = _parser_of(importlib.import_module(f"cli.{name}").main,
                        monkeypatch)
    if name == "train":
        del theirs["platform"]
        assert ours.pop("device")[0] == "cuda"
    assert ours == theirs
