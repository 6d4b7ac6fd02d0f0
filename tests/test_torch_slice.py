"""The port's main path as a whole vs devc_tpu on CPU, both on their plain
paths (devc_tpu's einsum correspondence and XLA PCR, the oracles its own
tests hold the Pallas kernels against), with the same random weights.

Tolerances:
  * teacher-forced (same frame, carry and exemplar state on both sides):
    sim at atol 1e-3 (tests/test_golden.py's bound) and pred_ab at max
    |diff| < 0.5 of its +-128 range (tests/test_driver_parity.py's bound);
    the whole frame step's uint8 output within +-1 (the final floor turns
    round-off at exact integers into one step);
  * free-running `colorize_video`: frame 0 above 38 dB PSNR, as
    test_driver_parity.py holds devc_tpu to the reference. Later frames are
    not bounded tightly: with random weights the recurrence amplifies any
    per-frame difference ~20x per frame.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu.pipeline import frame as jframe
from devc_tpu.pipeline import video as jvideo
from devc_tpu.utils.init import host_pipeline_params
from devc_tpu_torch.cli import colorize as tcli
from devc_tpu_torch.pipeline import frame as tframe
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.utils.convert import state_dicts_from_numpy

HW = (48, 96)  # network at 24 x 48: WarpNet's replicate-pad path


def textured_frames(seed, n, hw):
    """Smooth random colour fields plus noise, uint8: no flat regions, so
    exact score ties stay rare."""
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0**2 / mse)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    params = host_pipeline_params(0)
    models = PipelineModels.from_state_dicts(state_dicts_from_numpy(params),
                                             "cpu")
    return jax.tree.map(jnp.asarray, params), models


@pytest.fixture(scope="module")
def clip():
    frames = textured_frames(0, 4, HW)
    return frames[1:], frames[0]  # 3 frames, exemplar


@pytest.mark.parametrize("temperature", [0.01, 1e-10])
def test_frame_teacher_forced(weights, clip, temperature):
    jparams, models = weights
    frames, ref = clip
    ref_lab_small, ref_state = jvideo._device_ref_features(
        jparams, jnp.asarray(ref))

    # exemplar preparation agrees with devc_tpu's
    t_ref_lab_small, t_state = tvideo._device_ref_features(models, _t(ref))
    np.testing.assert_allclose(t_ref_lab_small.numpy(),
                               np.asarray(ref_lab_small), atol=1e-3)
    phi = np.asarray(ref_state["phi"])
    np.testing.assert_allclose(t_state["phi"].numpy(), phi,
                               atol=1e-4 * np.abs(phi).max())
    np.testing.assert_allclose(t_state["values"].numpy(),
                               np.asarray(ref_state["values"]), atol=1e-3)

    step = jax.jit(lambda lab, last: jframe.frame_colorization(
        jparams, lab, None, last, ref_state["features"],
        temperature=temperature, joint_training=False, use_pallas=False,
        ref_embedding=(ref_state["phi"], ref_state["values"]))[:3])
    shared_state = {"phi": _t(ref_state["phi"]),
                    "values": _t(ref_state["values"])}
    last = jnp.zeros_like(ref_lab_small)
    for rgb in frames:
        _, lab_small = jvideo._preprocess_device(jnp.asarray(rgb))
        want_ab, _, want_sim = step(lab_small, last)
        with torch.inference_mode():
            got_ab, _, got_sim = tframe.frame_colorization(
                models, _t(lab_small), _t(last), shared_state, temperature)
        np.testing.assert_allclose(got_sim.numpy(), np.asarray(want_sim),
                                   atol=1e-3)
        assert np.abs(got_ab.numpy() - np.asarray(want_ab)).max() < 0.5
        # teacher forcing: both continue from devc_tpu's carry
        last = jnp.concatenate([lab_small[..., 0:1], want_ab], axis=-1)


def test_frame_matches_golden(weights):
    """devc_tpu's frozen golden frame (tests/golden_frame.npz, made with
    host_pipeline_params(0)) at tests/test_golden.py's tolerances."""
    _, models = weights
    data = np.load(os.path.join(os.path.dirname(__file__),
                                "golden_frame.npz"))
    with torch.inference_mode():
        state = tframe.prepare_reference(models, _t(data["b_lab"]))
        a_lab = _t(data["a_lab"])
        pred_ab, warped, sim = tframe.frame_colorization(
            models, a_lab, torch.zeros_like(a_lab), state, 1e-10)
    np.testing.assert_allclose(sim.numpy(), data["sim"], atol=1e-3)
    np.testing.assert_allclose(warped.numpy(), data["warped"], atol=5e-2)
    np.testing.assert_allclose(pred_ab.numpy(), data["pred_ab"], atol=5e-2)


@pytest.mark.parametrize("hw", [HW, (64, 128)])
def test_frame_step_matches_device_frame_step(weights, hw):
    """The whole device step (preprocess, nets, upsample, smoother, Lab ->
    uint8) on one frame, carry and exemplar state."""
    jparams, models = weights
    ref, *frames = textured_frames(1, 3, hw)
    ref_lab_small, ref_state = jvideo._device_ref_features(
        jparams, jnp.asarray(ref))
    shared_state = {"phi": _t(ref_state["phi"]),
                    "values": _t(ref_state["values"])}
    last = jnp.zeros_like(ref_lab_small)
    for rgb in frames:
        want_rgb, want_last = jvideo._device_frame_step(
            jparams, jnp.asarray(rgb), last, ref_lab_small, ref_state,
            temperature=1e-10, wls=True, use_pallas=False)
        got_rgb, got_last = tvideo.frame_step(
            models, _t(rgb), _t(last), shared_state, temperature=1e-10,
            wls=True)
        assert got_rgb.dtype == torch.uint8 and got_rgb.shape == (*hw, 3)
        assert got_last.shape == (1, hw[0] // 2, hw[1] // 2, 3)
        np.testing.assert_allclose(got_last[..., 0].numpy(),
                                   np.asarray(want_last)[..., 0], atol=1e-3)
        assert np.abs(got_last[..., 1:].numpy()
                      - np.asarray(want_last)[..., 1:]).max() < 0.5
        # the floor to uint8 turns round-off at exact integers into +-1
        diff = np.abs(got_rgb.numpy().astype(int) - np.asarray(want_rgb))
        assert diff.max() <= 1
        last = want_last


@pytest.fixture
def clip_dir(tmp_path, clip):
    frames, ref = clip
    d = tmp_path / "clip"
    d.mkdir()
    for i, f in enumerate(frames):
        Image.fromarray(f).save(d / f"{i:03d}.png")
    ref_path = tmp_path / "ref.png"
    Image.fromarray(ref).save(ref_path)
    return d, ref_path


def test_colorize_video_matches_devc_tpu(weights, clip_dir, tmp_path):
    jparams, models = weights
    d, ref_path = clip_dir
    want = jvideo.colorize_video(
        jparams, str(d), str(ref_path), str(tmp_path / "jax"),
        image_size=HW, temperature=1e-10, wls=True, use_pallas=False,
        write_video=False)
    got = tvideo.colorize_video(
        models, str(d), str(ref_path), str(tmp_path / "torch"),
        image_size=HW, temperature=1e-10, wls=True, write_video=False)
    assert [os.path.basename(p) for p in got] == \
        [os.path.basename(p) for p in want] == ["00000.jpg", "00001.jpg",
                                                "00002.jpg"]
    psnrs = [_psnr(np.asarray(Image.open(g)), np.asarray(Image.open(w)))
             for g, w in zip(got, want)]
    assert psnrs[0] > 38.0, psnrs


@pytest.mark.parametrize("src_hw", [(48, 96), (60, 96), (50, 130), (97, 194)])
def test_load_frame_rgb_matches_devc_tpu(tmp_path, src_hw):
    """The port's own frame loader (CenterPad + CenterCrop) vs devc_tpu's.
    Both truncate a float64 resize to uint8; exact-integer ties may be
    resolved either way, so +-1 is allowed on a few pixels."""
    from devc_tpu.data.transforms import load_frame_rgb as j_load
    from devc_tpu_torch.data.transforms import load_frame_rgb as t_load

    img = textured_frames(2, 1, src_hw)[0]
    path = tmp_path / "f.png"
    Image.fromarray(img).save(path)
    want = j_load(str(path), HW)
    got = t_load(str(path), HW)
    assert got.dtype == np.uint8 and got.shape == (*HW, 3)
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1 and (diff > 0).mean() < 0.01


def test_cli_writes_frames_on_cpu(clip_dir, tmp_path):
    d, ref_path = clip_dir
    out = tmp_path / "out"
    tcli.main(["--clip_path", str(d), "--ref_path", str(ref_path),
               "--output_path", str(out), "--image_size", *map(str, HW),
               "--random_init", "--seed", "0", "--device", "cpu",
               "--no_video"])
    out_dir = out / "clip_ref"
    names = sorted(os.listdir(out_dir))
    assert names == ["00000.jpg", "00001.jpg", "00002.jpg"]
    img = np.asarray(Image.open(out_dir / names[0]))
    assert img.shape == (*HW, 3)
    assert np.abs(img[..., 0].astype(int) - img[..., 1]).max() > 3  # chroma


def test_cli_rejects_bad_image_size(clip_dir, tmp_path):
    d, ref_path = clip_dir
    with pytest.raises(SystemExit) as e:
        tcli.main(["--clip_path", str(d), "--ref_path", str(ref_path),
                   "--output_path", str(tmp_path), "--image_size", "40", "96",
                   "--device", "cpu"])
    assert e.value.code == 2


def test_cuda_request_without_gpu_raises():
    """No silent CPU fallback: asking for CUDA on a CPU-only host fails."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        PipelineModels.from_state_dicts({}, "cuda")


def test_port_imports_no_jax():
    code = ("import sys, devc_tpu_torch.pipeline.video, "
            "devc_tpu_torch.cli.colorize, devc_tpu_torch.ops.cuda_corr, "
            "devc_tpu_torch.utils.init, devc_tpu_torch.data.transforms, "
            "devc_tpu_torch.ops.device_resize, devc_tpu_torch.pipeline.graph, "
            "devc_tpu_torch.pipeline.clip, devc_tpu_torch.pipeline.scheduler, "
            "devc_tpu_torch.parallel.inference, devc_tpu_torch.cli.serve, "
            "devc_tpu_torch.cli.train, devc_tpu_torch.cli.export, "
            "devc_tpu_torch.data.native, devc_tpu_torch.data.flow, "
            "devc_tpu_torch.data.distortion, devc_tpu_torch.data.videoloader, "
            "devc_tpu_torch.utils.logging, devc_tpu_torch.utils.profiling, "
            "devc_tpu_torch.models.vgg19_gray, devc_tpu_torch.train.state, "
            "devc_tpu_torch.utils.metrics, devc_tpu_torch.cli.evaluate, "
            "devc_tpu_torch.examples.convergence_demo; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'devc_tpu', 'cli')); "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=os.path.dirname(os.path.dirname(__file__)))
    root = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                        "devc_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f)) as fh:
                    for line in fh:
                        s = line.strip()
                        assert not s.startswith(
                            ("import jax", "from jax", "import devc_tpu.",
                             "from devc_tpu.", "from devc_tpu ",
                             "import cli.", "from cli.")), (f, s)
