"""The port's device CenterPad (devc_tpu_torch/ops/device_resize.py), its
video-file input and its device-resize driver vs devc_tpu and the host
path, on the CPU.

Tolerances: the plans are the same float64 numpy on both sides, so they
must be equal bit for bit. Applied in fp32, the two frameworks and the
host path sum in other orders, and the truncating cast turns that into
at most one uint8 step on a small share of pixels
(tests/test_device_resize.py's bound: 2% of pixels against the host, 0.1%
between the padded and unpadded plans).
"""

import numpy as np
import pytest
import torch
from PIL import Image

import jax.numpy as jnp

from devc_tpu.data.transforms import centerpad_np as j_centerpad_np
from devc_tpu.ops import device_resize as jdr
from devc_tpu_torch.data import transforms as tt
from devc_tpu_torch.ops import device_resize as tdr
from devc_tpu_torch.pipeline import video as tvideo

SHAPES = [((97, 150), (64, 96)), ((160, 100), (64, 96)),
          ((128, 192), (64, 96)), ((64, 96), (64, 96)),
          ((48, 64), (64, 96)), ((720, 1280), (432, 768))]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("src,dst", SHAPES)
def test_plans_equal_devc_tpus(src, dst):
    for dtype in (np.float64, np.float32):
        for got, want in zip(tdr.centerpad_plan(src, dst, dtype),
                             jdr.centerpad_plan(src, dst, dtype)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    mx = (src[0] + 13, src[1] + 7)
    for got, want in zip(tdr.centerpad_plan_padded(src, dst, mx),
                         jdr.centerpad_plan_padded(src, dst, mx)):
        np.testing.assert_array_equal(got, want)


def test_padded_plan_refuses_a_smaller_frame():
    with pytest.raises(ValueError, match="smaller than source"):
        tdr.centerpad_plan_padded((97, 150), (64, 96), (90, 150))


def _within_one(got, want, share):
    diff = np.abs(np.asarray(got).astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < share, (
        diff.max(), (diff > 0).mean())


@pytest.mark.parametrize("src,dst", SHAPES[:5])
def test_device_centerpad_matches_devc_tpu_and_host(src, dst):
    rng = np.random.RandomState(0)
    raw = rng.randint(0, 256, src + (3,), dtype=np.uint8)
    a_h, a_w = tdr.centerpad_plan(src, dst)
    got = tdr.device_centerpad(torch.from_numpy(raw), torch.from_numpy(a_h),
                               torch.from_numpy(a_w))
    assert got.dtype == torch.uint8 and tuple(got.shape) == dst + (3,)
    want = np.asarray(jdr.device_centerpad(jnp.asarray(raw), a_h, a_w))
    _within_one(got.numpy(), want, 0.02)
    # against the host: devc_tpu's bound of 2% of pixels; an upscale
    # (48x64 -> 64x96) lands on many exact-integer ties, where devc_tpu's
    # own device path is 2.6% off the host, so the port may be as far off
    # as devc_tpu plus half a percent
    host = j_centerpad_np(raw, dst)
    jax_share = (np.abs(want.astype(int) - host) > 0).mean()
    for h in (host, tt.centerpad_np(raw, dst)):
        _within_one(got.numpy(), h, max(0.02, jax_share + 0.005))


def test_device_centerpad_batched_matches_devc_tpu():
    """Two slots of different sources zero-padded to one size, each with
    its padded plan: against devc_tpu's batched form and the unpadded
    plan on the same frame."""
    rng = np.random.RandomState(3)
    out, mx = (64, 128), (120, 200)
    srcs = [(96, 160), (64, 128)]
    raws = [rng.randint(0, 256, s + (3,), dtype=np.uint8) for s in srcs]
    padded = np.zeros((2, *mx, 3), np.uint8)
    plans = []
    for i, (s, raw) in enumerate(zip(srcs, raws)):
        padded[i, :s[0], :s[1]] = raw
        plans.append(tdr.centerpad_plan_padded(s, out, mx))
    p_h = np.stack([p[0] for p in plans])
    p_w = np.stack([p[1] for p in plans])
    got = tdr.device_centerpad_batched(
        torch.from_numpy(padded), torch.from_numpy(p_h),
        torch.from_numpy(p_w)).numpy()
    want = np.asarray(jdr.device_centerpad_batched(
        jnp.asarray(padded), jnp.asarray(p_h), jnp.asarray(p_w)))
    assert got.shape == (2, *out, 3)
    _within_one(got, want, 1e-3)
    for i, (s, raw) in enumerate(zip(srcs, raws)):
        a_h, a_w = tdr.centerpad_plan(s, out)
        alone = tdr.device_centerpad(torch.from_numpy(raw),
                                     torch.from_numpy(a_h),
                                     torch.from_numpy(a_w)).numpy()
        _within_one(got[i], alone, 1e-3)


def test_centerpad_np_matches_devc_tpu():
    raw = np.random.RandomState(5).randint(0, 256, (97, 150, 3),
                                           dtype=np.uint8)
    _within_one(tt.centerpad_np(raw, (64, 96)),
                j_centerpad_np(raw, (64, 96)), 0.01)


def _write_avi(path, frames):
    import cv2

    h, w = frames[0].shape[:2]
    wr = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"DIVX"), 24,
                         (w, h))
    assert wr.isOpened()
    for f in frames:
        wr.write(f[..., ::-1])  # RGB -> BGR
    wr.release()


def _textured(seed, n, hw):
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.fixture(scope="module")
def models():
    from devc_tpu_torch.pipeline.frame import PipelineModels
    from devc_tpu_torch.utils.convert import state_dicts_from_numpy
    from devc_tpu_torch.utils.init import host_pipeline_params

    return PipelineModels.from_state_dicts(
        state_dicts_from_numpy(host_pipeline_params(0)), "cpu")


def test_is_video_file(tmp_path):
    pytest.importorskip("cv2")
    path = tmp_path / "clip.avi"
    _write_avi(path, _textured(0, 2, (64, 128)))
    assert tt.is_video_file(str(path))
    assert not tt.is_video_file(str(tmp_path))  # a directory
    assert not tt.is_video_file(str(tmp_path / "nope.mp4"))  # missing


@pytest.mark.parametrize("device_resize", [False, True])
def test_colorize_video_reads_a_video_file(models, tmp_path, device_resize):
    """A cv2-written .avi at twice the target size: every frame, in
    order, through the host or the device CenterPad; the outputs equal
    colorize_frames on the frames as cv2 decodes them."""
    pytest.importorskip("cv2")
    frames = _textured(1, 4, (128, 256))
    path = tmp_path / "clip.avi"
    _write_avi(path, frames[1:])
    ref = tmp_path / "ref.png"
    Image.fromarray(frames[0]).save(ref)
    written = tvideo.colorize_video(
        models, str(path), str(ref), str(tmp_path / "out"),
        image_size=(64, 128), write_video=False, out_ext="png",
        device_resize=device_resize)
    assert [p[-9:] for p in written] == ["00000.png", "00001.png",
                                          "00002.png"]
    decoded = list(tvideo._video_frames_rgb(str(path)))
    assert len(decoded) == 3
    plan = (tdr.centerpad_plan((128, 256), (64, 128)) if device_resize
            else None)
    want = []
    tvideo.colorize_frames(
        models, decoded if device_resize
        else [tt.centerpad_np(f, (64, 128)) for f in decoded],
        tt.load_frame_rgb(str(ref), (64, 128)),
        lambda i, a: want.append(a), resize_plan=plan)
    for p, w in zip(written, want):
        np.testing.assert_array_equal(np.asarray(Image.open(p)), w)


def test_device_resize_close_to_host_path(models, tmp_path):
    """device_resize on a folder at 1.5x the target: the frames the
    network sees are within one uint8 step of the host CenterPad's, so
    the outputs stay close (a loose PSNR floor: the correspondence at
    T = 1e-10 may pick another key for a few positions)."""
    clip = tmp_path / "clip"
    clip.mkdir()
    frames = _textured(2, 3, (96, 192))
    for i, f in enumerate(frames[1:]):
        Image.fromarray(f).save(clip / f"{i:03d}.png")
    ref = tmp_path / "ref.png"
    Image.fromarray(frames[0]).save(ref)
    runs = {}
    for dr in (False, True):
        runs[dr] = tvideo.colorize_video(
            models, str(clip), str(ref), str(tmp_path / f"out{dr}"),
            image_size=(64, 128), write_video=False, out_ext="png",
            device_resize=dr)
    got = np.asarray(Image.open(runs[True][0])).astype(float)
    want = np.asarray(Image.open(runs[False][0])).astype(float)
    assert got.shape == (64, 128, 3)
    mse = np.mean((got - want) ** 2)
    assert mse == 0 or 10 * np.log10(255.0 ** 2 / mse) > 30.0


def test_device_resize_refuses_mixed_resolutions(models, tmp_path):
    clip = tmp_path / "clip"
    clip.mkdir()
    rng = np.random.RandomState(3)
    for i, hw in enumerate(((96, 160), (80, 160))):
        Image.fromarray(rng.randint(0, 256, hw + (3,), dtype=np.uint8)).save(
            clip / f"{i:03d}.png")
    ref = tmp_path / "ref.png"
    Image.fromarray(rng.randint(0, 256, (64, 128, 3), dtype=np.uint8)).save(
        ref)
    with pytest.raises(ValueError, match="one resolution per clip"):
        tvideo.colorize_video(models, str(clip), str(ref),
                              str(tmp_path / "out"), image_size=(64, 128),
                              write_video=False, device_resize=True)


@pytest.mark.parametrize("src,dst", [((80, 160), (64, 128)),
                                     ((60, 120), (48, 96))])
def test_device_resize_frame0_matches_devc_tpus_device_path(models, src, dst):
    """Frame 0 through the port's frame_step with a resize plan against
    devc_tpu's _device_frame_step with the same plan, on the same raw
    frame at 1.25x the target, exemplar and carry shared (teacher-forced):
    the resized inputs agree bit for bit, the frames within one uint8 step
    (tests/test_torch_slice.py's bound for the step). What the host
    CenterPad gives differs from either device path by one step on ~1% of
    pixels, which random weights at T = 1e-10 can amplify downstream."""
    import jax

    from devc_tpu.pipeline import video as jvideo
    from devc_tpu.utils.init import host_pipeline_params

    jparams = jax.tree.map(jnp.asarray, host_pipeline_params(0))
    raw, ref_raw = _textured(11, 2, src)
    ref = tt.centerpad_np(ref_raw, dst)
    a_h, a_w = tdr.centerpad_plan(src, dst)
    j_in = np.asarray(jdr.device_centerpad(jnp.asarray(raw), jnp.asarray(a_h),
                                           jnp.asarray(a_w)))
    t_in = tdr.device_centerpad(torch.from_numpy(raw), torch.from_numpy(a_h),
                                torch.from_numpy(a_w)).numpy()
    np.testing.assert_array_equal(t_in, j_in)
    host = np.abs(t_in.astype(int) - tt.centerpad_np(raw, dst))
    assert host.max() <= 1 and (host > 0).mean() < 0.02

    ref_lab_small, ref_state = jvideo._device_ref_features(jparams,
                                                           jnp.asarray(ref))
    last = jnp.zeros_like(ref_lab_small)
    want, _ = jvideo._device_frame_step(
        jparams, jnp.asarray(raw), last, ref_lab_small, ref_state,
        temperature=1e-10, wls=True, use_pallas=False,
        resize_plan=(jnp.asarray(a_h), jnp.asarray(a_w)))
    shared = {k: torch.from_numpy(np.array(ref_state[k]))
              for k in ("phi", "values")}
    got, _ = tvideo.frame_step(
        models, torch.from_numpy(raw), torch.from_numpy(np.array(last)),
        shared, temperature=1e-10, wls=True,
        resize_plan=(torch.from_numpy(a_h), torch.from_numpy(a_w)))
    assert got.shape == (*dst, 3)
    assert np.abs(got.numpy().astype(int) - np.asarray(want)).max() <= 1
