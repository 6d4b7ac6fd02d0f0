"""The port's batched device steps vs devc_tpu on the CPU, both on their
plain paths, with the same random weights: the smoother over a batch
(K2's batched entry, plain version), `batched_frame_step` (B clips),
`frame_step_multi` (R exemplars), the clip drivers' scan mode and
multi-exemplar driver, and `pipeline/clip.py`.

Tolerances, tests/test_torch_slice.py's: teacher-forced (the same frame,
carry and exemplar state on both sides), sim at atol 1e-3, pred_ab at
max |diff| < 0.5 and the step's uint8 output within +-1. One smoother
pass at 2e-4 and the six-pass smoother at 2e-3 (tests/test_torch_fgs.py's
bounds); the batched plain pass is bit-equal to per-image calls.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from devc_tpu.ops import fgs as jfgs
from devc_tpu.parallel import inference as jinf
from devc_tpu.pipeline import clip as jclip
from devc_tpu.pipeline import frame as jframe
from devc_tpu.pipeline import video as jvideo
from devc_tpu.utils.init import host_pipeline_params
from devc_tpu_torch.ops import fgs as tfgs
from devc_tpu_torch.parallel import inference as tinf
from devc_tpu_torch.pipeline import clip as tclip
from devc_tpu_torch.pipeline import frame as tframe
from devc_tpu_torch.pipeline import video as tvideo
from devc_tpu_torch.pipeline.frame import PipelineModels
from devc_tpu_torch.utils.convert import state_dicts_from_numpy

HW = (48, 96)  # network at 24 x 48: WarpNet's replicate-pad path


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs several workers on the host's
    cores, and PyTorch's default of one thread per core oversubscribes
    them."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def textured_frames(seed, n, hw=HW):
    rng = np.random.RandomState(seed)
    h, w = hw
    out = []
    for _ in range(n):
        coarse = rng.rand(h // 8 + 1, w // 8 + 1, 3)
        field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
        img = field * 200 + 20 + rng.randn(h, w, 3) * 12
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights():
    params = host_pipeline_params(0)
    models = PipelineModels.from_state_dicts(state_dicts_from_numpy(params),
                                             "cpu")
    return jax.tree.map(jnp.asarray, params), models


def _smoother_inputs(seed, b, hw):
    rng = np.random.RandomState(seed)
    src = ((rng.rand(b, *hw, 2) - 0.5) * 200).astype(np.float32)
    guide = np.floor(rng.rand(b, *hw) * 256).astype(np.float32)
    guide[..., hw[1] // 2:] = np.floor(guide[..., hw[1] // 2:] / 8)  # edge
    return src, guide


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_smooth_pass_plain_batched_equals_per_image(shared, axis):
    src, guide = _smoother_inputs(0, 3, (37, 70))
    g = _t(guide[0]) if shared else _t(guide)
    got = tfgs.smooth_pass(_t(src), g, 100.0, 4.0, axis)
    assert got.shape == src.shape
    for i in range(3):
        alone = tfgs.smooth_pass(_t(src[i]), g if shared else g[i], 100.0,
                                 4.0, axis)
        assert torch.equal(got[i], alone), i


@pytest.mark.parametrize("shared", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_smooth_pass_batched_matches_devc_tpu(shared, axis):
    """One pass over a batch against devc_tpu's `_smooth_axis` under
    vmap (axis 0: on the transposed images)."""
    src, guide = _smoother_inputs(1, 3, (48, 96))
    lam = 1.5 * 500.0 * 16.0 / 63.0
    if axis == 0:
        src_j, guide_j = src.transpose(0, 2, 1, 3), guide.transpose(0, 2, 1)
    else:
        src_j, guide_j = src, guide
    one = lambda x, g: jfgs._smooth_axis(x, g, lam, 4.0, "pcr")
    if shared:
        want = jax.vmap(lambda x: one(x, jnp.asarray(guide_j[0])))(
            jnp.asarray(src_j))
    else:
        want = jax.vmap(one)(jnp.asarray(src_j), jnp.asarray(guide_j))
    want = np.asarray(want)
    if axis == 0:
        want = want.transpose(0, 2, 1, 3)
    got = tfgs.smooth_pass(_t(src), _t(guide[0]) if shared else _t(guide),
                           lam, 4.0, axis)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


@pytest.mark.parametrize("shared", [False, True])
def test_fast_global_smoother_batched_matches_devc_tpu(shared):
    """The whole smoother over 3 images against devc_tpu's vmapped
    smoother (measured 1.5e-4 to 1.8e-4 here)."""
    src, guide = _smoother_inputs(2, 3, HW)
    smooth = lambda x, g: jfgs.fast_global_smoother(x, g, solver="pcr")
    if shared:
        want = jax.vmap(lambda x: smooth(x, jnp.asarray(guide[0])))(
            jnp.asarray(src))
    else:
        want = jax.vmap(smooth)(jnp.asarray(src), jnp.asarray(guide))
    got = tfgs.fast_global_smoother(
        _t(src), _t(guide[0]) if shared else _t(guide))
    assert got.shape == src.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)


def _assert_step_close(got_rgb, got_last, want_rgb, want_last):
    got_last = got_last.numpy()
    want_last = np.asarray(want_last)
    np.testing.assert_allclose(got_last[..., 0], want_last[..., 0], atol=1e-3)
    assert np.abs(got_last[..., 1:] - want_last[..., 1:]).max() < 0.5
    # the floor to uint8 turns round-off at exact integers into +-1
    assert np.abs(got_rgb.numpy().astype(int)
                  - np.asarray(want_rgb)).max() <= 1


def test_batched_frame_step_matches_devc_tpu(weights):
    """B = 3 clips, each with its own exemplar, two teacher-forced steps:
    the correspondence and ColorVidNet at batch 3 (sim, pred_ab), then
    the whole step (uint8 output and carry)."""
    jparams, models = weights
    refs = np.stack(textured_frames(10, 3))
    steps = [np.stack(textured_frames(11 + i, 3)) for i in range(2)]
    ref_lab_small, state = jinf.prepare_references_batched(
        jparams, jnp.asarray(refs))
    t_lab_small, t_state = tinf.prepare_references_batched(models, _t(refs))
    np.testing.assert_allclose(t_lab_small.numpy(), np.asarray(ref_lab_small),
                               atol=1e-3)
    phi = np.asarray(state["phi"])
    np.testing.assert_allclose(t_state["phi"].numpy(), phi,
                               atol=1e-4 * np.abs(phi).max())
    shared = {"phi": _t(state["phi"]), "values": _t(state["values"])}
    jstep = jax.jit(lambda f, l: jinf.batched_frame_step(
        jparams, f, l, state, temperature=1e-10, wls=True, use_pallas=False))
    jcolor = jax.jit(lambda lab, l: jframe.frame_colorization(
        jparams, lab, None, l, state["features"], temperature=1e-10,
        joint_training=False, use_pallas=False,
        ref_embedding=(state["phi"], state["values"]))[:3])
    last = jnp.zeros_like(ref_lab_small)
    for frames in steps:
        _, lab_small = tvideo._preprocess_batch(_t(frames))
        want_ab, _, want_sim = jcolor(jnp.asarray(lab_small.numpy()), last)
        with torch.inference_mode():
            got_ab, _, got_sim = tframe.frame_colorization(
                models, lab_small, _t(last), shared, 1e-10)
        np.testing.assert_allclose(got_sim.numpy(), np.asarray(want_sim),
                                   atol=1e-3)
        assert np.abs(got_ab.numpy() - np.asarray(want_ab)).max() < 0.5

        want_rgb, want_last = jstep(jnp.asarray(frames), last)
        got_rgb, got_last = tinf.batched_frame_step(
            models, _t(frames), _t(last), shared, temperature=1e-10)
        assert got_rgb.shape == (3, *HW, 3)
        _assert_step_close(got_rgb, got_last, want_rgb, want_last)
        last = want_last  # teacher forcing


def test_frame_step_multi_matches_devc_tpu(weights):
    """One frame against R = 3 exemplars, two teacher-forced steps."""
    jparams, models = weights
    refs = np.stack(textured_frames(20, 3))
    frames = textured_frames(21, 2)
    ref_lab_small, state = jvideo._device_ref_features_multi(
        jparams, jnp.asarray(refs))
    _, t_state = tvideo._device_ref_features_multi(models, _t(refs))
    np.testing.assert_allclose(t_state["values"].numpy(),
                               np.asarray(state["values"]), atol=1e-3)
    shared = {"phi": _t(state["phi"]), "values": _t(state["values"])}
    last = jnp.zeros_like(ref_lab_small)
    for rgb in frames:
        want_rgb, want_last = jvideo._device_frame_step_multi(
            jparams, jnp.asarray(rgb), last, ref_lab_small, state,
            temperature=1e-10, wls=True, use_pallas=False, unroll_refs=False)
        got_rgb, got_last = tvideo.frame_step_multi(
            models, _t(rgb), _t(last), shared, temperature=1e-10)
        assert got_rgb.shape == (3, *HW, 3)
        _assert_step_close(got_rgb, got_last, want_rgb, want_last)
        last = want_last


@pytest.fixture
def clip_files(tmp_path):
    frames = textured_frames(30, 8)
    clip = tmp_path / "clip"
    clip.mkdir()
    for i, f in enumerate(frames[3:]):
        Image.fromarray(f).save(clip / f"{i:03d}.png")
    refs = []
    for i, f in enumerate(frames[:3]):
        refs.append(str(tmp_path / f"ref{i}.png"))
        Image.fromarray(f).save(refs[-1])
    return str(clip), refs


def _read(paths):
    return [np.asarray(Image.open(p)) for p in paths]


@pytest.mark.parametrize("multi", [False, True])
def test_scan_mode_equals_stream_mode(weights, clip_files, tmp_path, multi):
    """Chunk 2 over 5 frames (the tail chunk holds one): the same frames
    as stream mode, one exemplar and three."""
    _, models = weights
    clip, refs = clip_files
    runs = {}
    for mode in ("stream", "scan"):
        if multi:
            runs[mode] = tvideo.colorize_video_multi(
                models, clip, refs, [str(tmp_path / f"{mode}{i}")
                                     for i in range(3)],
                image_size=HW, write_video=False, mode=mode, chunk=2,
                out_ext="png")
        else:
            runs[mode] = [tvideo.colorize_video(
                models, clip, refs[0], str(tmp_path / mode), image_size=HW,
                write_video=False, mode=mode, chunk=2, out_ext="png")]
    assert [len(w) for w in runs["scan"]] == [5] * (3 if multi else 1)
    for a, b in zip(runs["stream"], runs["scan"]):
        for x, y in zip(_read(a), _read(b)):
            np.testing.assert_array_equal(x, y)


def test_colorize_video_multi_matches_serial_at_frame_0(weights, clip_files,
                                                        tmp_path):
    """The R-batched pass against one serial run per exemplar: frame 0
    within +-1 (both start from a zero carry; ColorVidNet at batch 3 may
    sum in another order than at batch 1)."""
    from devc_tpu_torch.data.transforms import load_frame_rgb

    _, models = weights
    clip, refs = clip_files
    multi = tvideo.colorize_video_multi(
        models, clip, refs, [str(tmp_path / f"m{i}") for i in range(3)],
        image_size=HW, write_video=False, out_ext="png")
    assert [len(w) for w in multi] == [5] * 3
    frame0 = load_frame_rgb(os.path.join(clip, "000.png"), HW)
    for i, ref in enumerate(refs):
        serial = []
        tvideo.colorize_frames(models, [frame0], load_frame_rgb(ref, HW),
                               lambda idx, a: serial.append(a))
        got = _read(multi[i][:1])[0]
        assert np.abs(got.astype(int) - serial[0]).max() <= 1


def test_colorize_video_multi_drops_a_corrupt_exemplar(weights, clip_files,
                                                       tmp_path):
    _, models = weights
    clip, refs = clip_files
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not an image")
    outs = [str(tmp_path / n) for n in ("a", "bad", "b")]
    with pytest.warns(UserWarning, match="skipping reference"):
        written = tvideo.colorize_video_multi(
            models, clip, [refs[0], str(bad), refs[1]], outs, image_size=HW,
            write_video=False)
    assert [len(w) for w in written] == [5, 5]
    assert os.path.basename(os.path.dirname(written[1][0])) == "b"
    assert not os.path.exists(outs[1])
    with pytest.raises(ValueError, match="all reference images"):
        tvideo.colorize_video_multi(models, clip, [str(bad)], outs[:1],
                                    image_size=HW, write_video=False)


def test_colorize_clip_matches_devc_tpu(weights):
    """pipeline/clip.py on network Lab: frame 0 against devc_tpu's
    colorize_clip (both from a zero carry), and the streaming API
    (make_frame_step) equal to colorize_clip bit for bit."""
    jparams, models = weights
    ref, *frames = textured_frames(40, 4)
    _, ref_lab = jvideo._preprocess_device(jnp.asarray(ref))
    frames_lab = jnp.concatenate(
        [jvideo._preprocess_device(jnp.asarray(f))[1] for f in frames])
    want_ab, want_sim = jax.jit(lambda fl, rl: jclip.colorize_clip(
        jparams, fl, rl, temperature=1e-10, use_pallas=False))(
        frames_lab, ref_lab[0])
    got_ab, got_sim = tclip.colorize_clip(models, _t(frames_lab),
                                          _t(ref_lab[0]))
    assert got_ab.shape == (3, HW[0] // 2, HW[1] // 2, 2)
    np.testing.assert_allclose(got_sim[0].numpy(), np.asarray(want_sim[0]),
                               atol=1e-3)
    assert np.abs(got_ab[0].numpy() - np.asarray(want_ab[0])).max() < 0.5

    init_fn, step_fn = tclip.make_frame_step(models)
    state = init_fn(_t(ref_lab[0]))
    last = torch.zeros((1, HW[0] // 2, HW[1] // 2, 3))
    for i, frame_lab in enumerate(_t(frames_lab)):
        ab, sim, last = step_fn(frame_lab, last, None, state)
        assert torch.equal(ab[0], got_ab[i]) and torch.equal(sim[0],
                                                             got_sim[i])
