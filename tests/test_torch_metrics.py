"""The port's quality metrics (devc_tpu_torch/utils/metrics.py) and its
cli.evaluate vs devc_tpu's (devc_tpu/utils/metrics.py, python -m
cli.evaluate) on the CPU, on the same seeded images and flows.

Tolerances: both sides compute in float64 on the CPU with the same
formulas and other summation orders (numpy's convolve vs a conv2d), so
each metric agrees to 1e-9 relative; warp_backward elementwise to 1e-9.
The CLI's JSON report rounds to 3 or 4 decimals and must be identical.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from cli import evaluate as jeval
from devc_tpu.data.flow import write_flo
from devc_tpu.utils import metrics as jm
from devc_tpu_torch.cli import evaluate as teval
from devc_tpu_torch.utils import metrics as tm


def _images(seed, n=3, hw=(40, 56), channels=3):
    """Smooth uint8 images with noise: frame t + 1 is frame t shifted by
    one pixel right and down, plus noise."""
    rng = np.random.RandomState(seed)
    h, w = hw
    base = np.kron(rng.rand(h // 8 + 2, w // 8 + 2, channels),
                   np.ones((8, 8, 1))) * 200 + 20
    out = []
    for t in range(n):
        img = base[t:t + h, t:t + w] + rng.randn(h, w, channels) * 8
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out if channels > 1 else [o[..., 0] for o in out]


def _flow(seed, hw=(40, 56)):
    rng = np.random.RandomState(seed)
    return (rng.randn(*hw, 2) * 3).astype(np.float32)


@pytest.mark.parametrize("channels", [1, 3])
def test_psnr_and_ssim_match_devc_tpu(channels):
    a, b, _ = _images(0, channels=channels)
    assert tm.psnr(a, b) == pytest.approx(jm.psnr(a, b), rel=1e-9)
    assert tm.ssim(a, b) == pytest.approx(jm.ssim(a, b), rel=1e-9)
    # torch tensors in, float inputs, another range and window
    fa, fb = a / 255.0, b / 255.0
    assert tm.psnr(torch.from_numpy(fa), torch.from_numpy(fb),
                   data_range=1.0) == pytest.approx(
        jm.psnr(fa, fb, data_range=1.0), rel=1e-9)
    assert tm.ssim(fa, fb, data_range=1.0, sigma=2.0) == pytest.approx(
        jm.ssim(fa, fb, data_range=1.0, sigma=2.0), rel=1e-9)
    assert tm.psnr(a, a) == float("inf")
    assert tm.ssim(a, a) == pytest.approx(1.0, abs=1e-12)
    with pytest.raises(ValueError, match="shape mismatch"):
        tm.psnr(a, b[:-1])


@pytest.mark.parametrize("channels", [1, 3])
def test_warp_backward_matches_devc_tpu(channels):
    img = _images(1, n=1, channels=channels)[0]
    flow = _flow(2)
    got = tm.warp_backward(img, flow)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), jm.warp_backward(img, flow),
                               rtol=1e-9, atol=1e-9)
    # integer flows move pixels exactly; outside the frame is zero
    shift = np.zeros((40, 56, 2), np.float32)
    shift[..., 0] = 2.0
    moved = tm.warp_backward(img, shift).numpy()
    np.testing.assert_array_equal(moved[:, :-2], img[:, 2:])
    assert not moved[:, -2:].any()


def test_temporal_warp_error_matches_devc_tpu():
    frames = _images(3, n=4)
    flows = [_flow(4 + t) for t in range(3)]
    masks = [(np.random.RandomState(9 + t).rand(40, 56) > 0.3)
             .astype(np.float32) for t in range(3)]
    for fl, ms in ((None, None), (flows, None), (flows, masks)):
        assert tm.temporal_warp_error(frames, fl, ms) == pytest.approx(
            jm.temporal_warp_error(frames, fl, ms), rel=1e-9)
    with pytest.raises(ValueError, match="two frames"):
        tm.temporal_warp_error(frames[:1])


def test_metrics_on_cuda_without_gpu_raise():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    a, b, _ = _images(0)
    with pytest.raises(RuntimeError, match="cuda"):
        tm.psnr(a, b, device="cuda")


@pytest.fixture
def dirs(tmp_path):
    """Two frame directories of 3 frames (b = a plus noise; one frame
    identical) and forward flows for dir a's frames."""
    a = _images(5)
    rng = np.random.RandomState(6)
    b = [np.clip(f + rng.randn(*f.shape) * 6, 0, 255).astype(np.uint8)
         for f in a]
    b[1] = a[1]
    da, db, dflow = tmp_path / "a", tmp_path / "b", tmp_path / "flow"
    for d in (da, db, dflow):
        d.mkdir()
    for i, (fa, fb) in enumerate(zip(a, b)):
        Image.fromarray(fa).save(da / f"{i:05d}.png")
        Image.fromarray(fb).save(db / f"{i:05d}.png")
        write_flo(str(dflow / f"{i:05d}_forward.flo"), _flow(7 + i))
    return str(da), str(db), str(dflow)


def _report(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, json.loads(out[-1])


@pytest.mark.parametrize("flow", [False, True])
def test_cli_evaluate_report_matches_devc_tpu(dirs, capsys, flow):
    da, db, dflow = dirs
    argv = ["--dir_a", da, "--dir_b", db, "--json"]
    if flow:
        argv += ["--flow_dir", dflow]
    want_rc, want = _report(jeval.main, argv, capsys)
    got_rc, got = _report(teval.main, argv + ["--device", "cpu"], capsys)
    assert got == want and got_rc == want_rc == 0
    assert got["compared"] == 3 and got["identical_frames"] == 1
    assert "temporal_rmse" in got
    # thresholds fail alike; --temporal-only drops the comparison
    argv_gate = argv + ["--min_psnr", "99"]
    assert teval.main(argv_gate + ["--device", "cpu"]) == 1 == \
        jeval.main(argv_gate)
    capsys.readouterr()
    _, only = _report(teval.main, ["--dir_a", da, "--temporal-only",
                                   "--json", "--device", "cpu"], capsys)
    assert set(only) == {"dir_a", "frames", "temporal_rmse"}


def test_cli_evaluate_defaults_to_the_card(dirs):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    da, db, _ = dirs
    with pytest.raises(RuntimeError, match="cuda"):
        teval.main(["--dir_a", da, "--dir_b", db, "--json"])
    assert os.path.isdir(da)
