"""The port's host data layer (devc_tpu_torch/data/{flow,native,
transforms,distortion}.py) against devc_tpu's, on the CPU.

Tolerances: both packages build the same C++ sources with the same g++
flags on the same host and draw from the same RandomState in the same
order, so .flo files, the native kernels, every distortion and the host
CenterPad must agree bit for bit. Each native kernel is also held against
its own numpy plain version: the forward warp within the bound of
tests/test_data.py::test_forward_warp_native_matches_numpy (under 1% of
values more than 2 uint8 steps apart), the float64 resize within 1e-9.
"""

import os

import numpy as np
import pytest
from PIL import Image
from scipy import ndimage as ndi

from devc_tpu.data import distortion as JD
from devc_tpu.data import flow as jflow
from devc_tpu.data import native as jnative
from devc_tpu.data import transforms as jt
from devc_tpu_torch.data import distortion as TD
from devc_tpu_torch.data import flow as tflow
from devc_tpu_torch.data import native as tnative
from devc_tpu_torch.data import transforms as tt


def _image(seed, h, w, c=3):
    return np.random.RandomState(seed).randint(0, 256, (h, w, c),
                                               dtype=np.uint8)


def _smooth_flow(seed, h, w, scale):
    rng = np.random.RandomState(seed)
    return [(ndi.gaussian_filter(rng.rand(h, w) * 2 - 1, 8) * scale
             ).astype(np.float32) for _ in range(2)]


@pytest.mark.parametrize("writer,reader", [(jflow, tflow), (tflow, jflow)],
                         ids=["devc_tpu_to_port", "port_to_devc_tpu"])
def test_flo_written_by_one_package_reads_in_the_other(tmp_path, writer,
                                                       reader):
    flow = np.random.RandomState(0).randn(7, 9, 2).astype(np.float32)
    flow[0, 0] = [1e9, -1e9]  # an unknown-flow sentinel survives as is
    path = str(tmp_path / "x.flo")
    writer.write_flo(path, flow)
    np.testing.assert_array_equal(reader.read_flo(path), flow)


def test_flo_refuses_a_bad_magic(tmp_path):
    path = tmp_path / "bad.flo"
    path.write_bytes(b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        tflow.read_flo(str(path))


def test_flow_to_color_and_epe_match_devc_tpu():
    rng = np.random.RandomState(1)
    flow = rng.randn(20, 30, 2).astype(np.float32) * 5
    flow[3, 4] = np.nan
    np.testing.assert_array_equal(tflow.flow_to_color(flow),
                                  jflow.flow_to_color(flow))
    np.testing.assert_array_equal(tflow.flow_to_color(flow, max_flow=4.0),
                                  jflow.flow_to_color(flow, max_flow=4.0))
    gt = rng.randn(20, 30, 2).astype(np.float32)
    assert tflow.flow_epe(flow[5:], gt[5:]) == jflow.flow_epe(flow[5:], gt[5:])


@pytest.mark.parametrize("shape,scale,iters,prec", [
    ((32, 48, 3), 40.0, 3, 1e-3), ((45, 61, 3), 8.0, 5, 1e-2),
    ((24, 40, 1), 20.0, 3, 1e-3)])
def test_forward_warp_matches_devc_tpu_and_its_plain_version(shape, scale,
                                                              iters, prec):
    h, w, c = shape
    src = _image(2, h, w, c)
    u, v = _smooth_flow(3, h, w, scale)
    got = tnative.forward_warp(src, u, v, iters, prec)
    np.testing.assert_array_equal(got, jnative.forward_warp(src, u, v, iters,
                                                            prec))
    plain = tnative._forward_warp_numpy(src, u, v, iters, prec)
    assert (np.abs(got.astype(int) - plain.astype(int)) > 2).mean() < 0.01


@pytest.mark.parametrize("src_hw,out_hw", [
    ((97, 150), (64, 96)), ((160, 100), (64, 120)), ((48, 64), (64, 96)),
    ((300, 450), (128, 170))])
def test_resize_aa_matches_devc_tpu_and_its_plain_version(src_hw, out_hw):
    img = _image(4, *src_hw)
    got = tnative.resize_aa_native(img, out_hw)
    np.testing.assert_array_equal(got, jnative.resize_aa_native(img, out_hw))
    np.testing.assert_array_equal(tt.resize_antialiased(img, out_hw), got)
    plain = tt.resize_antialiased_plain(img, out_hw)
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-9)
    gray = img[..., 0]
    np.testing.assert_allclose(tnative.resize_aa_native(gray, out_hw),
                               tt.resize_antialiased_plain(gray, out_hw),
                               rtol=0, atol=1e-9)


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """A failed g++ build raises; nothing falls back to numpy."""
    broken = tmp_path / "broken.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "_SRCS", [str(broken)])
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_lib", None)
    with pytest.raises(tnative.NativeBuildError, match="g\\+\\+"):
        tnative.forward_warp(_image(0, 8, 8), np.zeros((8, 8), np.float32),
                             np.zeros((8, 8), np.float32))
    with pytest.raises(tnative.NativeBuildError):
        tt.resize_antialiased(_image(0, 16, 16), (8, 8))


def test_native_library_lands_in_the_port_build_dir():
    lib = tnative.get_lib()
    assert lib is tnative.get_lib()
    assert any(f.endswith(".so") for _d, _s, fs in
               os.walk(tnative.BUILD_DIR) for f in fs)


@pytest.mark.parametrize("src_hw", [(97, 150), (160, 100), (64, 96),
                                    (48, 64), (540, 960), (720, 1280)])
def test_host_centerpad_matches_devc_tpu_exactly(src_hw):
    """Both packages take the native resize: CenterPad + CenterCrop agree
    bit for bit (the numpy-only port was within one uint8 step)."""
    raw = _image(5, *src_hw)
    size = (432, 768) if src_hw[0] > 400 else (64, 96)
    np.testing.assert_array_equal(tt.centerpad_np(raw, size),
                                  jt.centerpad_np(raw, size))


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_pil_center_pad_and_crop_match_devc_tpu(mode):
    img = Image.fromarray(_image(6, 90, 140)).convert(mode)
    for size in ((64, 96), (64, 64), (45, 70)):
        got = np.asarray(tt.center_pad(img, size))
        np.testing.assert_array_equal(got, np.asarray(jt.center_pad(img,
                                                                    size)))
        np.testing.assert_array_equal(tt.center_crop(got, (40, 50)),
                                      jt.center_crop(got, (40, 50)))


def test_rgb_to_lab_and_network_lab_match_devc_tpu():
    rgb = _image(7, 16, 24)
    lab = tt.rgb_to_lab_np(rgb)
    np.testing.assert_array_equal(lab, jt.rgb_to_lab_np(rgb))
    np.testing.assert_array_equal(tt.lab_to_network(lab),
                                  jt.lab_to_network(lab))


def _distortion_cases():
    img = _image(8, 40, 56)
    flow = np.random.RandomState(9).randn(40, 56, 2).astype(np.float32) * 3
    lab = np.random.RandomState(10).randn(40, 56, 3).astype(np.float32)
    mask_u8 = _image(11, 40, 56, 1)[..., 0]
    big = _image(12, 100, 140)
    return {
        "random_elastic_flow": lambda M, r: M.random_elastic_flow(
            (40, 56), 4.0, rng=r),
        "random_elastic_flow_small_sigma": lambda M, r: M.random_elastic_flow(
            (40, 56), 3.0, sigma=5.0, rng=r),
        "distort_with_flow": lambda M, r: M.distort_with_flow(
            img, *M.random_elastic_flow((40, 56), 4.0, rng=r)),
        "elastic_distort_backward": lambda M, r: M.elastic_distort_backward(
            img, 3.0, rng=r),
        "backward_warp_np": lambda M, r: M.backward_warp_np(img, flow),
        "occlusion_mask": lambda M, r: M.occlusion_mask(
            img, M.distort_with_flow(img, *(flow[..., ::-1].transpose(
                2, 0, 1))), flow),
        "binary_mask_from_image": lambda M, r: M.binary_mask_from_image(
            mask_u8),
        "gaussian_luminance_noise": lambda M, r: M.gaussian_luminance_noise(
            lab, 0.1, rng=r),
        "random_erasing": lambda M, r: [M.random_erasing(img, 0.9, rng=r)
                                        for _ in range(4)],
        "random_horizontal_flip": lambda M, r: [
            M.random_horizontal_flip(img, 0.5, r) for _ in range(4)],
        "random_resized_crop": lambda M, r: [
            M.random_resized_crop(big, 48, rng=r),
            M.random_resized_crop(big, 32, scale=(0.01, 0.02),
                                  ratio=(5.0, 6.0), rng=r)],
    }


@pytest.mark.parametrize("name", sorted(_distortion_cases()))
def test_distortion_matches_devc_tpu_on_one_seed(name):
    fn = _distortion_cases()[name]
    for seed in range(3):
        got = fn(TD, np.random.RandomState(seed))
        want = fn(JD, np.random.RandomState(seed))
        got = got if isinstance(got, (list, tuple)) else [got]
        want = want if isinstance(want, (list, tuple)) else [want]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
