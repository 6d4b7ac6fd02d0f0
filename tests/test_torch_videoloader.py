"""The port's training datasets and PrefetchLoader
(devc_tpu_torch/data/videoloader.py) against devc_tpu's, on synthetic
roots in the reference's directory layouts, on the CPU.

Every draw comes from the caller's RandomState in devc_tpu's order and
the host kernels are built from the same C++ with the same flags, so
samples and batches must be bit-equal, in both contracts (the float
fields and device_preprocess).
"""

import numpy as np
import pytest
from PIL import Image

from devc_tpu.data import videoloader as jv
from devc_tpu.data.flow import write_flo
from devc_tpu_torch.data import videoloader as tv

SIZE = (64, 64)


@pytest.fixture(scope="module")
def video_root(tmp_path_factory):
    """One clip of three frames, two pairs (tests/test_videoloader.py's
    layout), plus a second clip."""
    root = tmp_path_factory.mktemp("video")
    rng = np.random.RandomState(0)
    for clip_name, (h, w) in (("clip01", (80, 96)), ("clip02", (70, 100))):
        clip = root / clip_name
        for sub in ("input_pad", "reference", "reference_gt", "flow", "mask"):
            (clip / sub).mkdir(parents=True)
        for name in ("f1", "f2", "f3"):
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                clip / "input_pad" / f"{name}.jpg")
        for i in range(1, 6):
            Image.fromarray((rng.rand(60, 90, 3) * 255).astype(np.uint8)).save(
                clip / "reference" / f"r{i}.JPEG")
        for i in range(1, 4):
            Image.fromarray((rng.rand(h, w, 3) * 255).astype(np.uint8)).save(
                clip / "reference_gt" / f"g{i}.jpg")
        lines = []
        for a, b in (("f1", "f2"), ("f2", "f3")):
            write_flo(str(clip / "flow" / f"{a}_forward.flo"),
                      rng.randn(h, w, 2).astype(np.float32))
            write_flo(str(clip / "flow" / f"{a}_backward.flo"),
                      rng.randn(h, w, 2).astype(np.float32))
            Image.fromarray((rng.rand(h, w) * 255).astype(np.uint8)).save(
                clip / "mask" / f"{a}_mask.pgm")
            lines.append(f"{a}.jpg {b}.jpg rv.jpg rv1.jpg r1.J r2.J r3.J "
                         "r4.J r5.J g1.j g2.j g3.j")
        lines.append("a short line is skipped")
        (clip / "pairs_output_new.txt").write_text("\n".join(lines) + "\n")
    return root


@pytest.fixture(scope="module")
def imagenet_root(tmp_path_factory):
    """Stills of several aspects (tall ones take center_pad_threshold's
    crop) with pairs.txt, pairs_mid.txt and pairs_bad.txt."""
    root = tmp_path_factory.mktemp("imagenet")
    rng = np.random.RandomState(1)
    d = root / "class0"
    sizes = {"input": [(120, 160), (200, 150), (90, 200)],
             "input_mid": [(100, 130), (130, 100)],
             "input_bad": [(80, 120), (150, 150)]}
    for sub, shapes in sizes.items():
        (d / sub).mkdir(parents=True)
        for i, hw in enumerate(shapes):
            Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8)).save(
                d / sub / f"img{i}.JPEG")
    (d / "pairs.txt").write_text(
        "img0.JPEG img1.JPEG 1.0\nimg1.JPEG img2.JPEG 0.5\n"
        "img0.JPEG img2.JPEG 0\n")  # score 0: skipped
    (d / "pairs_mid.txt").write_text("img0.JPEG img1.JPEG\n")
    (d / "pairs_bad.txt").write_text("img0.JPEG img1.JPEG\n")
    return root


def _kw(kind, device_preprocess):
    kw = dict(image_size=SIZE, real_reference_probability=0.5,
              nonzero_placeholder_probability=0.5,
              device_preprocess=device_preprocess)
    if kind == "imagenet":
        kw["brightness_jitter"] = 3.0
    return kw


def _datasets(kind, root, device_preprocess):
    cls = "VideoPairsDataset" if kind == "video" else "ImageNetPairsDataset"
    kw = _kw(kind, device_preprocess)
    return getattr(tv, cls)(str(root), **kw), getattr(jv, cls)(str(root), **kw)


def _assert_same_item(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["float", "device_preprocess"])
@pytest.mark.parametrize("kind", ["video", "imagenet"])
def test_dataset_get_matches_devc_tpu(kind, device_preprocess, video_root,
                                      imagenet_root):
    root = video_root if kind == "video" else imagenet_root
    ours, theirs = _datasets(kind, root, device_preprocess)
    assert ours.items == theirs.items and len(ours) == len(theirs)
    for index in range(3):
        for seed in range(3):
            _assert_same_item(ours.get(index, np.random.RandomState(seed)),
                              theirs.get(index, np.random.RandomState(seed)))


def test_imagenet_with_mid_and_with_bad_select_the_same_pairs(imagenet_root):
    for with_bad in (False, True):
        for with_mid in (False, True):
            kw = dict(image_size=SIZE, with_bad=with_bad, with_mid=with_mid)
            assert (tv.ImageNetPairsDataset(str(imagenet_root), **kw).items
                    == jv.ImageNetPairsDataset(str(imagenet_root), **kw).items)


@pytest.mark.parametrize("device_preprocess", [False, True],
                         ids=["float", "device_preprocess"])
def test_prefetch_loader_batches_match_devc_tpu(device_preprocess, video_root,
                                                imagenet_root):
    """Batches 0..3 over both datasets: batch s is a pure function of
    RandomState(seed + s) in both packages."""
    ours = [tv.VideoPairsDataset(str(video_root),
                                 **_kw("video", device_preprocess)),
            tv.ImageNetPairsDataset(str(imagenet_root),
                                    **_kw("imagenet", device_preprocess))]
    theirs = [jv.VideoPairsDataset(str(video_root),
                                   **_kw("video", device_preprocess)),
              jv.ImageNetPairsDataset(str(imagenet_root),
                                      **_kw("imagenet", device_preprocess))]
    got = list(tv.PrefetchLoader(ours, batch_size=3, steps=4, workers=3,
                                 seed=7))
    want = list(jv.PrefetchLoader(theirs, batch_size=3, steps=4, workers=1,
                                  seed=7))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _assert_same_item(g, w)


def test_center_pad_threshold_matches_devc_tpu():
    rng = np.random.RandomState(2)
    for hw in ((200, 150), (120, 160), (90, 200), (64, 64)):
        img = Image.fromarray((rng.rand(*hw, 3) * 255).astype(np.uint8))
        np.testing.assert_array_equal(
            np.asarray(tv.center_pad_threshold(img, SIZE)),
            np.asarray(jv.center_pad_threshold(img, SIZE)))


def test_flow_f16_clamps_unknown_flow_sentinel():
    flow = np.array([[1e9, -1e9, 3.25, 0.0]], np.float32)
    out = tv._flow_f16(flow)
    assert out.dtype == np.float16 and np.isfinite(out.astype(np.float32)).all()
    np.testing.assert_array_equal(out, jv._flow_f16(flow))


def _tiny_item():
    return dict(last_lab=np.zeros((8, 8, 3), np.float32),
                mask=np.ones((8, 8, 1), np.float32),
                self_ref_flag=np.ones((1,), np.float32))


def test_prefetch_loader_resamples_corrupt():
    """A sample that raises is redrawn from the same RandomState
    (tests/test_videoloader.py's case, on the port's loader)."""

    class FlakyDS:
        def __len__(self):
            return 2

        def get(self, idx, rng):
            if idx == 0:
                raise IOError("corrupt")
            return _tiny_item()

    batches = list(tv.PrefetchLoader([FlakyDS()], batch_size=2, steps=2,
                                     workers=1))
    assert len(batches) == 2
    assert batches[0]["last_lab"].shape == (2, 8, 8, 3)


def test_prefetch_loader_raises_a_failed_batch_in_the_consumer():
    """Ten corrupt draws in a row fail the batch; the consumer sees the
    error instead of waiting for a batch that never comes."""

    class BrokenDS:
        def __len__(self):
            return 3

        def get(self, idx, rng):
            raise IOError("corrupt")

    with pytest.raises(RuntimeError, match="too many corrupt samples"):
        list(tv.PrefetchLoader([BrokenDS()], batch_size=1, steps=3,
                               workers=1))


def test_prefetch_loader_backpressure():
    """A slow consumer bounds the number of materialised batches."""
    import threading
    import time

    lock = threading.Lock()
    state = {"produced": 0, "consumed": 0, "max_inflight": 0}

    class CountingDS:
        def __len__(self):
            return 1000

        def get(self, idx, rng):
            with lock:
                state["produced"] += 1
                state["max_inflight"] = max(
                    state["max_inflight"],
                    state["produced"] - state["consumed"])
            return dict(x=np.zeros((4,), np.float32))

    workers, prefetch, steps = 2, 2, 40
    loader = tv.PrefetchLoader([CountingDS()], batch_size=1, steps=steps,
                               workers=workers, prefetch=prefetch)
    for _ in loader:
        time.sleep(0.01)
        with lock:
            state["consumed"] += 1
    assert state["produced"] == steps
    assert state["max_inflight"] <= workers + 2 * prefetch + 2, state


def test_prefetch_loader_long_run_flat_memory():
    """5000 batches through a slow-ish consumer: resident memory stays
    flat (no batch of the run is built up front)."""
    import resource

    class TinyDS:
        def __len__(self):
            return 100

        def get(self, idx, rng):
            return dict(x=np.zeros((256,), np.float32))

    steps = 5000
    it = iter(tv.PrefetchLoader([TinyDS()], batch_size=4, steps=steps,
                                workers=2, prefetch=2))
    for _ in range(50):
        next(it)
    rss0 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    n = 50 + sum(1 for _ in it)
    assert n == steps
    rss1 = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    assert rss1 - rss0 < 50 * 1024, (rss0, rss1)
