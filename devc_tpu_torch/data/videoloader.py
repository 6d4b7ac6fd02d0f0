"""Training datasets and the threaded prefetching loader (mirrors
devc_tpu/data/videoloader.py; reference lib/videoloader.py,
lib/videoloader_imagenet.py).

Items are dicts of NHWC numpy arrays, in one of two contracts:

* the float contract, the reference loaders' 8 fields
  (lib/videoloader.py:266-275):
    last_lab, current_lab, ref_lab  [H, W, 3]  network Lab, float32
    flow_forward, flow_backward     [H, W, 2]  (u horizontal, v vertical)
    mask                            [H, W, 1]
    placeholder_lab                 [H, W, 3]
    self_ref_flag                   [1]        1.0 = ground-truth reference
* device_preprocess: uint8 RGB frames (last_rgb, current_rgb, ref_rgb),
  fp16 flows, a uint8 mask and the jitter / placeholder / self-reference
  flags; `train/loop.py::preprocess_batch_u8` makes the float batch on
  the device.

VideoPairsDataset reads real frame pairs with precomputed .flo flows and
occlusion masks (the reference's directory layout and
pairs_output_new.txt); ImageNetPairsDataset synthesises the second frame
of a still (elastic flow, the C++ forward warp, a photoconsistency mask).
PrefetchLoader samples uniformly over the concatenated datasets; batch s
is a pure function of RandomState(seed + s), built by a thread pool a few
batches ahead. Every draw is devc_tpu's, in its order, so the same seed
gives the same samples and batches in both packages.
"""

from __future__ import annotations

import os
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
from PIL import Image

from devc_tpu_torch.data import distortion as D
from devc_tpu_torch.data.flow import read_flo
from devc_tpu_torch.data.transforms import (
    center_crop,
    center_pad,
    lab_to_network,
    read_rgb as _load_rgb,
    rgb_to_lab_np,
)


def _center_crop_pad(arr, size):
    """Center crop; zero-pad first if smaller (torchvision CenterCrop)."""
    th, tw = size
    h, w = arr.shape[:2]
    if h < th or w < tw:
        ph, pw = max(th - h, 0), max(tw - w, 0)
        pad = [(ph // 2, ph - ph // 2), (pw // 2, pw - pw // 2)]
        if arr.ndim == 3:
            pad.append((0, 0))
        arr = np.pad(arr, pad)
    return center_crop(arr, size)


def _to_network_lab(rgb_u8):
    return lab_to_network(rgb_to_lab_np(rgb_u8))


def _flow_f16(flow):
    """fp16 flow for the device_preprocess contract. Clamped first: .flo
    unknown-flow sentinels (~1e9, Middlebury) would overflow fp16 to inf
    and NaN-poison the consistency loss; the float path keeps them finite
    and masked, so clamp to the finite fp16 range instead.

    fp16 over bf16 deliberately (ADVICE r2): same 2-byte transfer, but at
    realistic flow magnitudes fp16's 10-bit mantissa quantizes far finer
    (ulp 0.25 px at |flow|=256 vs bf16's 2.0 px); the range cliff only
    threatens the sentinels, which the clamp handles."""
    return np.clip(flow, -6.0e4, 6.0e4).astype(np.float16)


def center_pad_threshold(img: Image.Image, size, threshold: float = 3 / 4):
    """CenterPad variant for ImageNet stills (reference
    utils/util_distortion.py:261-315): overly tall images are first cropped
    to `threshold` aspect then resized to the target."""
    th, tw = size
    w, h = img.size
    if h / w > threshold:
        new_h = int(w * threshold)
        top = (h - new_h) // 2
        img = img.crop((0, top, w, top + new_h))
        return img.resize((tw, th), Image.BILINEAR)
    return center_pad(img, size)


class VideoPairsDataset:
    """Real video pairs (reference lib/videoloader.py:172-279)."""

    def __init__(
        self,
        data_root: str,
        image_size=(216, 384),
        real_reference_probability: float = 0.7,
        nonzero_placeholder_probability: float = 0.0,
        device_preprocess: bool = False,
    ):
        self.data_root = data_root
        self.image_size = tuple(image_size)
        self.real_reference_probability = real_reference_probability
        self.nonzero_placeholder_probability = nonzero_placeholder_probability
        self.device_preprocess = device_preprocess
        self.items = self._parse(data_root)
        if not self.items:
            raise RuntimeError(f"no pairs found under {data_root}")

    @staticmethod
    def _parse(data_root):
        items = []
        for subdir in sorted(os.listdir(data_root)):
            path = os.path.join(data_root, subdir)
            if not os.path.isdir(path):
                continue
            pairs_file = os.path.join(path, "pairs_output_new.txt")
            if not os.path.exists(pairs_file):
                raise RuntimeError(f"missing pairs_output_new.txt in {path}")
            with open(pairs_file) as f:
                for line in f:
                    fields = line.split()
                    if len(fields) != 12:
                        continue
                    stem = lambda s: s.split(".")[0]
                    (i1, i2, _refvid, _refvid1, r1, r2, r3, r4, r5,
                     g1, g2, g3) = [stem(x) for x in fields]
                    items.append(
                        dict(
                            path=path,
                            image1=i1 + ".jpg",
                            image2=i2 + ".jpg",
                            refs_real=[r + ".JPEG" for r in (r1, r2, r3, r4, r5)],
                            refs_gt=[g + ".jpg" for g in (g1, g2, g3)],
                            flow_forward=i1 + "_forward.flo",
                            flow_backward=i1 + "_backward.flo",
                            mask=i1 + "_mask.pgm",
                        )
                    )
        return items

    def __len__(self):
        return len(self.items)

    def get(self, index: int, rng: np.random.RandomState):
        it = self.items[index % len(self.items)]
        p = it["path"]
        size = self.image_size

        i1_u8 = _center_crop_pad(_load_rgb(os.path.join(p, "input_pad", it["image1"])), size)
        i2_u8 = _center_crop_pad(_load_rgb(os.path.join(p, "input_pad", it["image2"])), size)

        use_real = rng.random_sample() < self.real_reference_probability
        if use_real:
            ref_name = it["refs_real"][rng.randint(len(it["refs_real"]))]
            ref_img = Image.open(os.path.join(p, "reference", ref_name)).convert("RGB")
        else:
            ref_name = it["refs_gt"][rng.randint(len(it["refs_gt"]))]
            ref_img = Image.open(os.path.join(p, "reference_gt", ref_name)).convert("RGB")
        ref_rgb = _center_crop_pad(
            np.asarray(center_pad(ref_img, size), dtype=np.uint8), size
        )

        flow_f = center_crop(read_flo(os.path.join(p, "flow", it["flow_forward"])), size)
        flow_b = center_crop(read_flo(os.path.join(p, "flow", it["flow_backward"])), size)
        mask_u8 = np.asarray(Image.open(os.path.join(p, "mask", it["mask"])))
        mask = center_crop(D.binary_mask_from_image(mask_u8), size)[..., None]

        nonzero_ph = (not use_real) and (
            rng.random_sample() < self.nonzero_placeholder_probability
        )
        flag = np.full((1,), 0.0 if use_real else 1.0, np.float32)

        if self.device_preprocess:
            return dict(
                last_rgb=i1_u8,
                current_rgb=i2_u8,
                ref_rgb=ref_rgb,
                flow_forward=_flow_f16(flow_f),
                flow_backward=_flow_f16(flow_b),
                mask=mask.astype(np.uint8),
                jitter=np.zeros((1,), np.float32),
                placeholder_flag=np.full((1,), float(nonzero_ph), np.float32),
                self_ref_flag=flag,
            )

        last_lab = _to_network_lab(i1_u8)
        current_lab = _to_network_lab(i2_u8)
        ref_lab = _to_network_lab(ref_rgb)
        placeholder = current_lab.copy() if nonzero_ph else np.zeros_like(last_lab)

        return dict(
            last_lab=last_lab,
            current_lab=current_lab,
            ref_lab=ref_lab,
            flow_forward=flow_f.astype(np.float32),
            flow_backward=flow_b.astype(np.float32),
            mask=mask.astype(np.float32),
            placeholder_lab=placeholder,
            self_ref_flag=flag,
        )


class ImageNetPairsDataset:
    """Synthetic videos from stills (reference lib/videoloader_imagenet.py)."""

    def __init__(
        self,
        data_root: str,
        image_size=(216, 384),
        with_bad: bool = True,
        with_mid: bool = True,
        distortion_level: float = 4.0,
        brightness_jitter: float = 5.0,
        real_reference_probability: float = 0.7,
        nonzero_placeholder_probability: float = 0.0,
        device_preprocess: bool = False,
    ):
        self.image_size = tuple(image_size)
        self.distortion_level = distortion_level
        self.brightness_jitter = brightness_jitter
        self.real_reference_probability = real_reference_probability
        self.nonzero_placeholder_probability = nonzero_placeholder_probability
        self.device_preprocess = device_preprocess
        self.items = self._parse(data_root, with_bad, with_mid)
        if not self.items:
            raise RuntimeError(f"no pairs found under {data_root}")

    @staticmethod
    def _parse(root, with_bad, with_mid):
        items = []
        root = os.path.expanduser(root)
        for target in sorted(os.listdir(root)):
            d = os.path.join(root, target)
            if not os.path.isdir(d):
                continue
            specs = [("pairs.txt", "input", True)]
            if with_mid:
                specs.append(("pairs_mid.txt", "input_mid", False))
            if with_bad:
                specs.append(("pairs_bad.txt", "input_bad", False))
            for fname, subdir, check_score in specs:
                pf = os.path.join(d, fname)
                if not os.path.exists(pf):
                    continue
                with open(pf) as f:
                    for line in f:
                        pair = line.strip().split(" ")
                        if len(pair) < 2:
                            continue
                        n0 = pair[0].split(".")[0]
                        n1 = pair[1].split(".")[0]
                        if check_score and (len(pair) < 3 or float(pair[2]) <= 0):
                            continue
                        items.append((d, subdir, n0, n1))
                        items.append((d, subdir, n1, n0))
        return items

    def __len__(self):
        return len(self.items)

    def get(self, index: int, rng: np.random.RandomState):
        d, subdir, name_a, name_b = self.items[index % len(self.items)]
        path_a = os.path.join(d, subdir, name_a + ".JPEG")
        path_b = os.path.join(d, subdir, name_b + ".JPEG")
        if rng.random_sample() > 0.5:
            path_a, path_b = path_b, path_a
        size = self.image_size

        img_a = Image.open(path_a).convert("RGB")
        i1_rgb = np.asarray(center_pad_threshold(img_a, size), dtype=np.uint8)
        i1_rgb = _center_crop_pad(i1_rgb, size)

        dx, dy = D.random_elastic_flow(size, self.distortion_level, rng=rng)
        i2_rgb = D.distort_with_flow(i1_rgb, dx, dy)

        # single L-channel offset (reference videoloader_imagenet.py:226);
        # applied here (host float path) or on device (device_preprocess)
        jitter = np.float32(rng.randn() * self.brightness_jitter)

        flow_forward = np.stack((dy, dx), axis=-1).astype(np.float32)
        flow_backward = np.zeros_like(flow_forward)
        mask = D.occlusion_mask(i1_rgb, i2_rgb, flow_forward)

        use_real = rng.random_sample() < self.real_reference_probability
        if use_real:
            img_b = Image.open(path_b).convert("RGB")
            ref_rgb = np.asarray(center_pad_threshold(img_b, size), np.uint8)
            ref_rgb = _center_crop_pad(ref_rgb, size)
            nonzero_ph = False
            flag = np.zeros((1,), np.float32)
        else:
            # self-reference: flip + RandomResizedCrop(480,(0.98,1.0),(0.8,1.2))
            # of the RAW still, then the usual pad pipeline (reference
            # extra_reference_transform, train.py:251-254, applied at
            # lib/videoloader_imagenet.py:228 before transforms_imagenet_raw)
            ref_raw = np.asarray(img_a, dtype=np.uint8)
            ref_raw = D.random_horizontal_flip(ref_raw, 0.5, rng)
            ref_raw = D.random_resized_crop(
                ref_raw, 480, scale=(0.98, 1.0), ratio=(0.8, 1.2), rng=rng
            )
            ref_rgb = np.asarray(
                center_pad_threshold(Image.fromarray(ref_raw), size), np.uint8
            )
            ref_rgb = _center_crop_pad(ref_rgb, size)
            nonzero_ph = (
                rng.random_sample() < self.nonzero_placeholder_probability
            )
            flag = np.ones((1,), np.float32)

        if self.device_preprocess:
            return dict(
                last_rgb=i1_rgb,
                current_rgb=i2_rgb,
                ref_rgb=ref_rgb,
                flow_forward=_flow_f16(flow_forward),
                flow_backward=_flow_f16(flow_backward),
                mask=mask.astype(np.uint8),
                jitter=np.full((1,), jitter, np.float32),
                placeholder_flag=np.full((1,), float(nonzero_ph), np.float32),
                self_ref_flag=flag,
            )

        last_lab = lab_to_network(rgb_to_lab_np(i1_rgb))
        current_lab = lab_to_network(rgb_to_lab_np(i2_rgb))
        current_lab[..., 0] += jitter
        ref_lab = lab_to_network(rgb_to_lab_np(ref_rgb))
        placeholder = (
            current_lab.copy() if nonzero_ph else np.zeros_like(last_lab)
        )

        return dict(
            last_lab=last_lab,
            current_lab=current_lab,
            ref_lab=ref_lab,
            flow_forward=flow_forward,
            flow_backward=flow_backward,
            mask=mask.astype(np.float32),
            placeholder_lab=placeholder,
            self_ref_flag=flag,
        )


class _Failed:
    """A batch that raised, handed to the consumer in the batch's place."""

    def __init__(self, error):
        self.error = error


class PrefetchLoader:
    """Uniformly samples items from concatenated datasets, assembles
    batches with a thread pool, and prefetches ahead (the reference's
    worker DataLoader, train.py:280-292; threads instead of processes —
    decode/augment is C-heavy and releases the GIL). A batch that fails
    (e.g. too many corrupt samples in a row) raises in the consumer; in
    devc_tpu the producer thread dies and the consumer waits forever."""

    def __init__(self, datasets, batch_size: int, steps: int,
                 workers: int = 8, prefetch: int = 4, seed: int = 0,
                 drop_corrupt: bool = True):
        self.datasets = list(datasets)
        self.batch_size = batch_size
        self.steps = steps
        self.workers = workers
        self.prefetch = prefetch
        self.seed = seed
        self.drop_corrupt = drop_corrupt
        self._lengths = [len(d) for d in self.datasets]
        self._total = sum(self._lengths)

    def _sample(self, rng):
        idx = rng.randint(self._total)
        for d, n in zip(self.datasets, self._lengths):
            if idx < n:
                for _ in range(10):
                    try:
                        return d.get(idx, rng)
                    except Exception:
                        if not self.drop_corrupt:
                            raise
                        idx = rng.randint(n)  # resample like the reference
                raise RuntimeError("too many corrupt samples")
            idx -= n
        raise AssertionError

    def __iter__(self):
        stop = object()
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)

        def make_batch(step):
            rng = np.random.RandomState(self.seed + step)
            items = [self._sample(rng) for _ in range(self.batch_size)]
            return {
                k: np.stack([it[k] for it in items]) for k in items[0]
            }

        def producer():
            # Bounded in-flight futures: at most workers+prefetch batches are
            # being built while <=prefetch sit in the queue, so a slow
            # consumer backpressures the pool instead of the pool
            # materializing every batch of the run up front.
            from collections import deque

            inflight = self.workers + self.prefetch
            try:
                with ThreadPoolExecutor(self.workers) as pool:
                    dq: "deque" = deque()
                    for s in range(self.steps):
                        dq.append(pool.submit(make_batch, s))
                        if len(dq) >= inflight:
                            q.put(dq.popleft().result())
                    while dq:
                        q.put(dq.popleft().result())
            except Exception as e:  # a batch failed: the consumer raises
                q.put(_Failed(e))
                return
            q.put(stop)

        threading.Thread(target=producer, daemon=True).start()
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _Failed):
                raise item.error
            yield item

    def __len__(self):
        return self.steps
