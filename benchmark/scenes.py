"""The inputs the traffic mixes are made of, drawn from the run's seed: a
textured scene panned across the frame (a clip), and an exemplar.

The texture is `chip_smoke.py::textured_frames`'s: a smooth random colour
field of 8-pixel cells plus noise, with no flat regions, so that exact
ties in the correspondence stay rare. The clip pans it by a few pixels a
frame; a clip of `n` distinct frames is cycled, each return to its first
frame a cut."""

from __future__ import annotations

import numpy as np


def rng_for(seed: int, stream: int) -> np.random.Generator:
    """Independent draws for each input of one seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def textured(rng: np.random.Generator, h: int, w: int) -> np.ndarray:
    coarse = rng.random((h // 8 + 1, w // 8 + 1, 3))
    field = np.kron(coarse, np.ones((8, 8, 1)))[:h, :w]
    img = field * 200 + 20 + rng.standard_normal((h, w, 3)) * 12
    return np.clip(img, 0, 255).astype(np.uint8)


def panned_clip(seed: int, hw, n: int, pan) -> list:
    """n uint8 [H, W, 3] frames: a window of hw panned by pan = (dy, dx)
    pixels a frame across one textured scene."""
    h, w = hw
    dy, dx = pan
    scene = textured(rng_for(seed, 0), h + n * dy, w + n * dx)
    return [np.ascontiguousarray(scene[i * dy:i * dy + h, i * dx:i * dx + w])
            for i in range(n)]


def exemplar(seed: int, hw) -> np.ndarray:
    return textured(rng_for(seed, 1), *hw)


def train_batch_u8(seed: int, step: int, b: int, hw) -> dict:
    """A uint8 training batch in the loader's device-preprocess form
    (`chip_smoke.py::synthetic_batch_u8`): textured frames, a smooth flow
    of a few pixels, an occlusion mask, brightness jitter and alternating
    placeholder / self-reference flags; every row its own draw."""
    rng = rng_for(seed, 100 + step)
    h, w = hw

    def frames():
        return np.stack([textured(rng, h, w) for _ in range(b)])

    coarse = rng.standard_normal((b, h // 16 + 1, w // 16 + 1, 2)) * 3
    flow = np.kron(coarse, np.ones((1, 16, 16, 1)))[:, :h, :w]
    flags = (np.arange(b) % 2 == 0)[:, None].astype(np.float32)
    return {
        "last_rgb": frames(), "current_rgb": frames(), "ref_rgb": frames(),
        "flow_forward": flow.astype(np.float16),
        "flow_backward": np.zeros((b, h, w, 2), np.float16),
        "mask": (rng.random((b, h, w, 1)) > 0.2).astype(np.uint8),
        "jitter": rng.uniform(-5, 5, (b, 1)).astype(np.float32),
        "placeholder_flag": flags.copy(),
        "self_ref_flag": flags.copy(),
    }


def write_stills_tree(root: str, seed: int, classes: int, per_class: int,
                      h_range, w_range) -> None:
    """The ImageNet-pairs layout (`chip_smoke.py::write_imagenet_root`):
    <root>/class<c>/input/img<i>.JPEG, textured stills of random size,
    consecutive stills paired in pairs.txt with a positive score."""
    import os

    from PIL import Image

    rng = rng_for(seed, 3)
    for c in range(classes):
        d = os.path.join(root, f"class{c}", "input")
        os.makedirs(d)
        for i in range(per_class):
            img = textured(rng, int(rng.integers(*h_range)),
                           int(rng.integers(*w_range)))
            Image.fromarray(img).save(os.path.join(d, f"img{i}.JPEG"),
                                      quality=95)
        with open(os.path.join(root, f"class{c}", "pairs.txt"), "w") as f:
            for i in range(per_class - 1):
                f.write(f"img{i}.JPEG img{i + 1}.JPEG 1.0\n")


def write_serve_jobs(root: str, seed: int, hw, mix: dict) -> dict:
    """A serving backlog under root: mix["distinct_frames"] frames of a
    panned scene and mix["exemplars"] exemplars as JPEGs (quality 95), and
    job folders of links to runs of those frames, each from its own start
    (each return to the first frame a cut). {"warm": slots + 1 jobs of
    mix["warm_frames"] frames, "backlog": mix["jobs"] jobs of lengths
    drawn from mix["clip_frames"] (both ends in)}; a job is {"clip": its
    folder, "ref": its exemplar, "frames": its frames' paths}."""
    import os

    from PIL import Image

    n = mix["distinct_frames"]
    frames = panned_clip(seed, hw, n, mix["pan_px"])
    rng = rng_for(seed, 6)
    src = os.path.join(root, "frames")
    os.makedirs(src)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(os.path.join(src, f"{i:05d}.jpg"),
                                quality=95)
    refs = []
    for k in range(mix["exemplars"]):
        refs.append(os.path.join(root, f"exemplar{k}.jpg"))
        Image.fromarray(textured(rng, *hw)).save(refs[-1], quality=95)

    def job(name, length, start, ref):
        d = os.path.join(root, name)
        os.makedirs(d)
        paths = []
        for i in range(length):
            paths.append(os.path.join(d, f"{i:05d}.jpg"))
            os.symlink(os.path.join(src, f"{(start + i) % n:05d}.jpg"),
                       paths[-1])
        return {"clip": d, "ref": ref, "frames": paths}

    lo, hi = mix["clip_frames"]
    warm = [job(f"warm{k}", mix["warm_frames"], k, refs[k % len(refs)])
            for k in range(mix["slots"] + 1)]
    backlog = [job(f"job{j:03d}", int(rng.integers(lo, hi + 1)),
                   int(rng.integers(n)), refs[j % len(refs)])
               for j in range(mix["jobs"])]
    return {"warm": warm, "backlog": backlog}
