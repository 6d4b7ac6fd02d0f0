"""Training convergence demo in PyTorch: overfit a mini dataset and verify
that the losses decrease (the port's counterpart of
examples/convergence_demo.py, same flags and report, --device in place of
--platform).

No training dataset ships with the repository, so the demo synthesizes an
ImageNet-style pairs dataset from any folder tree of colour images
(default: the reference's colour exemplars, sample_videos/ref/ of a
checkout of the reference placed at reference/ in this repository) and
runs the port's training CLI (devc_tpu_torch.cli.train) on it:
ImageNetPairsDataset (elastic-flow synthetic second frames,
photoconsistency masks, self-reference augmentation), PrefetchLoader, the
GAN train step with every loss, checkpointing and metrics, as a real run
would.

Usage:
  python -m devc_tpu_torch.examples.convergence_demo [--steps 200]
      [--batch 8] [--image-size 216 384] [--workdir $TMPDIR/devc_convergence]
      [--holdout 2] [--device-preprocess] [--device cuda]

Prints a per-loss first-vs-last comparison (moving-average smoothed) and
exits nonzero if the total generator loss did not decrease. With
--holdout N the last N scenes stay out of training and the checkpoint is
scored on them (cli.colorize, then cli.evaluate against the ground truth
colour), beside seeded random weights.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import io
import json
import os
import shutil
import sys
import tempfile

from PIL import Image

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_SRC = os.path.join(_REPO, "reference", "sample_videos", "ref")
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "devc_convergence")


def build_pairs_dataset(src_root: str, dst_root: str, min_side: int = 256,
                        holdout: int = 0):
    """Folder tree of colour images -> ImageNetPairsDataset layout.

    Images within the same source subdirectory are consecutive-paired (they
    are exemplars of the same scene, so the pair is a plausible retrieval:
    the role pairs.txt plays in the reference, whose
    lib/videoloader_imagenet.py parses <nameA>.JPEG <nameB>.JPEG <score>
    lines). Images under min_side or not RGB are skipped, and scenes with
    fewer than two stills dropped.

    holdout: exclude the LAST `holdout` usable scene directories from the
    training pairs and return them (name, [source paths]) for evaluation:
    the trained model never sees their colours.
    """
    scene_dir = os.path.join(dst_root, "scene0")
    input_dir = os.path.join(scene_dir, "input")
    if os.path.exists(dst_root):
        shutil.rmtree(dst_root)
    os.makedirs(input_dir)

    usable = []  # (subdir, [(name, src_path), ...])
    for sub in sorted(os.listdir(src_root)):
        d = os.path.join(src_root, sub)
        if not os.path.isdir(d):
            continue
        entries = []
        for p in sorted(glob.glob(os.path.join(d, "*"))):
            try:
                with Image.open(p) as im:
                    if min(im.size) < min_side or im.mode != "RGB":
                        continue
                    name = f"{sub}_{os.path.splitext(os.path.basename(p))[0]}"
                    entries.append((name, p))
            except Exception:
                continue
        if len(entries) >= 2:
            usable.append((sub, entries))

    held = usable[len(usable) - holdout:] if holdout else []
    train_groups = usable[: len(usable) - holdout] if holdout else usable

    n_pairs = 0
    with open(os.path.join(scene_dir, "pairs.txt"), "w") as f:
        for _, entries in train_groups:
            for name, p in entries:
                with Image.open(p) as im:
                    im.convert("RGB").save(
                        os.path.join(input_dir, name + ".JPEG"), quality=95)
            names = [n for n, _ in entries]
            for a, b in zip(names, names[1:]):
                f.write(f"{a}.JPEG {b}.JPEG 1.0\n")
                n_pairs += 1
    if n_pairs == 0:
        raise SystemExit(f"no usable image pairs under {src_root}")
    return n_pairs, [(sub, [p for _, p in entries]) for sub, entries in held]


def evaluate_holdout(held, workdir, ckpt_dir, image_size, device=None):
    """Colourise held-out scenes from their L channel and score them
    against the ground truth.

    Per scene: still #0 (colour) is the exemplar, stills #1.. are the clip
    (cli.colorize reads only their luminance); the ground truth is the same
    stills CenterPadded to image_size with the host transform
    (data/transforms.py::center_pad), so PSNR / SSIM compare identically
    framed images. Scored twice: the trained checkpoint and seeded random
    weights.

    The training size (216x384) is not a valid colorize input (H % 16 == 0
    and W % 32 == 0), so the evaluation runs at the nearest valid size
    rounded up (224x384 for the default): the networks are fully
    convolutional, and ground truth and prediction stay identically framed
    because both use the rounded size.
    """
    import numpy as np

    from devc_tpu_torch.cli.colorize import main as colorize_main
    from devc_tpu_torch.cli.evaluate import main as evaluate_main
    from devc_tpu_torch.data.transforms import center_pad

    image_size = ((image_size[0] + 15) // 16 * 16,
                  (image_size[1] + 31) // 32 * 32)
    device_args = ["--device", device] if device else []

    results = {}
    for tag, extra in (
        ("trained", ["--train_ckpt", ckpt_dir]),
        ("random_init", ["--random_init"]),
    ):
        ps, ss, trmse = [], [], []
        for sub, paths in held:
            clip = os.path.join(workdir, "eval", sub, "clip")
            gt = os.path.join(workdir, "eval", sub, "gt")
            out = os.path.join(workdir, "eval", sub, f"out_{tag}")
            for d in (clip, gt):
                os.makedirs(d, exist_ok=True)
            for i, p in enumerate(paths[1:]):
                with Image.open(p) as im:
                    im = im.convert("RGB")
                    im.save(os.path.join(clip, f"{i:05d}.png"))
                    center_pad(im, image_size).save(
                        os.path.join(gt, f"{i:05d}.png"))
            colorize_main([
                "--clip_path", clip, "--ref_path", paths[0],
                "--output_path", out, "--no_video",
                "--image_size", str(image_size[0]), str(image_size[1]),
            ] + extra + device_args)
            ref_id = os.path.splitext(os.path.basename(paths[0]))[0]
            out_dir = os.path.join(out, f"clip_{ref_id}")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                evaluate_main(["--dir_a", out_dir, "--dir_b", gt, "--json"]
                              + device_args)
            m = json.loads(buf.getvalue().strip().splitlines()[-1])
            ps.append(m["psnr_mean"])
            ss.append(m["ssim_mean"])
            if m.get("temporal_rmse") is not None:
                trmse.append(m["temporal_rmse"])
        results[tag] = {
            "psnr_mean": round(float(np.mean(ps)), 3),
            "ssim_mean": round(float(np.mean(ss)), 4),
            "temporal_rmse": round(float(np.mean(trmse)), 3) if trmse else None,
            "scenes": len(held),
        }
        print(f"  holdout[{tag}]: PSNR {results[tag]['psnr_mean']} dB  "
              f"SSIM {results[tag]['ssim_mean']}  "
              f"temporal RMSE {results[tag]['temporal_rmse']}")
    return results


def smoothed(vals, k):
    # first-vs-last windows must not overlap, or short runs compare a
    # window with itself
    k = max(1, min(k, len(vals) // 2))
    return sum(vals[:k]) / k, sum(vals[-k:]) / k


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--src", default=DEFAULT_SRC)
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image-size", type=int, nargs=2, default=[216, 384])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' fails when no GPU is present")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--summary-out", default=None,
                    help="write the first-vs-last loss table as JSON here")
    ap.add_argument("--device-preprocess", action="store_true",
                    help="pass --device_preprocess to cli.train (uint8 "
                         "loader contract: Lab, jitter and placeholder on "
                         "the device)")
    ap.add_argument("--holdout", type=int, default=0,
                    help="exclude the last N scenes from training and "
                         "score the checkpoint on them (PSNR/SSIM vs GT "
                         "color via cli.evaluate)")
    args = ap.parse_args(argv)

    from devc_tpu_torch.utils.convert import checked_device

    checked_device(args.device)

    data_root = os.path.join(args.workdir, "data")
    n_pairs, held = build_pairs_dataset(args.src, data_root,
                                        holdout=args.holdout)
    print(f"mini dataset: {n_pairs} pairs at {data_root}"
          + (f", {len(held)} held-out scenes" if held else ""))

    log_dir = os.path.join(args.workdir, "runs")
    shutil.rmtree(log_dir, ignore_errors=True)

    from devc_tpu_torch.cli.train import main as train_main

    train_main([
        "--data_root_imagenet", data_root,
        "--batch_size", str(args.batch),
        "--max_steps", str(args.steps),
        "--image_size", str(args.image_size[0]), str(args.image_size[1]),
        "--workers", str(args.workers),
        "--checkpoint_dir", os.path.join(args.workdir, "ckpt"),
        "--checkpoint_step", str(args.steps),
        "--log_dir", log_dir,
        "--print_step", "1",
        "--seed", "0",
        "--device", args.device,
    ] + (["--device_preprocess"] if args.device_preprocess else []))

    # ---- summarize ----
    records = []
    with open(os.path.join(log_dir, "metrics.jsonl")) as f:
        for line in f:
            records.append(json.loads(line))
    records.sort(key=lambda r: r["step"])
    keys = [
        "total_loss", "l1_loss", "generator_loss", "discriminator_loss",
        "feat_loss", "contextual_loss_total", "smoothness_loss",
        "consistent_loss",
    ]
    window = max(5, len(records) // 10)
    print(f"\n=== convergence over {len(records)} logged steps "
          f"(moving avg, window {window}) ===")
    summary = {"steps": len(records), "window": window, "losses": {}}
    ok = True
    for k in keys:
        vals = [r[k] for r in records if k in r]
        if not vals:
            continue
        first, last = smoothed(vals, window)
        delta = last - first
        summary["losses"][k] = {"first": first, "last": last}
        marker = "v" if delta < 0 else "^"
        print(f"  {k:>22}: {first:10.4f} -> {last:10.4f}  ({marker})")
        if k == "total_loss" and not (last < first):
            ok = False
    if held:
        print(f"\n=== held-out evaluation ({len(held)} unseen scenes) ===")
        summary["holdout"] = evaluate_holdout(
            held, args.workdir, os.path.join(args.workdir, "ckpt"),
            tuple(args.image_size), device=args.device,
        )
    if args.summary_out:
        with open(args.summary_out, "w") as f:
            json.dump(summary, f, indent=1)
    if not ok:
        print("FAIL: total_loss did not decrease")
        return 1
    print("OK: total_loss decreased")
    return 0


if __name__ == "__main__":
    sys.exit(main())
