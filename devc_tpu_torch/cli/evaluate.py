"""Score colourisation outputs: PSNR / SSIM of one frame directory against
another, and a temporal-stability score, in PyTorch (the port's
counterpart of `python -m cli.evaluate`, same flags and report).

  python -m devc_tpu_torch.cli.evaluate --dir_a out/v32_01 \\
      --dir_b ref_out/v32_01
  python -m devc_tpu_torch.cli.evaluate --dir_a out/v32_01 --temporal-only

Frames pair up by position in the frame order (`list_clip_frames`).
With --flow_dir (the <frame>_forward.flo files of the training layout)
the temporal score warps each next frame back by its flow. The metrics
run on --device (default cuda, which fails without a GPU: nothing falls
back to the CPU) in fp32, or in float64 with --device cpu. Exits 1 if a
--min_psnr / --min_ssim threshold is given and unmet.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def _load_dir(d, limit=None):
    from PIL import Image

    from devc_tpu_torch.data.transforms import list_clip_frames

    names = list_clip_frames(d)
    if limit:
        names = names[:limit]
    return names, [np.asarray(Image.open(os.path.join(d, n)).convert("RGB"))
                   for n in names]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--dir_a", required=True, help="frames to evaluate")
    ap.add_argument("--dir_b", default=None, help="reference frames")
    ap.add_argument("--flow_dir", default=None,
                    help="dir of <stem>_forward.flo files for warp error")
    ap.add_argument("--limit", type=int, default=None, help="first N frames")
    ap.add_argument("--per_frame", action="store_true")
    ap.add_argument("--temporal-only", action="store_true")
    ap.add_argument("--min_psnr", type=float, default=None)
    ap.add_argument("--min_ssim", type=float, default=None)
    ap.add_argument("--json", action="store_true", help="one JSON line")
    ap.add_argument("--device", type=str, default="cuda",
                    help="torch device of the metrics; 'cuda' fails when "
                         "no GPU is present")
    args = ap.parse_args(argv)

    from devc_tpu_torch.utils.convert import checked_device
    from devc_tpu_torch.utils.metrics import psnr, ssim, temporal_warp_error

    device = checked_device(args.device)
    names_a, frames_a = _load_dir(args.dir_a, args.limit)
    if not frames_a:
        raise SystemExit(f"no frames in {args.dir_a}")

    report = {"dir_a": args.dir_a, "frames": len(frames_a)}

    if args.dir_b and not args.temporal_only:
        _, frames_b = _load_dir(args.dir_b, args.limit)
        n = min(len(frames_a), len(frames_b))
        if n == 0:
            raise SystemExit(f"no frames in {args.dir_b}")
        ps, ss = [], []
        for i in range(n):
            if frames_a[i].shape != frames_b[i].shape:
                raise SystemExit(
                    f"shape mismatch at {names_a[i]}: "
                    f"{frames_a[i].shape} vs {frames_b[i].shape}")
            ps.append(psnr(frames_a[i], frames_b[i], device=device))
            ss.append(ssim(frames_a[i], frames_b[i], device=device))
            if args.per_frame and not args.json:
                print(f"  {names_a[i]}: psnr {ps[-1]:6.2f} dB  "
                      f"ssim {ss[-1]:.4f}")
        # identical frames give inf PSNR; keep JSON strict-parseable
        fin = lambda v: round(float(v), 3) if np.isfinite(v) else None
        finite = [p for p in ps if np.isfinite(p)]
        report.update(
            dir_b=args.dir_b,
            compared=n,
            psnr_mean=fin(np.mean(finite)) if finite else None,
            psnr_min=fin(np.min(ps)),
            ssim_mean=round(float(np.mean(ss)), 4),
            ssim_min=round(float(np.min(ss)), 4),
            identical_frames=len(ps) - len(finite),
        )

    if len(frames_a) >= 2:
        flows = None
        if args.flow_dir:
            from devc_tpu_torch.data.flow import read_flo

            flows = [read_flo(os.path.join(
                args.flow_dir, os.path.splitext(n_)[0] + "_forward.flo"))
                for n_ in names_a[:-1]]
        report["temporal_rmse"] = round(
            temporal_warp_error(frames_a, flows, device=device), 3)

    if args.json:
        print(json.dumps(report))
    else:
        for k, v in report.items():
            print(f"{k}: {v}")

    if args.min_psnr is not None:
        pm = report.get("psnr_mean")  # None = every frame identical (inf)
        if "compared" not in report or (pm is not None
                                        and pm < args.min_psnr):
            print(f"FAIL: psnr_mean < {args.min_psnr}")
            return 1
    if args.min_ssim is not None:
        if report.get("ssim_mean", -1.0) < args.min_ssim:
            print(f"FAIL: ssim_mean < {args.min_ssim}")
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
