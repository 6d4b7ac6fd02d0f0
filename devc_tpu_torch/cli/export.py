"""Export a cli.train checkpoint to the reference's .pth files (mirrors
devc_tpu's cli/export.py).

  python -m devc_tpu_torch.cli.export --train_ckpt ckpt/ --out exported/ \\
      --iter 76000

The reference loads its generator as two state dicts (test.py:150-159:
nonlocal_net_iter_N.pth and colornet_iter_N.pth, saved by
train.py:174-226). The port's checkpoints already hold those state dicts
(train/checkpoint.py), so the export writes them out as they are, on the
CPU. --discriminator adds discriminator_iter_N.pth (the critic with its
spectral-norm u / v), --vgg adds vgg19_conv.pth: the seed-1 host draw a
run without --vgg_ckpt trained against (refused for a run that trained
against a torch VGG file: that file is the artifact to ship). Every check
runs before any file is written. Runs on the CPU; no GPU needed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--train_ckpt", required=True,
                    help="checkpoint directory written by cli.train")
    ap.add_argument("--step", type=int, default=None,
                    help="checkpoint step (default: latest)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--iter", type=int, default=None, dest="iteration",
                    help="iteration number in the .pth filenames "
                         "(default: the checkpoint step)")
    ap.add_argument("--discriminator", action="store_true",
                    help="also export discriminator_iter_N.pth")
    ap.add_argument("--vgg", action="store_true",
                    help="also export vgg19_conv.pth (the extractor the "
                         "run trained against: the seed-1 random VGG for "
                         "runs without torch weights)")
    args = ap.parse_args(argv)

    import torch

    from devc_tpu_torch.train.checkpoint import (
        load_run_metadata,
        load_train_state_dict,
    )
    from devc_tpu_torch.utils.convert import (
        discriminator_reference_state_dict,
        save_reference_checkpoints,
        vgg19_state_dict,
    )
    from devc_tpu_torch.utils.init import host_train_vgg_init

    directory = os.path.abspath(args.train_ckpt)

    # Validate everything BEFORE writing any file, so a refusal cannot
    # leave a partial export behind.
    if args.vgg:
        vgg_src = (load_run_metadata(directory) or {}).get("vgg_source")
        if vgg_src and vgg_src.startswith("torch:"):
            raise SystemExit(
                f"--vgg: this run trained against external torch VGG "
                f"weights ({vgg_src}); nothing to export — the original "
                "file is the artifact to ship")

    restored, step = load_train_state_dict(directory, args.step)
    if args.discriminator and (restored.get("params_d") is None
                               or restored.get("sn_state") is None):
        raise SystemExit(
            "--discriminator: checkpoint has no params_d/sn_state")

    iteration = args.iteration if args.iteration is not None else step
    paths = list(save_reference_checkpoints(restored["params_g"], args.out,
                                            iteration))
    if args.discriminator:
        p = os.path.join(args.out, f"discriminator_iter_{iteration}.pth")
        torch.save(discriminator_reference_state_dict(
            restored["params_d"], restored["sn_state"]), p)
        paths.append(p)
    if args.vgg:
        p = os.path.join(args.out, "vgg19_conv.pth")
        torch.save(vgg19_state_dict(host_train_vgg_init()), p)
        paths.append(p)

    print(json.dumps({"step": int(step), "iteration": int(iteration),
                      "written": paths}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
