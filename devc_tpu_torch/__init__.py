"""devc_tpu_torch — exemplar-based video colorization in PyTorch and CUDA.

The PyTorch port of devc_tpu (the JAX package beside it, which stays the
reference). It runs inference (one clip against one or several
exemplars, frame by frame or as replays of a captured CUDA graph), batched
serving of many clips, and training (the GAN step, its datasets and the
trainer's CLI) on an NVIDIA H100;
the four TPU kernels on those paths are hand-written CUDA C++ for sm_90a
(`csrc/`).

Package map (each module mirrors its devc_tpu namesake):
  colorspace    RGB <-> Lab, gray -> RGB, VGG preprocessing
  ops           resize / norm / pad / unfold primitives, dense
                correspondence (plain versions + CUDA kernels K1 forward,
                K2b / K3 backward, one autograd Function), fast global
                smoother (plain PCR / Thomas + CUDA kernel K2, batched),
                device-side CenterPad (two matrix products)
  models        VGG19, WarpNet, ColorVidNet, the critic, the grayscale
                VGG19 as nn.Modules (reference keys)
  data          frame decoding and CenterPad, .flo I/O, the training
                datasets and their prefetching loader, augmentations,
                host C++ kernels (native/, built with g++)
  pipeline      frame composition, the device steps (one frame, R
                exemplars, B clips), clip drivers (stream / scan), the
                captured step (graph), the batched clip scheduler
  parallel      the B-clip batched step
  train         losses, optimizers and TrainState, the training step,
                checkpoints
  utils         numpy random init, weight conversion, kernel build,
                run logging, profiling
  cli           python -m devc_tpu_torch.cli.colorize, .cli.serve,
                .cli.train, .cli.export
"""

__version__ = "0.1.0"
