"""devc_tpu_torch — exemplar-based video colorization in PyTorch and CUDA.

The PyTorch port of devc_tpu (the JAX package beside it, which stays the
reference). It runs the inference main path (one clip against one
exemplar, frame by frame) and the GAN training step on an NVIDIA H100;
the four TPU kernels on those paths are hand-written CUDA C++ for sm_90a
(`csrc/`).

Package map (each module mirrors its devc_tpu namesake):
  colorspace    RGB <-> Lab, gray -> RGB, VGG preprocessing
  ops           resize / norm / pad / unfold primitives, dense
                correspondence (plain versions + CUDA kernels K1 forward,
                K2b / K3 backward, one autograd Function), fast global
                smoother (plain PCR / Thomas + CUDA kernel K2)
  models        VGG19, WarpNet, ColorVidNet, the critic as nn.Modules
                (reference keys)
  pipeline      frame composition, the per-frame device step, clip driver
  train         losses, optimizers and TrainState, the training step,
                checkpoints
  utils         numpy random init, weight conversion, kernel build
  cli           python -m devc_tpu_torch.cli.colorize
"""

__version__ = "0.1.0"
