"""The GAN training step, its losses, optimizers and checkpoints."""
