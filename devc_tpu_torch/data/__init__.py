"""Host-side data: frame decoding and geometry, .flo files, the training
datasets and their loader, augmentations and the host C++ kernels (numpy,
scipy, PIL and ctypes; no torch)."""
