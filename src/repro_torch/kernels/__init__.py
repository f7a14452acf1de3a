"""The port's Hopper kernels, their plain PyTorch versions and the per-leaf
wrappers that pick between them by device."""
