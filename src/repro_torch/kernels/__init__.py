"""Hopper kernels of the sparse engine, their plain PyTorch versions and
the dispatcher (`ops`)."""
